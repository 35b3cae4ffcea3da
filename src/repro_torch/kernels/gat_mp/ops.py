"""Masked multi-head GAT attention with a leading batch axis, and its
gradient.

Counterpart of ``src/repro/kernels/gat_mp/ops.py`` ``gat_mp`` (the
Pallas pair ``_fwd_kernel`` / ``_bwd_kernel`` in ``gat_mp.py``).  For
each batch element b, row i (the node that aggregates), column j and
head h::

    s[i, j] = leaky_relu(e_src[i, h] + e_dst[j, h], 0.2)  masked to -1e30
    m, l    = max_j s,  sum_j exp(s - m)
    out[i]  = sum_j exp(s - m) / max(l, 1e-30) * z[j, head h]

``gat_mp`` is the public entry.  On CUDA tensors it launches
``csrc/gat_mp.cu``; on CPU tensors it runs ``gat_mp_plain``.  When z,
e_src or e_dst requires grad, ``out`` is differentiable with respect to
them through ``_GatMP``, whose backward is ``gat_mp_bwd``: the kernel
``csrc/gat_mp_bwd.cu`` (one launch per call) on CUDA tensors,
``gat_mp_bwd_plain`` on CPU tensors.  Both kernels follow the mask's
set entries (one warp per row or column, z, g and out gathered per
edge).  The mask gets no gradient.  A launch that fails raises; there is
no fallback to the plain version for CUDA tensors.

Both kernels take their block shape as arguments: the forward one of
``FWD_WARPS`` (rows a block), the backward one of ``BWD_SHAPES``
(warps, rows a column block lists at a time, edges gathered at once).
A launch takes the shape ``core/gat_tune.py`` ``blocks_for`` gives its
key (the tuned winner, else ``gat_tune.DEFAULT_BLOCKS``); a shape
outside the sets raises ``RuntimeError``.  Every shape gives the same
bits.  On meta tensors (the dry run, ``launch/dryrun.py``) both
wrappers give their outputs' shapes through the plain versions and count
as one op each (``distributed/cost.py`` ``meta_op``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import count_launch
from repro_torch.distributed.cost import meta_op
from repro_torch.kernels import build

NEG_INF = -1e30
KERNEL_HEAD_DIM = 32    # features per head the kernels take
KERNEL_MAX_HEADS = 8
# the block shapes compiled into csrc/gat_mp.cu (rows a block) and
# csrc/gat_mp_bwd.cu ((warps, rows listed at a time, edges gathered at
# once)); the C entry points return an error for any other
FWD_WARPS = (2, 4, 8)
BWD_SHAPES = ((8, 512, 2), (8, 256, 2), (4, 512, 2), (4, 256, 2),
              (8, 512, 1), (4, 512, 1))
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_int]
             + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                          ctypes.c_int]
                 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                 + [ctypes.c_void_p])


def batch_masks(adj, B, rep=1):
    """The bool mask of every batch element, (1 or B, N, N): element b
    reads mask (b // rep) % G of adj (G, N, N).  Materialises B masks only
    where G is neither 1 nor B (the plain versions' form)."""
    mask = adj.bool()
    G = adj.shape[0]
    if G == 1 or (G == B and rep == 1):
        return mask
    idx = (torch.arange(B, device=adj.device) // rep) % G
    return mask[idx]


def gat_mp_plain(z, e_src, e_dst, adj, rep=1):
    """Plain PyTorch version, any device: dense (B, N, N, H) scores.

    z (B, N, D) f32; e_src / e_dst (B, N, H) f32; adj (G, N, N) bool
    mask, element b reading mask (b // rep) % G.  Returns (out (B, N, D),
    m (B, N, H), l (B, N, H))."""
    B, N, D = z.shape
    H = e_src.shape[-1]
    pre = e_src[:, :, None, :] + e_dst[:, None, :, :]          # (B, N, N, H)
    s = torch.where(pre >= 0, pre, 0.2 * pre)
    s = torch.where(batch_masks(adj, B, rep)[..., None], s, NEG_INF)
    m = s.amax(dim=2)                                           # (B, N, H)
    p = torch.exp(s - m[:, :, None, :])
    l = p.sum(dim=2)
    alpha = p / torch.clamp(l, min=1e-30)[:, :, None, :]
    zh = z.reshape(B, N, H, D // H)
    out = torch.einsum("bijh,bjhd->bihd", alpha, zh).reshape(B, N, D)
    return out, m, l


def _check(z, e_src, e_dst, adj, rep=1):
    if z.dim() != 3 or e_src.dim() != 3 or adj.dim() != 3:
        raise ValueError("gat_mp takes z (B, N, D), e_src/e_dst (B, N, H) "
                         "and adj (G, N, N)")
    B, N, D = z.shape
    H = e_src.shape[-1]
    if e_src.shape != (B, N, H) or e_dst.shape != (B, N, H):
        raise ValueError(f"e_src {tuple(e_src.shape)} / e_dst "
                         f"{tuple(e_dst.shape)} must be {(B, N, H)}")
    if D % H:
        raise ValueError(f"D={D} is not a multiple of H={H}")
    G = adj.shape[0]
    if (adj.shape[1:] != (N, N) or G < 1 or not isinstance(rep, int)
            or rep < 1 or (G > 1 and B % (G * rep))):
        raise ValueError(f"adj {tuple(adj.shape)} with rep={rep!r} must be "
                         f"(G, {N}, {N}) with G = 1 or G * rep dividing "
                         f"B = {B}")
    for name, x in (("z", z), ("e_src", e_src), ("e_dst", e_dst)):
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
    if adj.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"adj must be a bool or uint8 mask, got {adj.dtype}")
    if len({x.device for x in (z, e_src, e_dst, adj)}) != 1:
        raise ValueError("gat_mp inputs lie on different devices")


def _kernel_inputs(z, e_src, named, aligned):
    """What both CUDA kernels require beyond ``_check``: ``named``
    tensors contiguous, ``aligned`` ones 16-byte aligned (the kernels
    gather their rows with 16-byte loads)."""
    B, N, D = z.shape
    H = e_src.shape[-1]
    if B == 0 or N == 0:
        raise ValueError("empty batch or graph")
    if D != H * KERNEL_HEAD_DIM or H > KERNEL_MAX_HEADS:
        raise ValueError(f"the CUDA kernel takes {KERNEL_HEAD_DIM} features "
                         f"per head and at most {KERNEL_MAX_HEADS} heads; got "
                         f"D={D}, H={H}")
    for name, x in named:
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, x in aligned:
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the kernel grid")


def _mask_args(adj, rep):
    """(mask bytes, stride between masks, rep, count) for the kernels:
    element b reads mask (b // rep) % count."""
    mask = adj.view(torch.uint8) if adj.dtype == torch.bool else adj
    N, G = adj.shape[-1], adj.shape[0]
    return mask, (0 if G == 1 else N * N), rep, G


def _blocks(z, e_src, adj, kind):
    """The block shape of this launch's key (``gat_tune.blocks_for``)."""
    from repro_torch.core import gat_tune
    B, N, D = z.shape
    return gat_tune.blocks_for(N, D, e_src.shape[-1], z.dtype, batch=B,
                               masks=adj.shape[0], device=z.device)[kind]


def _launch(z, e_src, e_dst, adj, rep=1, warps=None, counter=None):
    """The forward kernel with ``warps`` rows a block (None: the shape
    ``blocks_for`` gives), counted as a launch of ``counter`` (None:
    ``gat_mp``; the tuner counts its timing launches apart)."""
    B, N, D = z.shape
    H = e_src.shape[-1]
    _kernel_inputs(z, e_src, (("z", z), ("e_src", e_src), ("e_dst", e_dst),
                              ("adj", adj)), aligned=(("z", z),))
    if warps is None:
        (warps,) = _blocks(z, e_src, adj, "fwd")
    if warps not in FWD_WARPS:
        raise RuntimeError(f"gat_mp: no kernel of {warps} warps a block; "
                           f"compiled: {FWD_WARPS}")
    fn = build.function("gat_mp", "gat_mp_fwd", _ARGTYPES)
    out = torch.empty_like(z)
    m = torch.empty_like(e_src)
    l = torch.empty_like(e_src)
    mask, stride, rep, count = _mask_args(adj, rep)
    err = build.cuda_call(
        fn, z, z.data_ptr(), e_src.data_ptr(), e_dst.data_ptr(),
        mask.data_ptr(), stride, rep, count, out.data_ptr(), m.data_ptr(),
        l.data_ptr(), B, N, H, warps)
    if err:
        raise RuntimeError(f"gat_mp kernel launch failed: CUDA error {err}")
    count_launch(counter or gat_mp)
    return out, m, l


def _forward(z, e_src, e_dst, adj, rep):
    if z.device.type == "cpu":
        return gat_mp_plain(z, e_src, e_dst, adj, rep)
    if z.device.type == "meta":
        return meta_op("gat_mp", lambda: gat_mp_plain(z, e_src, e_dst, adj,
                                                      rep),
                       z, e_src, e_dst, adj)
    return _launch(z, e_src, e_dst, adj, rep)


class _GatMP(torch.autograd.Function):
    """``gat_mp`` with a gradient for z, e_src and e_dst (the counterpart
    of the JAX ``custom_vjp`` pair ``_fused``).  m and l are residuals,
    not differentiable outputs."""

    @staticmethod
    def forward(ctx, z, e_src, e_dst, adj, rep):
        out, m, l = _forward(z, e_src, e_dst, adj, rep)
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(m, l)
        ctx.save_for_backward(z, e_src, e_dst, adj, out, m, l)
        ctx.rep = rep
        return out, m, l

    @staticmethod
    def backward(ctx, g, _gm, _gl):
        if g is None:
            return None, None, None, None, None
        z, e_src, e_dst, adj, out, m, l = ctx.saved_tensors
        dz, de_src, de_dst = gat_mp_bwd(z, e_src, e_dst, adj, m, l, out,
                                        g.contiguous(), rep=ctx.rep)
        return dz, de_src, de_dst, None, None


def gat_mp(z, e_src, e_dst, adj, rep=1):
    """z (B, N, D) f32; e_src / e_dst (B, N, H) f32; adj (G, N, N)
    bool/uint8 masks, batch element b reading mask (b // rep) % G, never
    expanded: G = 1 is one mask shared by the batch, G = B one mask per
    element, and a bucket's G graph masks serve P genomes (b = p G + g,
    rep 1) or T transitions each (b = g T + t, rep T).  Returns (out
    (B, N, D), m (B, N, H), l (B, N, H)) f32.  CUDA tensors launch the
    kernel (contiguous inputs, 32 features per head); CPU tensors run
    ``gat_mp_plain``.  ``out`` carries a gradient when z, e_src or e_dst
    requires one; otherwise no autograd node is made."""
    _check(z, e_src, e_dst, adj, rep)
    if torch.is_grad_enabled() and (z.requires_grad or e_src.requires_grad
                                    or e_dst.requires_grad):
        return _GatMP.apply(z, e_src, e_dst, adj, rep)
    return _forward(z, e_src, e_dst, adj, rep)


gat_mp.launches = 0


# ---------------------------------------------------------------- backward
def gat_mp_bwd_plain(z, e_src, e_dst, adj, m, l, out, g, rep=1):
    """Plain PyTorch backward, any device: dense (B, N, N, H) tensors.

    Recomputes alpha = exp(s - m) / max(l, 1e-30) from the forward's
    residuals, as the Pallas ``_bwd_kernel`` does; g is the cotangent of
    ``out``.  Returns (dz (B, N, D), de_src (B, N, H), de_dst (B, N, H)).
    ``de_src`` sums over columns per row; ``dz`` and ``de_dst`` sum over
    rows per column.  A row with every column masked weighs every column
    1/N in ``dz`` and adds nothing to ``de_src`` / ``de_dst``."""
    B, N, D = z.shape
    H = e_src.shape[-1]
    edge = batch_masks(adj, B, rep)[..., None]                  # (., N, N, 1)
    pre = e_src[:, :, None, :] + e_dst[:, None, :, :]           # (B, N, N, H)
    s = torch.where(edge, torch.where(pre >= 0, pre, 0.2 * pre), NEG_INF)
    alpha = (torch.exp(s - m[:, :, None, :])
             / torch.clamp(l, min=1e-30)[:, :, None, :])
    gh = g.reshape(B, N, H, D // H)
    zh = z.reshape(B, N, H, D // H)
    dz = torch.einsum("bijh,bihd->bjhd", alpha, gh).reshape(B, N, D)
    dalpha = torch.einsum("bihd,bjhd->bijh", gh, zh)
    drow = (gh * out.reshape(B, N, H, D // H)).sum(-1)          # (B, N, H)
    ds = alpha * (dalpha - drow[:, :, None, :])
    dpre = torch.where(edge, torch.where(pre >= 0, ds, 0.2 * ds), 0.0)
    return dz, dpre.sum(dim=2), dpre.sum(dim=1)


def _check_bwd(z, e_src, e_dst, adj, m, l, out, g, rep):
    _check(z, e_src, e_dst, adj, rep)
    for name, x, like in (("m", m, e_src), ("l", l, e_src),
                          ("out", out, z), ("g", g, z)):
        if x.shape != like.shape:
            raise ValueError(f"{name} {tuple(x.shape)} must be "
                             f"{tuple(like.shape)}")
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
        if x.device != z.device:
            raise ValueError("gat_mp_bwd inputs lie on different devices")


def _launch_bwd(z, e_src, e_dst, adj, m, l, out, g, rep=1, shape=None,
                counter=None):
    """The backward kernel with block ``shape`` (warps, rows listed at a
    time, edges gathered at once; None: the shape ``blocks_for``
    gives), counted as a launch of ``counter`` (None: ``gat_mp_bwd``)."""
    B, N, D = z.shape
    H = e_src.shape[-1]
    _kernel_inputs(z, e_src, (("z", z), ("e_src", e_src), ("e_dst", e_dst),
                              ("adj", adj), ("m", m), ("l", l),
                              ("out", out), ("g", g)),
                   aligned=(("z", z), ("out", out), ("g", g)))
    shape = tuple(shape or _blocks(z, e_src, adj, "bwd"))
    if shape not in BWD_SHAPES:
        raise RuntimeError(f"gat_mp_bwd: no kernel of block shape {shape}; "
                           f"compiled: {BWD_SHAPES}")
    fn = build.function("gat_mp_bwd", "gat_mp_bwd", _BWD_ARGTYPES)
    dz = torch.empty_like(z)
    de_src = torch.empty_like(e_src)
    de_dst = torch.empty_like(e_dst)
    mask, stride, rep, count = _mask_args(adj, rep)
    err = build.cuda_call(
        fn, z, z.data_ptr(), e_src.data_ptr(), e_dst.data_ptr(),
        mask.data_ptr(), stride, rep, count, m.data_ptr(), l.data_ptr(),
        out.data_ptr(), g.data_ptr(), dz.data_ptr(), de_src.data_ptr(),
        de_dst.data_ptr(), B, N, H, *shape)
    if err:
        raise RuntimeError(f"gat_mp_bwd kernel launch failed: CUDA error "
                           f"{err}")
    count_launch(counter or gat_mp_bwd)
    return dz, de_src, de_dst


def gat_mp_bwd(z, e_src, e_dst, adj, m, l, out, g, rep=1):
    """Gradient of ``gat_mp``'s ``out`` for the cotangent g (B, N, D):
    returns (dz, de_src, de_dst).  m, l, out are the forward's outputs;
    adj and rep as ``gat_mp`` takes them.  CUDA tensors launch
    ``csrc/gat_mp_bwd.cu`` once (contiguous inputs, 32 features per
    head); CPU tensors run ``gat_mp_bwd_plain``."""
    _check_bwd(z, e_src, e_dst, adj, m, l, out, g, rep)
    if z.device.type == "cpu":
        return gat_mp_bwd_plain(z, e_src, e_dst, adj, m, l, out, g, rep)
    if z.device.type == "meta":
        return meta_op("gat_mp_bwd", lambda: gat_mp_bwd_plain(
            z, e_src, e_dst, adj, m, l, out, g, rep),
            z, e_src, e_dst, adj, m, l, out, g)
    return _launch_bwd(z, e_src, e_dst, adj, m, l, out, g, rep)


gat_mp_bwd.launches = 0
