"""Causal or full attention softmax(q k^T / sqrt(h)) v with grouped KV
heads, in the layout of the port's attention (q (B, Sq, K, G, h), k and
v (B, Sk, K, h)).

Counterpart of ``src/repro/kernels/flash_attention/ops.py``
``flash_attention`` (the Pallas kernel ``_kernel`` /
``flash_attention_pallas`` in ``flash_attention.py``), which is the TPU
lowering of the contract of ``repro.models.attention.blocked_attention``.
``flash_attention`` is the public entry.  On CUDA tensors it launches
one of the two kernels of ``csrc/flash_attention.cu``, which read q, k
and v in place (query head k * G + g reads KV head k: no repeat, no
transposed copy); ``kernel_route`` says which: the tensor-core kernel
(wgmma, TMA) for bf16 at h = 64 or 128, the fp32-core kernel for f32
and for bf16 at h = 16 or 32.  There is no other choice and no
fallback: a launch that fails raises.  On CPU tensors it runs
``flash_attention_plain``, the forward of ``blocked_attention`` in torch
ops; so it does on meta tensors (the dry run, ``launch/dryrun.py``),
the forward and the backward each one op of ``distributed/cost.py``'s
count.  Query i sits at position i + q_offset; with ``causal`` it sees the
keys at positions <= its own.

The gradient is the counterpart of ``_flash_bwd`` in
``src/repro/models/attention.py`` (an XLA custom VJP, no Pallas kernel):
when an input requires grad, ``flash_attention`` goes through
``_FlashAttention``, whose forward also keeps each row's log-sum-exp and
whose backward is ``flash_attention_bwd``: on CUDA tensors one route of
``csrc/flash_attention_bwd.cu`` (one wrapper launch), chosen by
``bwd_route`` with the forward's rule: the tensor-core kernels (wgmma,
TMA) for bf16 at h = 64 or 128, the fp32-core kernels otherwise; on CPU
tensors ``flash_attention_bwd_plain``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import count_launch
from repro_torch.distributed.cost import meta_op
from repro_torch.kernels import build

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TENSOR_CORE_HEAD_DIMS = (64, 128)   # whole 64-column (128-byte) TMA boxes
TMA_ALIGN = 16                      # bytes: base address and strides
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_float]
             + [ctypes.c_void_p])
_TC_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                + [ctypes.c_float] + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
_BWD_TC_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                    + [ctypes.c_float] * 2 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def softmax_scale(h: int, dtype: torch.dtype) -> float:
    """h ** -0.5 rounded to the inputs' dtype: the JAX code multiplies q
    by the scale as an array of q's dtype.  Cached: every launch asks."""
    return float(torch.tensor(h ** -0.5, dtype=dtype))


def flash_attention_plain(q, k, v, *, chunk: int, causal: bool,
                          q_offset: int = 0, return_lse: bool = False):
    """Plain PyTorch version, any device: an online softmax over KV
    chunks of ``chunk`` keys, with the JAX code's roundings (q * scale
    and the probabilities fed to the second product in q's dtype, the
    products and sums in f32).  Returns (B, Sq, K, G, h) in q's dtype;
    with ``return_lse`` also each row's log-sum-exp (B, K, G, Sq) f32,
    as ``_flash_fwd_impl`` returns it."""
    B, Sq, K, G, h = q.shape
    Sk = k.shape[1]
    n = Sk // chunk
    qf = (q * torch.tensor(softmax_scale(h, q.dtype), dtype=q.dtype)).float()
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    m = torch.full((B, K, G, Sq), NEG_INF, device=q.device)
    l = torch.zeros((B, K, G, Sq), device=q.device)
    acc = torch.zeros((B, K, G, Sq, h), device=q.device)
    for idx in range(n):
        kc = k[:, idx * chunk:(idx + 1) * chunk].float()
        vc = v[:, idx * chunk:(idx + 1) * chunk].float()
        s = torch.einsum("bqkgh,bckh->bkgqc", qf, kc)
        if causal:
            kv_pos = idx * chunk + torch.arange(chunk, device=q.device)
            mask = q_pos[:, None] >= kv_pos[None, :]
            s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        pe = torch.exp(s - m_new[..., None])
        l = l * alpha + pe.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqc,bckh->bkgqh", pe.to(q.dtype).float(), vc)
        m = m_new
    l = torch.clamp(l, min=1e-30)
    out = (acc / l[..., None]).permute(0, 3, 1, 2, 4).to(q.dtype)
    if return_lse:
        return out, m + torch.log(l)
    return out


def _check(q, k, v):
    if q.dim() != 5 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention takes q (B, Sq, K, G, h) and k, v "
                         "(B, Sk, K, h)")
    B, Sq, K, G, h = q.shape
    if k.shape[0] != B or k.shape[2] != K or k.shape[3] != h:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k and v must share one dtype")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention inputs lie on different devices")


def kernel_route(q, k, v) -> str:
    """The CUDA kernel ``flash_attention`` launches for these inputs:
    "tensor_cores" for bf16 at h = 64 or 128, "fp32_cores" for f32 and
    for bf16 at h = 16 or 32.  Depends on dtype, shape and layout only,
    not on the device.  Raises ``ValueError`` for inputs neither kernel
    takes, among them a tensor-core input whose base address or row
    stride is not a multiple of 16 bytes (TMA reads neither)."""
    _kernel_inputs(q, k, v)
    h = q.shape[-1]
    if q.dtype != torch.bfloat16 or h not in TENSOR_CORE_HEAD_DIMS:
        return "fp32_cores"
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_tma(name, x)
    return "tensor_cores"


def _check_tma(name, x):
    row = x.stride(1) * x.element_size()
    if x.data_ptr() % TMA_ALIGN or row % TMA_ALIGN:
        raise ValueError(
            f"{name}: TMA needs a base address and row stride that are "
            f"multiples of {TMA_ALIGN} bytes, got address "
            f"{x.data_ptr():#x} (storage offset {x.storage_offset()}) "
            f"and stride {row} bytes")


def _kernel_inputs(q, k, v):
    """Raises ``ValueError`` for inputs no CUDA kernel of this module
    takes: head dims other than 16, 32, 64, 128, dtypes other than f32
    and bf16, non-contiguous or empty tensors, grids too large."""
    B, Sq, K, G, h = q.shape
    Sk = k.shape[1]
    if h not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head dims "
                         f"{KERNEL_HEAD_DIMS}, got {h}")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"the CUDA kernel takes float32 or bfloat16, got "
                         f"{q.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if min(B, Sq, Sk, K, G) == 0:
        raise ValueError("empty input")
    if B > 65535 or K * G > 65535:
        raise ValueError("batch or head count exceeds the kernel grid")


def _lse_buffer(q, with_lse):
    """The (B, K, G, Sq) f32 log-sum-exp output, or None."""
    if not with_lse:
        return None
    B, Sq, K, G, _ = q.shape
    return torch.empty((B, K, G, Sq), dtype=torch.float32, device=q.device)


def _result(out, lse):
    return out if lse is None else (out, lse)


def _launch_fp32cores(q, k, v, causal, q_offset, with_lse=False):
    """The fp32-core kernel on checked inputs (any dtype and h it takes).
    Returns out, or (out, lse) with ``with_lse``."""
    B, Sq, K, G, h = q.shape
    fn = build.function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    out = torch.empty_like(q)
    lse = _lse_buffer(q, with_lse)
    err = build.cuda_call(
        fn, q, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        B, Sq, k.shape[1], K, G, h, KERNEL_DTYPES[q.dtype], int(causal),
        q_offset, softmax_scale(h, q.dtype))
    if err:
        raise RuntimeError(f"flash_attention fp32-core kernel launch "
                           f"failed: CUDA error {err}")
    count_launch(flash_attention)
    return _result(out, lse)


def _launch_tensor_cores(q, k, v, causal, q_offset, with_lse=False):
    """The tensor-core kernel on inputs ``kernel_route`` sent there."""
    B, Sq, K, G, h = q.shape
    fn = build.function("flash_attention", "flash_attention_fwd_tc",
                        _TC_ARGTYPES)
    out = torch.empty_like(q)
    lse = _lse_buffer(q, with_lse)
    err = build.cuda_call(
        fn, q, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        B, Sq, k.shape[1], K, G, h, int(causal), q_offset,
        softmax_scale(h, q.dtype))
    if err:
        raise RuntimeError(f"flash_attention tensor-core kernel launch "
                           f"failed: error {err} (a CUDA error, or 1000 + "
                           f"the CUresult of the TMA map encoding)")
    count_launch(flash_attention)
    count_launch(flash_attention, "tensor_core_launches")
    return _result(out, lse)


def _launch(q, k, v, causal, q_offset, with_lse=False):
    if q_offset < 0:
        raise ValueError("negative q_offset")
    if kernel_route(q, k, v) == "tensor_cores":
        return _launch_tensor_cores(q, k, v, causal, q_offset, with_lse)
    return _launch_fp32cores(q, k, v, causal, q_offset, with_lse)


def _plain_chunk(k, chunk):
    Sk = k.shape[1]
    chunk = chunk or Sk
    if Sk % chunk:
        raise ValueError(f"chunk {chunk} does not divide Sk={Sk}")
    return chunk


def _forward(q, k, v, causal, q_offset, chunk, with_lse=False):
    """The kernel on CUDA tensors, the plain version on CPU tensors and,
    as one op of the dry run's count, on meta tensors."""
    if q.device.type in ("cpu", "meta"):
        chunk = _plain_chunk(k, chunk)
        return meta_op("flash_attention", lambda: flash_attention_plain(
            q, k, v, chunk=chunk, causal=causal, q_offset=q_offset,
            return_lse=with_lse), q, k, v)
    return _launch(q, k, v, causal, q_offset, with_lse)


class _FlashAttention(torch.autograd.Function):
    """``flash_attention`` with a gradient for q, k and v: the
    counterpart of the JAX ``custom_vjp`` pair ``_flash_fwd`` /
    ``_flash_bwd``.  The forward keeps out and the rows' log-sum-exp;
    the backward recomputes the probabilities from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, chunk):
        out, lse = _forward(q, k, v, causal, q_offset, chunk, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mark_non_differentiable(lse)
        ctx.args = (causal, q_offset, chunk)
        return out, lse

    @staticmethod
    def backward(ctx, g, _):
        q, k, v, out, lse = ctx.saved_tensors
        causal, q_offset, chunk = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g.contiguous(),
                                         causal=causal, q_offset=q_offset,
                                         chunk=chunk)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    chunk: int = 0, return_lse: bool = False):
    """q (B, Sq, K, G, h); k, v (B, Sk, K, h), f32 or bf16 -> (B, Sq, K,
    G, h) in the inputs' dtype; with ``return_lse`` also the rows'
    log-sum-exp (B, K, G, Sq) f32, which carries no gradient.  CUDA
    tensors launch the kernel that ``kernel_route`` names (contiguous
    inputs, h in 16, 32, 64, 128); CPU tensors run
    ``flash_attention_plain`` over KV chunks of ``chunk`` keys (0: one
    chunk of all Sk keys), which must divide Sk.  The output carries a
    gradient when q, k or v requires one and grad mode is on
    (``_FlashAttention``); otherwise no autograd node is made."""
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out, lse = _FlashAttention.apply(q, k, v, causal, q_offset, chunk)
        return (out, lse) if return_lse else out
    return _forward(q, k, v, causal, q_offset, chunk, with_lse=return_lse)


flash_attention.launches = 0               # every kernel launch
flash_attention.tensor_core_launches = 0   # those of the tensor-core kernel


# ---------------------------------------------------------------- backward
def flash_attention_bwd_plain(q, k, v, out, lse, g, *, chunk: int,
                              causal: bool, q_offset: int = 0):
    """Plain PyTorch backward, any device: ``_flash_bwd`` over KV chunks
    of ``chunk`` keys, with its roundings (q * scale, p fed to dv and ds
    in q's dtype; the products and sums in f32; dq scaled by h^-0.5 in
    f32).  out (B, Sq, K, G, h) is the forward's output, lse (B, K, G,
    Sq) f32 its log-sum-exp, g the cotangent of out.  Returns (dq, dk,
    dv) in the inputs' dtype."""
    B, Sq, K, G, h = q.shape
    Sk = k.shape[1]
    dt = q.dtype
    qf = (q * torch.tensor(softmax_scale(h, dt), dtype=dt)).float()
    do = g.permute(0, 2, 3, 1, 4).float()                   # (B,K,G,Sq,h)
    D = (do * out.permute(0, 2, 3, 1, 4).float()).sum(-1)   # (B,K,G,Sq)
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    dq = torch.zeros((B, Sq, K, G, h), device=q.device)
    dks, dvs = [], []
    for idx in range(Sk // chunk):
        kc = k[:, idx * chunk:(idx + 1) * chunk].float()
        vc = v[:, idx * chunk:(idx + 1) * chunk].float()
        s = torch.einsum("bqkgh,bckh->bkgqc", qf, kc)
        p = torch.exp(s - lse[..., None])
        if causal:
            kv_pos = idx * chunk + torch.arange(chunk, device=q.device)
            p = torch.where(q_pos[:, None] >= kv_pos[None, :], p, 0.0)
        dvs.append(torch.einsum("bkgqc,bkgqh->bckh", p.to(dt).float(), do))
        dp = torch.einsum("bkgqh,bckh->bkgqc", do, vc)
        ds = (p * (dp - D[..., None])).to(dt).float()
        dq = dq + torch.einsum("bkgqc,bckh->bqkgh", ds, kc)
        dks.append(torch.einsum("bkgqc,bqkgh->bckh", ds, qf))
    return ((dq * h ** -0.5).to(dt), torch.cat(dks, 1).to(k.dtype),
            torch.cat(dvs, 1).to(v.dtype))


def _check_bwd(q, k, v, out, lse, g):
    _check(q, k, v)
    B, Sq, K, G, _ = q.shape
    for name, x in (("out", out), ("g", g)):
        if x.shape != q.shape or x.dtype != q.dtype:
            raise ValueError(f"{name} must match q: {tuple(x.shape)} "
                             f"{x.dtype}")
    if lse.shape != (B, K, G, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({B}, {K}, {G}, {Sq}) float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if len({x.device for x in (q, out, lse, g)}) != 1:
        raise ValueError("flash_attention_bwd inputs lie on different "
                         "devices")


def bwd_route(q, k, v, out, g) -> str:
    """The CUDA route ``flash_attention_bwd`` launches for these inputs,
    by ``kernel_route``'s rule: "tensor_cores" for bf16 at h = 64 or 128,
    where out and g, read by the same kernels, must also be aligned to
    16 bytes; "fp32_cores" for f32 and for bf16 at h = 16 or 32.  Raises
    ``ValueError`` for inputs neither route takes."""
    route = kernel_route(q, k, v)
    if route == "tensor_cores":
        for name, x in (("out", out), ("g", g)):
            _check_tma(name, x)
    return route


def _bwd_buffers(q, k, v, lse):
    """D (the rows' sums of do * out, f32 like lse) and dq, dk, dv."""
    return (torch.empty_like(lse), torch.empty_like(q), torch.empty_like(k),
            torch.empty_like(v))


def _launch_bwd_fp32cores(q, k, v, out, lse, g, causal, q_offset):
    """The fp32-core kernels on checked inputs (any dtype and h they
    take)."""
    B, Sq, K, G, h = q.shape
    fn = build.function("flash_attention_bwd", "flash_attention_bwd",
                        _BWD_ARGTYPES)
    dsum, dq, dk, dv = _bwd_buffers(q, k, v, lse)
    err = build.cuda_call(
        fn, q, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        g.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, Sq, k.shape[1], K, G, h,
        KERNEL_DTYPES[q.dtype], int(causal), q_offset,
        softmax_scale(h, q.dtype), h ** -0.5)
    if err:
        raise RuntimeError(f"flash_attention_bwd fp32-core kernel launch "
                           f"failed: CUDA error {err}")
    count_launch(flash_attention_bwd)
    return dq, dk, dv


def _launch_bwd_tensor_cores(q, k, v, out, lse, g, causal, q_offset):
    """The tensor-core kernels on inputs ``bwd_route`` sent there; qs, a
    scratch of q's shape, takes bf(q * scale) from the first kernel."""
    B, Sq, K, G, h = q.shape
    fn = build.function("flash_attention_bwd", "flash_attention_bwd_tc",
                        _BWD_TC_ARGTYPES)
    dsum, dq, dk, dv = _bwd_buffers(q, k, v, lse)
    qs = torch.empty_like(q)
    err = build.cuda_call(
        fn, q, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        g.data_ptr(), lse.data_ptr(), dsum.data_ptr(), qs.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Sq, k.shape[1], K, G,
        h, int(causal), q_offset, softmax_scale(h, q.dtype), h ** -0.5)
    if err:
        raise RuntimeError(f"flash_attention_bwd tensor-core kernel launch "
                           f"failed: error {err} (a CUDA error, or 1000 + "
                           f"the CUresult of the TMA map encoding)")
    count_launch(flash_attention_bwd)
    count_launch(flash_attention_bwd, "tensor_core_launches")
    return dq, dk, dv


def _launch_bwd(q, k, v, out, lse, g, causal, q_offset):
    if q_offset < 0:
        raise ValueError("negative q_offset")
    for name, x in (("out", out), ("lse", lse), ("g", g)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if bwd_route(q, k, v, out, g) == "tensor_cores":
        return _launch_bwd_tensor_cores(q, k, v, out, lse, g, causal,
                                        q_offset)
    return _launch_bwd_fp32cores(q, k, v, out, lse, g, causal, q_offset)


def flash_attention_bwd(q, k, v, out, lse, g, *, causal: bool = True,
                        q_offset: int = 0, chunk: int = 0):
    """Gradient of ``flash_attention``'s output for the cotangent g
    (B, Sq, K, G, h): returns (dq, dk, dv).  out and lse are the
    forward's (``flash_attention_plain(..., return_lse=True)`` or the
    kernels with an lse buffer).  CUDA tensors launch the route of
    ``csrc/flash_attention_bwd.cu`` that ``bwd_route`` names (contiguous
    inputs, f32 or bf16, h in 16, 32, 64, 128; the route's CUDA kernels
    count as one launch); CPU tensors run ``flash_attention_bwd_plain``
    over KV chunks of ``chunk`` keys (0: all Sk)."""
    _check_bwd(q, k, v, out, lse, g)
    if q.device.type in ("cpu", "meta"):
        chunk = _plain_chunk(k, chunk)
        return meta_op(
            "flash_attention_bwd", lambda: flash_attention_bwd_plain(
                q, k, v, out, lse, g, chunk=chunk, causal=causal,
                q_offset=q_offset), q, k, v, out, lse, g)
    return _launch_bwd(q, k, v, out, lse, g, causal, q_offset)


flash_attention_bwd.launches = 0               # every call's launch
flash_attention_bwd.tensor_core_launches = 0   # those of the tensor cores
