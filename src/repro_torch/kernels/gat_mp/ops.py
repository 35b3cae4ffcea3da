"""Masked multi-head GAT attention with a leading batch axis.

Counterpart of ``src/repro/kernels/gat_mp/ops.py`` ``gat_mp`` (the
Pallas ``_fwd_kernel`` in ``gat_mp.py``), forward only.  For each batch
element b, destination row i and head h::

    s[i, j] = leaky_relu(e_src[i, h] + e_dst[j, h], 0.2)  masked to -1e30
    m, l    = max_j s,  sum_j exp(s - m)
    out[i]  = sum_j exp(s - m) / max(l, 1e-30) * z[j, head h]

``gat_mp`` is the wrapper: on CUDA tensors it launches
``csrc/gat_mp.cu``; on CPU tensors it runs ``gat_mp_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
KERNEL_HEAD_DIM = 32    # the kernel maps one lane to one head feature
KERNEL_MAX_HEADS = 8
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
             + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def gat_mp_plain(z, e_src, e_dst, adj):
    """Plain PyTorch version, any device: dense (B, N, N, H) scores.

    z (B, N, D) f32; e_src / e_dst (B, N, H) f32; adj (1 or B, N, N)
    bool mask.  Returns (out (B, N, D), m (B, N, H), l (B, N, H))."""
    B, N, D = z.shape
    H = e_src.shape[-1]
    pre = e_src[:, :, None, :] + e_dst[:, None, :, :]          # (B, N, N, H)
    s = torch.where(pre >= 0, pre, 0.2 * pre)
    s = torch.where(adj.bool()[..., None], s, NEG_INF)
    m = s.amax(dim=2)                                           # (B, N, H)
    p = torch.exp(s - m[:, :, None, :])
    l = p.sum(dim=2)
    alpha = p / torch.clamp(l, min=1e-30)[:, :, None, :]
    zh = z.reshape(B, N, H, D // H)
    out = torch.einsum("bijh,bjhd->bihd", alpha, zh).reshape(B, N, D)
    return out, m, l


def _check(z, e_src, e_dst, adj):
    if z.dim() != 3 or e_src.dim() != 3 or adj.dim() != 3:
        raise ValueError("gat_mp takes z (B, N, D), e_src/e_dst (B, N, H) "
                         "and adj (1 or B, N, N)")
    B, N, D = z.shape
    H = e_src.shape[-1]
    if e_src.shape != (B, N, H) or e_dst.shape != (B, N, H):
        raise ValueError(f"e_src {tuple(e_src.shape)} / e_dst "
                         f"{tuple(e_dst.shape)} must be {(B, N, H)}")
    if D % H:
        raise ValueError(f"D={D} is not a multiple of H={H}")
    if adj.shape[1:] != (N, N) or adj.shape[0] not in (1, B):
        raise ValueError(f"adj {tuple(adj.shape)} must be (1 or {B}, {N}, "
                         f"{N})")
    for name, x in (("z", z), ("e_src", e_src), ("e_dst", e_dst)):
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
    if adj.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"adj must be a bool or uint8 mask, got {adj.dtype}")
    if len({x.device for x in (z, e_src, e_dst, adj)}) != 1:
        raise ValueError("gat_mp inputs lie on different devices")


def _launch(z, e_src, e_dst, adj):
    B, N, D = z.shape
    H = e_src.shape[-1]
    if D != H * KERNEL_HEAD_DIM or H > KERNEL_MAX_HEADS:
        raise ValueError(f"the CUDA kernel takes {KERNEL_HEAD_DIM} features "
                         f"per head and at most {KERNEL_MAX_HEADS} heads; got "
                         f"D={D}, H={H}")
    for name, x in (("z", z), ("e_src", e_src), ("e_dst", e_dst),
                    ("adj", adj)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if z.data_ptr() % 16:
        raise ValueError("z must be 16-byte aligned")
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the kernel grid")
    fn = build.function("gat_mp", "gat_mp_fwd", _ARGTYPES)
    out = torch.empty_like(z)
    m = torch.empty_like(e_src)
    l = torch.empty_like(e_src)
    mask = adj.view(torch.uint8) if adj.dtype == torch.bool else adj
    stride = 0 if adj.shape[0] == 1 else N * N
    with torch.cuda.device(z.device):
        err = fn(z.data_ptr(), e_src.data_ptr(), e_dst.data_ptr(),
                 mask.data_ptr(), stride, out.data_ptr(), m.data_ptr(),
                 l.data_ptr(), B, N, H,
                 torch.cuda.current_stream(z.device).cuda_stream)
    if err:
        raise RuntimeError(f"gat_mp kernel launch failed: CUDA error {err}")
    gat_mp.launches += 1
    return out, m, l


def gat_mp(z, e_src, e_dst, adj):
    """z (B, N, D) f32; e_src / e_dst (B, N, H) f32; adj (1 or B, N, N)
    bool/uint8 mask, a leading 1 meaning one mask shared by the batch
    (never expanded).  Returns (out (B, N, D), m (B, N, H), l (B, N, H))
    f32.  CUDA tensors launch the kernel (contiguous inputs, 32 features
    per head); CPU tensors run ``gat_mp_plain``."""
    _check(z, e_src, e_dst, adj)
    if z.device.type == "cpu":
        return gat_mp_plain(z, e_src, e_dst, adj)
    if z.shape[0] == 0 or z.shape[1] == 0:
        raise ValueError("empty batch or graph")
    return _launch(z, e_src, e_dst, adj)


gat_mp.launches = 0
