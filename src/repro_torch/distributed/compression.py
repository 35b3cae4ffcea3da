"""Gradient compression: int8 block quantisation with error feedback.

Copied from ``src/repro/distributed/compression.py``.  Each block of 256
values is scaled by its largest magnitude / 127 and rounded half to even
into int8, bit for bit as the JAX code does.  On one card there is no
all-reduce for it to shrink; the lossy round trip runs where the JAX
train step runs it, before the optimizer.  Error feedback keeps the
quantisation residual and re-injects it the next step.
"""
from __future__ import annotations

import torch

from repro_torch.utils.params import tree_from_flat, tree_leaves, tree_map

BLOCK = 256


def _pad_to_block(x):
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = torch.cat([flat, torch.zeros((pad,), dtype=flat.dtype,
                                            device=flat.device)])
    return flat, pad


def quantize_int8(x):
    """x (any shape, float) -> (int8 payload, per-block f32 scales, pad)."""
    flat, pad = _pad_to_block(x.float())
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-12)),
                    -127, 127)
    return q.to(torch.int8), scale, pad


def dequantize_int8(q, scale, pad, shape):
    flat = (q.float() * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def _compressible(x) -> bool:
    return x.is_floating_point() and x.numel() >= BLOCK


def compress_decompress(x):
    """Stateless quantize -> dequantize round trip (lossy identity)."""
    if not _compressible(x):
        return x
    q, s, pad = quantize_int8(x)
    return dequantize_int8(q, s, pad, x.shape).to(x.dtype)


def compress_with_error_feedback(grads, ef_state):
    """Returns (compressed grads, new ef_state); ef_state matches grads."""
    flat_e = dict(tree_leaves(ef_state))
    out, new_e = {}, {}
    for name, g in tree_leaves(grads):
        e = flat_e[name]
        if not _compressible(g):
            out[name], new_e[name] = g, e
            continue
        corrected = g.float() + e
        q, s, pad = quantize_int8(corrected)
        deq = dequantize_int8(q, s, pad, g.shape)
        out[name], new_e[name] = deq.to(g.dtype), corrected - deq
    return tree_from_flat(grads, out), tree_from_flat(grads, new_e)


def init_error_feedback(params):
    return tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if _compressible(p)
        else torch.zeros((), dtype=torch.float32, device=p.device), params)
