"""Gradient compression: int8 block quantisation with error feedback.

Copied from ``src/repro/distributed/compression.py``.  Each block of 256
values is scaled by its largest magnitude / 127 and rounded half to even
into int8, bit for bit as the JAX code does.  On one card there is no
all-reduce for it to shrink; the lossy round trip runs where the JAX
train step runs it, before the optimizer.  Error feedback keeps the
quantisation residual and re-injects it the next step.

``compress_sharded`` is the round trip of a sharded gradient tree: each
rank gets its block of ``compress_decompress`` of the whole global leaf,
bit for bit, without gathering the leaf.  The blocks of 256 run over the
leaf's row-major flattening, so a shard's elements fall into blocks that
other ranks share: each rank reduces |x| into a buffer of the leaf's
ceil(numel / 256) block maxima by its elements' global indices, the
buffer is all-reduced with MAX over the mesh axes that cut the leaf
(max is exact: the scales do not depend on the layout), and each rank
quantises its own elements with their blocks' scales.  The traffic is
one f32 a block: 1/256 of the leaf's f32 bytes.  Error feedback stays
one-device, as in the JAX package, where no sharded caller uses it.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.distributed import parallel as par
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


def _global_blocks(x, spec, mesh, full):
    """The block (of 256 in the global leaf's row-major order, shape
    ``full``) of each element of this rank's shard ``x``, flattened."""
    idx = torch.zeros((), dtype=torch.long, device=x.device)
    stride = 1
    offs = par.block_offsets(x.shape, spec, mesh)
    for d in reversed(range(x.ndim)):
        view = [1] * x.ndim
        view[d] = x.shape[d]
        pos = torch.arange(offs[d], offs[d] + x.shape[d], device=x.device)
        idx = idx + pos.view(view) * stride
        stride *= full[d]
    return torch.div(idx.reshape(-1), BLOCK, rounding_mode="floor")


def compress_shard(x, spec, mesh):
    """This rank's block of ``compress_decompress`` of the global leaf
    whose shard is ``x`` (its spec ``spec`` over ``mesh``), bit for bit:
    the leaf left alone where it is not float or has fewer than 256
    elements in all (a shard of fewer, of a larger leaf, is
    compressed)."""
    full = par.global_shape(x.shape, spec, mesh)
    if not x.is_floating_point() or math.prod(full) < BLOCK:
        return x
    axes = par.spec_axes(spec, mesh)
    if not axes:                        # the whole leaf on every rank
        return compress_decompress(x)
    blk = _global_blocks(x, spec, mesh, full)
    xf = x.float().reshape(-1)
    amax = torch.zeros(-(-math.prod(full) // BLOCK), dtype=torch.float32,
                       device=x.device)
    amax.scatter_reduce_(0, blk, xf.abs(), "amax")
    par.all_reduce_(amax, mesh, axes, op=dist.ReduceOp.MAX)
    scale = (amax / 127.0)[blk]
    q = torch.clamp(torch.round(xf / torch.clamp(scale, min=1e-12)),
                    -127, 127).to(torch.int8)      # -0.0 becomes 0, as JAX's
    return (q.float() * scale).reshape(x.shape).to(x.dtype)


def compress_sharded(grads, specs, mesh):
    """``compress_shard`` of every leaf of a tree of shards (``specs``: a
    tree of the same keys): this rank's blocks of
    ``tree_map(compress_decompress, global tree)``."""
    sp = dict(tree_leaves(specs))
    return tree_from_flat(grads, {n: compress_shard(g, sp[n], mesh)
                                  for n, g in tree_leaves(grads)})


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
