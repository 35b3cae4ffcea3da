"""Measurement-driven block shapes for the GAT kernels.

Counterpart of ``src/repro/core/gat_tune.py``.  JAX's tuner picks among
lowerings of the fused GAT op (``chunked`` at several chunk sizes, and
``pallas`` on a TPU).  The port has one lowering per device: the CUDA
kernels on a card, the plain version on the CPU.  So what is left to
tune is the CUDA kernels' block shapes, which were chosen by hand:
- the forward's rows a block (``kernels/gat_mp/ops.py`` ``FWD_WARPS``);
- the backward's (warps, rows a column block lists at a time, edges
  gathered at once) (``BWD_SHAPES``).

``autotune(n, d, heads, dtype, batch=, masks=, device=)`` on a CUDA
device times every candidate of each kernel on random inputs of exactly
that launch's shape, drawn from a seeded numpy generator as JAX's
``_bench_inputs`` draws them, and caches the winner per process.  The
forward's shape is picked by the forward's time and the backward's by
the backward's: the two kernels are separate launches, so no cross
product is timed.  Candidates whose effective shape is the same at this
N are deduped (``candidates``), and a lone candidate is not timed unless
``force_time``.  ``include_dense`` also times the plain version (the
dense (B, N, N, H) one) for the record; it is never eligible to win, as
JAX's ``jnp`` never is.  On the CPU the plain version is the only route
(backend "plain", no blocks).  ``blocks_for`` (JAX: ``chunk_for``) gives
a launch the cached winner, or ``DEFAULT_BLOCKS``, and never times.

**The key.** JAX keys on (n, d, heads, dtype, backend).  The port keys
on n, d, heads and dtype, plus the launch's batch B and mask count G,
plus the device's name: the port's kernel runs P x G graphs in one
launch, and the shape that wins for one graph need not win for 80.

**Two rules.** Every shape gives the same bits: each output has one warp
as its owner, which sums its edges in a fixed order.  ``autotune``
checks each candidate's outputs (out, m, l; dz, de_src, de_dst) against
``DEFAULT_BLOCKS``' and raises if one differs, so the choice, which
depends on timing and so on the machine, never changes a search's
trajectory.  Timing launches count as launches of ``autotune``
(``autotune.launches``: each captured launch once, not its replays),
never of ``gat_mp`` / ``gat_mp_bwd``, so the exact-launch counts of the
paths that tune hold.

JAX names with no counterpart: ``clamp_chunk`` and ``CHUNK_CANDIDATES``
(the neighbour block of the ``chunked`` lowering, which the port does
not have), ``_make_fn``'s ``chunked`` / ``pallas`` (one lowering per
device), and the ``REPRO_GAT_BACKEND`` knob of ``gnn.resolve_backend``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels.gat_mp import ops

# the shapes picked by hand before the tuner (csrc/gat_mp.cu,
# csrc/gat_mp_bwd.cu)
DEFAULT_BLOCKS = {"fwd": (4,), "bwd": (8, 512, 2)}
# launches captured in a timed graph, and its timed replays (the least
# is kept)
TIMING_LAUNCHES = 10
TIMING_REPS = 3

_CACHE: Dict[tuple, "GATTune"] = {}
_LOCK = threading.RLock()
_NAMES: Dict[int, str] = {}


@dataclasses.dataclass(frozen=True)
class GATTune:
    """One cached decision: the route ("cuda" or "plain"), the winning
    block shapes ({"fwd": (warps,), "bwd": (warps, rch, batch)}, None
    for "plain"), and the timings that justified them (empty when
    nothing was timed)."""
    backend: str
    blocks: Optional[Dict[str, tuple]]
    timings: Dict[str, Dict[str, float]]


def _device_name(dev: torch.device) -> str:
    if dev.type != "cuda":
        return dev.type
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    if idx not in _NAMES:
        _NAMES[idx] = torch.cuda.get_device_name(idx)
    return _NAMES[idx]


def _cache_key(n, d, heads, dtype, batch, masks, device) -> tuple:
    return (int(n), int(d), int(heads), str(dtype).replace("torch.", ""),
            int(batch), int(masks), _device_name(torch.device(device)))


def _pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def effective_fwd(n: int, shape: tuple) -> tuple:
    """The forward's shape as it acts at N = n: a block of more warps
    than rows (rounded up to a power of 2) runs as that many."""
    return (min(shape[0], _pow2(n)),)


def effective_bwd(n: int, shape: tuple) -> tuple:
    """The backward's shape as it acts at N = n: warps as the forward's;
    rows listed at a time past the least listing that holds all n rows
    act as that listing; at most n edges are gathered at once."""
    w, rch, batch = shape
    fits = [r for _, r, _ in ops.BWD_SHAPES if r >= n]
    return (min(w, _pow2(n)), min(rch, min(fits)) if fits else rch,
            min(batch, n))


def candidates(n: int, device_type: str) -> Dict[str, List[tuple]]:
    """Each kernel's block shapes worth timing at N = n on a device of
    ``device_type``: the compiled sets, smallest first, one shape per
    effective shape (the first); none off CUDA (the plain version)."""
    if device_type != "cuda":
        return {"fwd": [], "bwd": []}
    out = {}
    for kind, shapes, eff in (
            ("fwd", [(w,) for w in ops.FWD_WARPS], effective_fwd),
            ("bwd", list(ops.BWD_SHAPES), effective_bwd)):
        seen, keep = set(), []
        for s in sorted(shapes):
            e = eff(n, s)
            if e not in seen:
                seen.add(e)
                keep.append(s)
        out[kind] = keep
    return out


def label(kind: str, shape: tuple) -> str:
    if kind == "fwd":
        return f"fwd_w{shape[0]}"
    return "bwd_w{}_r{}_b{}".format(*shape)


def choose(timings: Dict[str, Dict[str, float]], kind: str) -> tuple:
    """The fastest timed shape of ``kind`` ("fwd" or "bwd"); the plain
    version's entry is never eligible."""
    key = f"{kind}_us"
    best = min((t[key], lab) for lab, t in timings.items()
               if lab.startswith(kind + "_") and key in t)
    return tuple(int(x[1:]) for x in best[1].split("_")[1:])


def _bench_inputs(n, d, heads, batch, masks, device):
    """z, e_src, e_dst, adj (~8 neighbours a row, symmetric, self-loops)
    of the launch's shape, from a seeded numpy generator, and the
    cotangent g."""
    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=device)
    z = torch.as_tensor(rng.standard_normal((batch, n, d)), **f32)
    es = torch.as_tensor(rng.standard_normal((batch, n, heads)), **f32)
    ed = torch.as_tensor(rng.standard_normal((batch, n, heads)), **f32)
    adj = rng.random((masks, n, n)) < min(1.0, 8.0 / n)
    adj = adj | adj.transpose(0, 2, 1) | np.eye(n, dtype=bool)[None]
    g = torch.as_tensor(rng.standard_normal((batch, n, d)), **f32)
    return z, es, ed, torch.as_tensor(adj, device=device), g


def _time_us(fn, device) -> float:
    """Least mean time of one call, in us, over ``TIMING_REPS`` runs of
    ``TIMING_LAUNCHES`` calls: on a card, replays of one CUDA graph of
    the calls timed by CUDA events, so the host's launch costs (tens of
    us a call, more than these kernels take) are not measured; on the
    CPU, the host's clock."""
    fn()
    if device.type != "cuda":
        best = float("inf")
        for _ in range(TIMING_REPS):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best * 1e6
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        # thread_local: the placement service's other threads may use the
        # card while this one captures
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            for _ in range(TIMING_LAUNCHES):
                fn()
        graph.replay()
        best = float("inf")
        for _ in range(TIMING_REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e3 / TIMING_LAUNCHES)
        del graph
    return best


def _time_plain(args, device) -> Dict[str, float]:
    z, es, ed, adj, g = args
    fwd = _time_us(lambda: ops.gat_mp_plain(z, es, ed, adj), device)
    out, m, l = ops.gat_mp_plain(z, es, ed, adj)
    bwd = _time_us(lambda: ops.gat_mp_bwd_plain(z, es, ed, adj, m, l, out,
                                                g), device)
    return {"fwd_us": round(fwd, 2), "fwd_bwd_us": round(fwd + bwd, 2)}


def _tune_cuda(args, cands, device, force_time):
    """Each kernel's timings and winner; raises if a candidate's outputs
    are not bit-equal to ``DEFAULT_BLOCKS``'."""
    z, es, ed, adj, g = args
    fwd0 = ops._launch(z, es, ed, adj, warps=DEFAULT_BLOCKS["fwd"][0],
                       counter=autotune)
    bwd0 = ops._launch_bwd(z, es, ed, adj, *fwd0[1:], fwd0[0], g,
                           shape=DEFAULT_BLOCKS["bwd"], counter=autotune)
    runs = {
        "fwd": lambda s: ops._launch(z, es, ed, adj, warps=s[0],
                                     counter=autotune),
        "bwd": lambda s: ops._launch_bwd(z, es, ed, adj, *fwd0[1:], fwd0[0],
                                         g, shape=s, counter=autotune)}
    timings, blocks = {}, {}
    for kind, want in (("fwd", fwd0), ("bwd", bwd0)):
        for s in cands[kind]:
            got = runs[kind](s)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise RuntimeError(
                    f"gat {kind} block shape {s} is not bit-equal to "
                    f"{DEFAULT_BLOCKS[kind]} at {tuple(z.shape)}")
        if len(cands[kind]) == 1 and not force_time:
            blocks[kind] = cands[kind][0]
            continue
        for s in cands[kind]:
            timings[label(kind, s)] = {f"{kind}_us": round(_time_us(
                lambda s=s: runs[kind](s), device), 2)}
        blocks[kind] = choose(timings, kind)
    return timings, blocks


def autotune(n: int, d: int, heads: int, dtype, *, batch: int, masks: int,
             device, include_dense: bool = False,
             force_time: bool = False) -> GATTune:
    """Resolve (and cache) the block shapes of both GAT kernels for one
    launch key: on a CUDA device the fastest of each kernel's
    candidates (backend "cuda"), elsewhere the plain version (backend
    "plain", no blocks).  ``force_time`` times even a lone candidate
    (and re-times a cache hit that skipped timing); ``include_dense``
    also times the plain version for the record, never eligible to
    win."""
    dev = torch.device(device)
    key = _cache_key(n, d, heads, dtype, batch, masks, dev)

    def fresh(hit):
        return hit is not None and not (force_time and not hit.timings) \
            and not (include_dense and "plain" not in hit.timings)

    hit = _CACHE.get(key)
    if fresh(hit):
        return hit
    with _LOCK:
        hit = _CACHE.get(key)
        if fresh(hit):
            return hit
        cands = candidates(n, dev.type)
        lone = all(len(c) <= 1 for c in cands.values())
        if lone and not force_time and not include_dense:
            res = (GATTune("plain", None, {}) if dev.type != "cuda" else
                   GATTune("cuda", {k: c[0] for k, c in cands.items()}, {}))
            _CACHE[key] = res
            return res
        with obs.span("gat_autotune", n=n, d=d, heads=heads,
                      dtype=key[3], batch=batch, masks=masks,
                      candidates=sum(map(len, cands.values()))) as sp, \
                torch.no_grad():
            args = _bench_inputs(n, d, heads, batch, masks, dev)
            timings, blocks = {}, None
            if dev.type == "cuda":
                timings, blocks = _tune_cuda(args, cands, dev, force_time)
            if include_dense or dev.type != "cuda":
                timings["plain"] = _time_plain(args, dev)
            chosen = ("plain" if blocks is None else
                      f"{label('fwd', blocks['fwd'])} "
                      f"{label('bwd', blocks['bwd'])}")
            sp.set(chosen=chosen)
        res = GATTune("plain" if blocks is None else "cuda", blocks, timings)
        _CACHE[key] = res
        return res


autotune.launches = 0       # timing launches of both kernels


def blocks_for(n: int, d: int, heads: int, dtype, *, batch: int,
               masks: int, device) -> Dict[str, tuple]:
    """The block shapes of a launch: the autotuned winner when one is
    cached for this key, else ``DEFAULT_BLOCKS``; never times."""
    hit = _CACHE.get(_cache_key(n, d, heads, dtype, batch, masks, device))
    if hit is not None and hit.blocks:
        return hit.blocks
    return DEFAULT_BLOCKS
