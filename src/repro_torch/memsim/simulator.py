"""Latency + validity simulator for memory placements, in PyTorch.

Counterpart of ``src/repro/memsim/simulator.py`` (Algorithm 1):

- ``rectify``: walk the graph in topological order with per-tier free
  byte counters (weights pinned, activations freed after their last
  consumer) and spill any placement that does not fit to HBM; the
  spilled-bytes ratio is the mapping error eps;
- ``latency``: roofline per node, max(compute, weight fetch + act in/out)
  + fixed overhead, summed over the sequential schedule;
- ``evaluate_population``: eps > 0 -> reward = -eps, else reward =
  reward_scale * speedup over the compiler's latency.

``rectify`` and ``latency`` are the plain versions: a per-step loop of
tensor ops batched over the population axis, on any device, with the
reference's float32 order (subtract weight, subtract activation, add
the per-tier release sums accumulated in ascending producer order; a
strictly left-to-right latency sum -- never ``torch.sum``, which
regroups).  ``evaluate_population`` is the kernel wrapper: on CUDA
tensors it launches ``csrc/memsim.cu`` once for the whole population,
on CPU tensors it runs the plain versions.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import numpy as np
import torch

from repro_torch.device import count_launch
from repro_torch.graphs.graph import WorkloadGraph
from repro_torch.kernels import build
from repro_torch.memsim import tiers as T

# f32 constants formed as the reference forms them (float64, then one
# rounding to float32)
COMP_DENOM = np.float32(T.PEAK_FLOPS * T.OP_UTILIZATION_DEFAULT)
OVERHEAD = np.float32(T.FIXED_OVERHEAD_S)


class SimGraph(NamedTuple):
    """Static arrays derived from a WorkloadGraph, on one device."""
    weight_bytes: torch.Tensor     # (N,) f32
    weight_frac: torch.Tensor      # (N,) f32 fraction streamed per inference
    act_bytes: torch.Tensor        # (N,) f32
    flops: torch.Tensor            # (N,) f32
    last_consumer: torch.Tensor    # (N,) int32
    in_acts: torch.Tensor          # (N, max_in) int32 producer idx, -1 pad
    release_idx: torch.Tensor      # (N, max_release) int32, -1 pad
    ring_t: torch.Tensor           # (N,) int32: t % W
    ring_lc: torch.Tensor          # (N,) int32: last_consumer % W
    self_release: torch.Tensor     # (N,) f32: 1.0 iff last_consumer == t
    ring_init: torch.Tensor        # (W, N_TIERS) f32 zeros
    total_bytes: torch.Tensor      # () f32, host-side oracle order


def build_release_idx(last_consumer: np.ndarray) -> np.ndarray:
    """Padded inverse of last_consumer: release_idx[t] lists every node n
    with last_consumer[n] == t (its activation is freed after step t)."""
    n = len(last_consumer)
    released = [[] for _ in range(n)]
    for node, t in enumerate(last_consumer):
        released[int(t)].append(node)
    max_release = max(1, max(len(r) for r in released))
    out = -np.ones((n, max_release), np.int32)
    for t, nodes in enumerate(released):
        out[t, :len(nodes)] = nodes
    return out


def total_bytes_np(weight_bytes: np.ndarray, act_bytes: np.ndarray):
    """eps denominator in the oracle's order: a strict left-to-right
    float32 accumulation, weights then activations."""
    total = np.float32(0.0)
    for v in np.asarray(weight_bytes, np.float32):
        total = np.float32(total + v)
    for v in np.asarray(act_bytes, np.float32):
        total = np.float32(total + v)
    return total


def build_sim_graph(g: WorkloadGraph, device="cpu") -> SimGraph:
    arr = g.arrays()
    n = g.n
    max_in = max(1, max(len(p) for p in arr["producers_of"]))
    in_acts = -np.ones((n, max_in), np.int32)
    for i, ps in enumerate(arr["producers_of"]):
        for j, p in enumerate(ps):
            in_acts[i, j] = p
    last = arr["last_consumer"].astype(np.int32)
    t_arr = np.arange(n)
    w = int((last - t_arr).max()) + 1          # max activation lifetime

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    def i32(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=device)

    return SimGraph(
        f32(arr["weight_bytes"]), f32(arr["weight_frac"]),
        f32(arr["act_bytes"]), f32(arr["flops"]), i32(last), i32(in_acts),
        i32(build_release_idx(last)), i32(t_arr % w), i32(last % w),
        f32((last == t_arr).astype(np.float32)),
        torch.zeros((w, T.N_TIERS), dtype=torch.float32, device=device),
        f32(total_bytes_np(arr["weight_bytes"], arr["act_bytes"])),
    )


def _batched(mappings: torch.Tensor) -> torch.Tensor:
    return mappings[None] if mappings.dim() == 2 else mappings


# ------------------------------------------------------- plain versions
def rectify(sg: SimGraph, mappings: torch.Tensor):
    """mappings (P, N, 2) or (N, 2) ints in [0, 3): [..., 0] weight tier,
    [..., 1] activation tier.  Returns (rectified int32 like mappings,
    eps f32 of shape (P,) or ()).  Plain version, any device."""
    single = mappings.dim() == 2
    maps = _batched(mappings).long()
    dev = maps.device
    P, N = maps.shape[:2]
    rows = torch.arange(P, device=dev)
    free = torch.tensor(T.CAPACITIES, dtype=torch.float32,
                        device=dev).repeat(P, 1)                 # (P, 3)
    ring = torch.zeros((P,) + tuple(sg.ring_init.shape), dtype=torch.float32,
                       device=dev)                               # (P, W, 3)
    moved = torch.zeros(P, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.long, device=dev)
    out = torch.empty((P, N, 2), dtype=torch.int32, device=dev)
    ring_t = sg.ring_t.tolist()
    ring_lc = sg.ring_lc.tolist()
    self_rel = sg.self_release.tolist()
    for t in range(N):
        row = ring[:, ring_t[t]].clone()
        ring[:, ring_t[t]] = 0.0
        wb, ab = sg.weight_bytes[t], sg.act_bytes[t]
        wt, at = maps[:, t, 0], maps[:, t, 1]
        # weights: pinned for the whole run
        w_fits = free[rows, wt] >= wb
        w_tier = torch.where(w_fits, wt, zero)
        moved = torch.where(w_fits, moved, moved + wb)
        free[rows, w_tier] = free[rows, w_tier] - wb
        # output activation: lives until its last consumer
        a_fits = free[rows, at] >= ab
        a_tier = torch.where(a_fits, at, zero)
        moved = torch.where(a_fits, moved, moved + ab)
        free[rows, a_tier] = free[rows, a_tier] - ab
        if self_rel[t]:
            row[rows, a_tier] = row[rows, a_tier] + ab
        else:
            lc = ring_lc[t]
            ring[rows, lc, a_tier] = ring[rows, lc, a_tier] + ab
        free = free + row
        out[:, t, 0] = w_tier.to(torch.int32)
        out[:, t, 1] = a_tier.to(torch.int32)
    # divide by a full tensor, not a scalar: a scalar divisor may be
    # turned into a multiplication by its reciprocal
    eps = moved / torch.clamp(sg.total_bytes, min=1.0).expand(P)
    return (out[0], eps[0]) if single else (out, eps)


def latency(sg: SimGraph, mappings: torch.Tensor,
            node_mask: torch.Tensor = None) -> torch.Tensor:
    """Roofline latency of (valid) mappings (P, N, 2) or (N, 2) -> (P,)
    or ().  ``node_mask`` (N,) f32 multiplies the per-node terms: a
    padded graph's mask makes its padded nodes add exactly 0.0 (real
    nodes multiply by 1.0, an identity).  Plain version, any device."""
    single = mappings.dim() == 2
    maps = _batched(mappings).long()
    dev = maps.device
    P, N = maps.shape[:2]
    bw = torch.tensor(T.BANDWIDTHS, dtype=torch.float32, device=dev)
    w_t = (sg.weight_bytes * sg.weight_frac) / bw[maps[..., 0]]   # (P, N)
    out_t = sg.act_bytes / bw[maps[..., 1]]
    # inputs stream from wherever the producer placed them; the fan-in
    # axis is added left to right
    real = sg.in_acts >= 0
    src = sg.in_acts.clamp(min=0).long()                           # (N, M)
    in_tier = torch.where(real, maps[:, src, 1], 0)                # (P, N, M)
    in_bytes = torch.where(real, sg.act_bytes[src], 0.0)
    in_terms = in_bytes / bw[in_tier]
    in_t = in_terms[..., 0]
    for j in range(1, in_terms.shape[-1]):
        in_t = in_t + in_terms[..., j]
    mem_t = (w_t + out_t) + in_t
    comp_t = sg.flops / torch.tensor(COMP_DENOM, device=dev).expand(N)
    terms = torch.maximum(mem_t, comp_t) + torch.tensor(OVERHEAD, device=dev)
    if node_mask is not None:
        terms = terms * node_mask
    lat = torch.zeros(P, dtype=torch.float32, device=dev)
    for t in range(N):
        lat = lat + terms[:, t]
    return lat[0] if single else lat


def _reward(eps, lat, ref_latency: float, reward_scale: float):
    valid = eps <= 0.0
    ref = torch.tensor(float(ref_latency), dtype=torch.float32,
                       device=lat.device)
    speedup = ref / lat
    reward = torch.where(valid, speedup * float(np.float32(reward_scale)),
                         -eps)
    return {"reward": reward, "eps": eps, "latency": lat,
            "speedup": torch.where(valid, speedup, 0.0), "valid": valid}


def evaluate_population_plain(sg: SimGraph, mappings: torch.Tensor,
                              ref_latency: float,
                              reward_scale: float = 5.0) -> Dict:
    """Plain version of ``evaluate_population``, any device."""
    rect, eps = rectify(sg, mappings)
    out = _reward(eps, latency(sg, rect), ref_latency, reward_scale)
    out["rectified"] = rect
    return out


# ------------------------------------------------------- kernel wrapper
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
             + [ctypes.c_float] * 10 + [ctypes.c_void_p, ctypes.c_int]
             + [ctypes.c_void_p] * 7)


def _launch(sg: SimGraph, maps: torch.Tensor, ref_latency: float,
            reward_scale: float) -> Dict:
    fn = build.function("memsim", "memsim_evaluate", _ARGTYPES)
    P, N = maps.shape[:2]
    dev = maps.device
    f32 = dict(dtype=torch.float32, device=dev)
    res = {k: torch.empty(P, **f32)
           for k in ("reward", "eps", "latency", "speedup")}
    res["valid"] = torch.empty(P, dtype=torch.bool, device=dev)
    res["rectified"] = torch.empty((P, N, 2), dtype=torch.int32, device=dev)
    cap = [float(np.float32(c)) for c in T.CAPACITIES]
    bw = [float(np.float32(b)) for b in T.BANDWIDTHS]
    with torch.cuda.device(dev):
        err = fn(sg.weight_bytes.data_ptr(), sg.weight_frac.data_ptr(),
                 sg.act_bytes.data_ptr(), sg.flops.data_ptr(),
                 sg.ring_t.data_ptr(), sg.ring_lc.data_ptr(),
                 sg.self_release.data_ptr(), sg.in_acts.data_ptr(),
                 sg.total_bytes.data_ptr(), sg.in_acts.shape[1], N,
                 sg.ring_init.shape[0], *cap, *bw, float(COMP_DENOM),
                 float(OVERHEAD), float(np.float32(float(ref_latency))),
                 float(np.float32(reward_scale)), maps.data_ptr(), P,
                 res["reward"].data_ptr(), res["eps"].data_ptr(),
                 res["latency"].data_ptr(), res["speedup"].data_ptr(),
                 res["valid"].data_ptr(), res["rectified"].data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"memsim kernel launch failed: CUDA error {err}")
    count_launch(evaluate_population)
    return res


def _check(sg: SimGraph, mappings: torch.Tensor):
    if mappings.dim() != 3 or mappings.shape[-1] != 2:
        raise ValueError(f"mappings must be (P, N, 2), got "
                         f"{tuple(mappings.shape)}")
    n = sg.weight_bytes.shape[0]
    if mappings.shape[1] != n:
        raise ValueError(f"mappings cover {mappings.shape[1]} nodes, the "
                         f"graph has {n}")
    for name, x in zip(SimGraph._fields, sg):
        if x.device != mappings.device:
            raise ValueError(f"SimGraph.{name} is on {x.device}, mappings "
                             f"on {mappings.device}")


def evaluate_population(sg: SimGraph, mappings: torch.Tensor,
                        ref_latency: float, reward_scale: float = 5.0
                        ) -> Dict:
    """mappings (P, N, 2) -> dict of (P,) reward/eps/latency/speedup f32,
    valid bool and rectified (P, N, 2) int32.  CUDA tensors: one launch
    of the simulator kernel (mappings must be contiguous int32, 8-byte
    aligned: the kernel reads a node's two tiers as one int2); CPU
    tensors: the plain version."""
    _check(sg, mappings)
    if mappings.device.type == "cpu":
        return evaluate_population_plain(sg, mappings, ref_latency,
                                         reward_scale)
    if (mappings.dtype != torch.int32 or not mappings.is_contiguous()
            or mappings.data_ptr() % 8):
        raise ValueError("the simulator kernel takes contiguous int32 "
                         "mappings aligned to 8 bytes")
    if mappings.shape[0] == 0:
        raise ValueError("empty population")
    return _launch(sg, mappings, ref_latency, reward_scale)


evaluate_population.launches = 0


def evaluate(sg: SimGraph, mapping: torch.Tensor, ref_latency: float,
             reward_scale: float = 5.0) -> Dict:
    """One mapping (N, 2) -> dict of 0-d tensors (and rectified (N, 2))."""
    res = evaluate_population(sg, mapping[None], ref_latency, reward_scale)
    return {k: v[0] for k, v in res.items()}
