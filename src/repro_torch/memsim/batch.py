"""Multi-graph simulator path: rectify / latency / evaluate a stacked
population of mappings against every workload of a ``GraphBatch``, and
of a size-bucketed ``BucketedZoo`` bucket by bucket.

Counterpart of ``src/repro/memsim/batch.py``.  ``evaluate_population_zoo``
is the kernel wrapper: on CUDA tensors it launches the zoo entry of
``csrc/memsim.cu`` once for the whole bucket (a block per mapping group
and graph); on CPU tensors it runs the plain version, the single-graph
plain ``rectify`` and ``latency`` on each graph's padded arrays with the
padded rows of the rectified output forced to 0.  Every per-graph number
is bit-equal to the single-graph path: the padded steps are IEEE
identities, eps divides by the host-side ``total_bytes`` and latency
sums left to right (see ``graphs/batch.py``).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.device import count_launch
from repro_torch.graphs.batch import GraphBatch
from repro_torch.graphs.bucketed import BucketedZoo
from repro_torch.kernels import build
from repro_torch.memsim import simulator as sim
from repro_torch.memsim import tiers as T

SCALARS = ("reward", "eps", "latency", "speedup", "valid")


# ------------------------------------------------------- plain versions
def rectify_zoo(gb: GraphBatch, mappings: torch.Tensor):
    """mappings (G, N_max, 2) or (P, G, N_max, 2) -> (rectified like
    mappings, eps (G,) or (P, G)).  Padded rows of the rectified output
    are 0.  Plain version, any device."""
    single = mappings.dim() == 3
    maps = mappings[None] if single else mappings
    rects, epss = [], []
    for i in range(gb.n_graphs):
        rect, eps = sim.rectify(gb.graph_sim(i), maps[:, i])
        rects.append(torch.where(gb.node_mask[i][:, None] > 0, rect, 0))
        epss.append(eps)
    rect, eps = torch.stack(rects, 1), torch.stack(epss, 1)
    return (rect[0], eps[0]) if single else (rect, eps)


def latency_zoo(gb: GraphBatch, mappings: torch.Tensor) -> torch.Tensor:
    """Masked roofline latency per graph: (G, N_max, 2) -> (G,), or
    (P, G, N_max, 2) -> (P, G).  Plain version, any device."""
    single = mappings.dim() == 3
    maps = mappings[None] if single else mappings
    lat = torch.stack([sim.latency(gb.graph_sim(i), maps[:, i],
                                   gb.node_mask[i])
                       for i in range(gb.n_graphs)], 1)
    return lat[0] if single else lat


def evaluate_population_zoo_plain(gb: GraphBatch, mappings: torch.Tensor,
                                  reward_scale: float = 5.0) -> Dict:
    """Plain version of ``evaluate_population_zoo``, any device."""
    rect, eps = rectify_zoo(gb, mappings)
    lat = latency_zoo(gb, rect)
    valid = eps <= 0.0
    speedup = gb.ref_latency / lat
    reward = torch.where(valid, speedup * float(np.float32(reward_scale)),
                         -eps)
    return {"reward": reward, "eps": eps, "latency": lat,
            "speedup": torch.where(valid, speedup, 0.0), "valid": valid,
            "rectified": rect}


# ------------------------------------------------------- kernel wrapper
_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
             + [ctypes.c_float] * 9 + [ctypes.c_void_p, ctypes.c_int]
             + [ctypes.c_void_p] * 7)


def _launch(gb: GraphBatch, maps: torch.Tensor, reward_scale: float) -> Dict:
    fn = build.function("memsim", "memsim_evaluate_zoo", _ARGTYPES)
    P, G, N = maps.shape[:3]
    sg = gb.sim
    dev = maps.device
    f32 = dict(dtype=torch.float32, device=dev)
    res = {k: torch.empty((P, G), **f32)
           for k in ("reward", "eps", "latency", "speedup")}
    res["valid"] = torch.empty((P, G), dtype=torch.bool, device=dev)
    res["rectified"] = torch.empty((P, G, N, 2), dtype=torch.int32,
                                   device=dev)
    cap = [float(np.float32(c)) for c in T.CAPACITIES]
    bw = [float(np.float32(b)) for b in T.BANDWIDTHS]
    with torch.cuda.device(dev):
        err = fn(sg.weight_bytes.data_ptr(), sg.weight_frac.data_ptr(),
                 sg.act_bytes.data_ptr(), sg.flops.data_ptr(),
                 sg.ring_t.data_ptr(), sg.ring_lc.data_ptr(),
                 sg.self_release.data_ptr(), sg.in_acts.data_ptr(),
                 sg.total_bytes.data_ptr(), gb.n_nodes.data_ptr(),
                 gb.ref_latency.data_ptr(), sg.in_acts.shape[2], N,
                 gb.w_max, G, *cap, *bw, float(sim.COMP_DENOM),
                 float(sim.OVERHEAD), float(np.float32(reward_scale)),
                 maps.data_ptr(), P, res["reward"].data_ptr(),
                 res["eps"].data_ptr(), res["latency"].data_ptr(),
                 res["speedup"].data_ptr(), res["valid"].data_ptr(),
                 res["rectified"].data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"memsim zoo kernel launch failed: CUDA error "
                           f"{err}")
    count_launch(evaluate_population_zoo)
    return res


def _check(gb: GraphBatch, mappings: torch.Tensor):
    if mappings.dim() != 4 or mappings.shape[-1] != 2:
        raise ValueError(f"mappings must be (P, G, N_max, 2), got "
                         f"{tuple(mappings.shape)}")
    if tuple(mappings.shape[1:3]) != (gb.n_graphs, gb.n_max):
        raise ValueError(f"mappings cover {tuple(mappings.shape[1:3])} "
                         f"(graphs, nodes), the batch is "
                         f"{(gb.n_graphs, gb.n_max)}")
    if mappings.device != gb.device:
        raise ValueError(f"the batch is on {gb.device}, mappings on "
                         f"{mappings.device}")


def evaluate_population_zoo(gb: GraphBatch, mappings: torch.Tensor,
                            reward_scale: float = 5.0) -> Dict:
    """mappings (P, G, N_max, 2) -> dict of (P, G) reward / eps /
    latency / speedup f32 and valid bool, and rectified (P, G, N_max, 2)
    int32 (padded rows 0).  CUDA tensors: one launch of the zoo entry of
    the simulator kernel (contiguous int32 mappings, 8-byte aligned;
    tiers of real rows in [0, 3), padded rows are not read); CPU tensors:
    the plain version."""
    _check(gb, mappings)
    if mappings.device.type == "cpu":
        return evaluate_population_zoo_plain(gb, mappings, reward_scale)
    if (mappings.dtype != torch.int32 or not mappings.is_contiguous()
            or mappings.data_ptr() % 8):
        raise ValueError("the simulator kernel takes contiguous int32 "
                         "mappings aligned to 8 bytes")
    if mappings.shape[0] == 0:
        raise ValueError("empty population")
    return _launch(gb, mappings, reward_scale)


evaluate_population_zoo.launches = 0


def evaluate_zoo(gb: GraphBatch, mapping: torch.Tensor,
                 reward_scale: float = 5.0) -> Dict:
    """One mapping per graph (G, N_max, 2) -> dict of (G,) tensors (and
    rectified (G, N_max, 2))."""
    res = evaluate_population_zoo(gb, mapping[None].contiguous(),
                                  reward_scale)
    return {k: v[0] for k, v in res.items()}


# ------------------------------------------------------- bucketed path
def rectify_bucketed(bz: BucketedZoo, mappings: Sequence[torch.Tensor]):
    """Per-bucket mappings [(G_k, N_max_k, 2), ...] -> (per-bucket
    rectified tuple, eps (G,) in zoo order).  Plain version."""
    rects, epss = [], []
    for gb, m in zip(bz.buckets, mappings):
        rect, eps = rectify_zoo(gb, m)
        rects.append(rect)
        epss.append(eps)
    return tuple(rects), bz.gather_zoo(epss)


def latency_bucketed(bz: BucketedZoo,
                     mappings: Sequence[torch.Tensor]) -> torch.Tensor:
    """Masked roofline latency per graph, zoo order: [(G_k, N_max_k, 2),
    ...] -> (G,).  Plain version."""
    return bz.gather_zoo([latency_zoo(gb, m)
                          for gb, m in zip(bz.buckets, mappings)])


def _gather(bz: BucketedZoo, per: Sequence[Dict]) -> Dict:
    out = {k: bz.gather_zoo([r[k] for r in per]) for k in SCALARS}
    out["rectified"] = tuple(r["rectified"] for r in per)
    return out


def evaluate_bucketed(bz: BucketedZoo, mappings: Sequence[torch.Tensor],
                      reward_scale: float = 5.0) -> Dict:
    """``evaluate_zoo`` per bucket: per-bucket (G_k, N_max_k, 2) mappings
    -> dict of (G,) zoo-order tensors + per-bucket ``rectified``."""
    return _gather(bz, [evaluate_zoo(gb, m, reward_scale)
                        for gb, m in zip(bz.buckets, mappings)])


def evaluate_population_bucketed(bz: BucketedZoo,
                                 mappings: Sequence[torch.Tensor],
                                 reward_scale: float = 5.0) -> Dict:
    """Zoo-wide population evaluation, one ``evaluate_population_zoo``
    per bucket (one kernel launch each on the card): per-bucket
    (P, G_k, N_max_k, 2) stacks -> dict of (P, G) zoo-order tensors +
    per-bucket ``rectified``."""
    if len(mappings) != bz.n_buckets:
        raise ValueError(f"{len(mappings)} mapping stacks for "
                         f"{bz.n_buckets} buckets")
    return _gather(bz, [evaluate_population_zoo(gb, m, reward_scale)
                        for gb, m in zip(bz.buckets, mappings)])


def aggregate_rewards(rewards: torch.Tensor, mode: str) -> torch.Tensor:
    """Fold per-graph rewards (..., G) into one fitness per row: "mean"
    (the average case) or "worst" (the weakest graph's reward)."""
    if mode == "mean":
        return torch.mean(rewards, dim=-1)
    if mode == "worst":
        return torch.amin(rewards, dim=-1)
    raise ValueError(f"unknown fitness aggregation {mode!r}; "
                     f"use 'mean' or 'worst'")
