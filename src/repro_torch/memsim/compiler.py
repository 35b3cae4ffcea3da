"""The "native compiler" baseline: manually tuned heuristic placement
rules (stand-in for the NNP-I compiler of §4), plus the Greedy-DP
baseline agent.

Counterpart of ``src/repro/memsim/compiler.py``; ``heuristic_mapping``
is a copy of the numpy original.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs.graph import WorkloadGraph
from repro_torch.memsim import tiers as T
from repro_torch.memsim.simulator import (build_sim_graph, evaluate,
                                          evaluate_population)


def heuristic_mapping(g: WorkloadGraph) -> np.ndarray:
    """Conservative size-threshold rules (production compilers reserve most
    of the fast tiers for scratch and double-buffering, so only small
    tensors are pinned — this caution is exactly the headroom a
    per-workload learner can exploit, cf. §5.2.1 of the paper). The same
    sequential allocator then resolves capacity, with the heuristic's
    budget capped at half of each fast tier."""
    n = g.n
    m = np.zeros((n, 2), np.int32)
    budget = {T.VMEM_IDX: T.TIERS[T.VMEM_IDX].capacity * 0.5,
              T.CMEM_IDX: T.TIERS[T.CMEM_IDX].capacity * 0.5}
    for i, nd in enumerate(g.nodes):
        wb, ab = nd.weight_bytes, nd.ofm_bytes
        for tensor, (bytes_, col) in enumerate([(wb, 0), (ab, 1)]):
            tier = T.HBM_IDX
            if bytes_ <= 64 * 2 ** 10 and budget[T.VMEM_IDX] >= bytes_:
                tier = T.VMEM_IDX
            elif bytes_ <= 1 * 2 ** 20 and budget[T.CMEM_IDX] >= bytes_:
                tier = T.CMEM_IDX
            if tier != T.HBM_IDX:
                budget[tier] -= bytes_
            m[i, col] = tier
    return m


def compiler_reference(g: WorkloadGraph, device: DeviceLike = "cuda"):
    """Returns (compiler mapping (rectified) as numpy int32, its latency
    as a Python float), from one simulator evaluation on ``device``."""
    dev = resolve_device(device)
    sg = build_sim_graph(g, dev)
    m = torch.as_tensor(heuristic_mapping(g), device=dev)
    res = evaluate(sg, m, ref_latency=1.0)
    return res["rectified"].cpu().numpy(), float(res["latency"])


def greedy_dp(g: WorkloadGraph, passes: int = 3, budget: int = None,
              log=None, device: DeviceLike = "cuda"):
    """Greedy-DP agent (§4 Baselines): layer-wise greedy sweeps assuming
    conditional independence across nodes. 9 candidate (w, a) placements
    per node, evaluated with the true simulator reward; several passes.

    Step for step the JAX package's ``greedy_dp``: the start is all-HBM,
    each node's 9 candidates are one ``evaluate_population`` (one
    simulator launch on CUDA) and the first best reward wins; ``budget``
    counts candidates and ends the search once reached.

    Returns (best mapping as numpy int32, history of (iteration,
    best_reward)).
    """
    dev = resolve_device(device)
    sg = build_sim_graph(g, dev)
    _, ref_lat = compiler_reference(g, dev)
    n = g.n
    combos = torch.tensor([(w, a) for w in range(3) for a in range(3)],
                          dtype=torch.int32, device=dev)        # (9, 2)
    mapping = torch.zeros((n, 2), dtype=torch.int32, device=dev)
    history = []
    iters = 0
    for p in range(passes):
        for i in range(n):
            cand = mapping[None].repeat(9, 1, 1)
            cand[:, i, :] = combos
            res = evaluate_population(sg, cand, ref_lat)
            # argmax returns the first of equal maxima, as jnp.argmax does
            best = int(torch.argmax(res["reward"]))
            mapping = cand[best]
            iters += 9
            if budget is not None and iters >= budget:
                r = evaluate(sg, mapping, ref_lat)
                history.append((iters, float(r["reward"])))
                return mapping.cpu().numpy(), history
        r = evaluate(sg, mapping, ref_lat)
        history.append((iters, float(r["reward"])))
        if log:
            log(f"greedy-dp pass {p + 1}: reward {float(r['reward']):.3f} "
                f"speedup {float(r['speedup']):.3f}")
    return mapping.cpu().numpy(), history
