"""The "native compiler" baseline: manually tuned heuristic placement
rules (stand-in for the NNP-I compiler of §4).

Counterpart of ``src/repro/memsim/compiler.py``; ``heuristic_mapping``
is a copy of the numpy original.  ``greedy_dp`` is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs.graph import WorkloadGraph
from repro_torch.memsim import tiers as T
from repro_torch.memsim.simulator import build_sim_graph, evaluate


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
