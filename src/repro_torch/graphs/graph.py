"""Workload-graph IR: nodes = operational layers, edges = tensor flow.

Copy of ``src/repro/graphs/graph.py`` (numpy only).

Node features follow the paper's Table 1 (op_id, weight_size, ifm/ofm
dims+sizes, n_ops_left, n_w_left, conv params, batch). Nodes are stored in
topological order; every node's outgoing edges carry the same output tensor
(so edge info lives in the source node, edges themselves are featureless),
exactly as in §3.1.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

OP_TYPES = (
    "input", "conv", "pool", "fc", "embed", "norm_proj", "qkv", "attn",
    "o_proj", "mlp", "moe_router", "expert_bank", "ssm", "conv1d",
    "cross_attn", "lm_head", "kv_cache", "add", "softmax",
)
OP_ID = {t: i for i, t in enumerate(OP_TYPES)}

N_FEATURES = 19


@dataclasses.dataclass
class Node:
    op: str
    weight_bytes: float = 0.0
    ifm: Tuple[int, int, int] = (0, 0, 0)   # (x, y, z)
    ofm: Tuple[int, int, int] = (0, 0, 0)
    flops: float = 0.0
    groups: int = 0
    kernel: Tuple[int, int] = (0, 0)
    stride: int = 0
    pad: int = 0
    dilation: int = 0
    batch: int = 1
    # fraction of weight bytes actually streamed per inference (MoE top-k/E)
    weight_access_frac: float = 1.0

    @property
    def ifm_bytes(self) -> float:
        return float(np.prod(self.ifm)) * 2 * self.batch  # bf16

    @property
    def ofm_bytes(self) -> float:
        return float(np.prod(self.ofm)) * 2 * self.batch


@dataclasses.dataclass
class WorkloadGraph:
    name: str
    nodes: List[Node]
    edges: List[Tuple[int, int]]  # (src, dst), topo order respected

    @property
    def n(self) -> int:
        return len(self.nodes)

    def features(self) -> np.ndarray:
        """(N, 19) Table-1 features, log-scaled sizes, z-normed per graph."""
        rows = []
        total_w_after = np.zeros(self.n + 1)
        for i in range(self.n - 1, -1, -1):
            total_w_after[i] = total_w_after[i + 1] + self.nodes[i].weight_bytes
        for i, nd in enumerate(self.nodes):
            rows.append([
                OP_ID[nd.op],
                np.log1p(nd.weight_bytes),
                nd.ifm[0], nd.ifm[1], np.log1p(nd.ifm[2]),
                nd.ofm[0], nd.ofm[1], np.log1p(nd.ofm[2]),
                np.log1p(nd.ifm_bytes),
                np.log1p(nd.ofm_bytes),
                (self.n - 1 - i) / max(self.n, 1),     # n_ops_left (normed)
                np.log1p(total_w_after[i + 1]),        # n_w_left
                nd.groups,
                nd.kernel[0], nd.kernel[1],
                nd.stride, nd.pad, nd.dilation,
                nd.batch,
            ])
        f = np.asarray(rows, np.float32)
        mu, sd = f.mean(0, keepdims=True), f.std(0, keepdims=True) + 1e-6
        out = (f - mu) / sd
        out[:, 0] = f[:, 0] / len(OP_TYPES)  # keep op id stable across graphs
        return out

    def adjacency(self) -> np.ndarray:
        """Dense bidirectional adjacency + self loops, row-normalized."""
        a = np.zeros((self.n, self.n), np.float32)
        for s, d in self.edges:
            a[s, d] = 1.0
            a[d, s] = 1.0
        a += np.eye(self.n, dtype=np.float32)
        return a / a.sum(1, keepdims=True)

    def arrays(self):
        """Static arrays consumed by the simulator (see memsim.simulator)."""
        w = np.array([nd.weight_bytes for nd in self.nodes], np.float64)
        wf = np.array([nd.weight_access_frac for nd in self.nodes], np.float64)
        act = np.array([nd.ofm_bytes for nd in self.nodes], np.float64)
        flops = np.array([nd.flops for nd in self.nodes], np.float64)
        last_consumer = np.arange(self.n)
        for s, d in self.edges:
            last_consumer[s] = max(last_consumer[s], d)
        consumers: List[List[int]] = [[] for _ in range(self.n)]
        for s, d in self.edges:
            consumers[d].append(s)
        return {
            "weight_bytes": w, "weight_frac": wf, "act_bytes": act,
            "flops": flops, "last_consumer": last_consumer,
            "producers_of": consumers,
        }

    def ring_width(self) -> int:
        """Max activation lifetime W = max(last_consumer[t] - t) + 1 — the
        rectifier's release-ring width — straight from the edge list.
        O(E) on the host, no SimGraph build: cheap enough for bucket
        assignment over a whole registry (graphs/bucketed.py)."""
        last = np.arange(self.n)
        for s, d in self.edges:
            last[s] = max(last[s], d)
        return int((last - np.arange(self.n)).max()) + 1

    def canonical_hash(self) -> str:
        """Structure-only content hash (see ``graphs/hashing.py``):
        identical for topologically equivalent relabelings, different
        for any simulator-visible perturbation.  The placement cache
        key of ``serving/placement_service.py``."""
        from repro_torch.graphs.hashing import canonical_hash
        return canonical_hash(self)

    def validate(self):
        for s, d in self.edges:
            assert 0 <= s < d < self.n, (s, d, "edges must be topo-ordered")
        return True
