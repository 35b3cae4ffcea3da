"""Padded multi-graph IR: heterogeneous ``WorkloadGraph``s stacked into
one ``GraphBatch``, so a population can be evaluated against several
workloads in one simulator launch and one batched policy forward.

Counterpart of ``src/repro/graphs/batch.py``, with the same padding
rules.  Each graph is padded to the batch-wide ``N_max`` with inert
nodes: zero weight and activation bytes, zero FLOPs, no producers and
``last_consumer == t`` (they release themselves and never touch the
release ring), so the rectifier's steps over them are IEEE identities
(``x - 0 == x``, ``moved + 0 == moved``).  The ring is sized by the
batch-wide maximum activation lifetime ``W_max``; the eps denominator
``total_bytes`` is computed per graph on the host, in the oracle's
order; latency sums its per-node terms strictly left to right, so the
node mask's trailing zeros are identities too.

The policy's arrays are padded with zero feature rows and adjacency
rows that hold only a self-loop, which keeps padded nodes disconnected
from the real ones.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, normalize_device, resolve_device
from repro_torch.graphs.graph import WorkloadGraph
from repro_torch.memsim import tiers as T
from repro_torch.memsim.simulator import (SimGraph, build_release_idx,
                                          total_bytes_np)


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """G workloads padded to (G, N_max), on one device."""
    sim: SimGraph              # every field stacked to (G, N_max, ...);
    #                            ring_init (G, W_max, N_TIERS),
    #                            total_bytes (G,)
    node_mask: torch.Tensor    # (G, N_max) f32: 1.0 = real node
    n_nodes: torch.Tensor      # (G,) int32 real node counts
    ref_latency: torch.Tensor  # (G,) f32 compiler-reference latency
    feats: torch.Tensor        # (G, N_max, F) Table-1 features, 0-padded
    adj: torch.Tensor          # (G, N_max, N_max) row-normalised; padded
    #                            rows hold only a self-loop
    names: Tuple[str, ...]
    sizes: Tuple[int, ...]     # host copy of n_nodes

    @property
    def n_graphs(self) -> int:
        return self.node_mask.shape[0]

    @property
    def n_max(self) -> int:
        return self.node_mask.shape[1]

    @property
    def n_features(self) -> int:
        return self.feats.shape[-1]

    @property
    def w_max(self) -> int:
        """Release-ring width this batch was padded to."""
        return self.sim.ring_init.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.node_mask.device

    def to(self, device: DeviceLike) -> "GraphBatch":
        """This batch on ``device`` (itself when it is there already)."""
        dev = normalize_device(device)
        if dev == normalize_device(self.device):
            return self
        return dataclasses.replace(
            self, sim=SimGraph(*(x.to(dev) for x in self.sim)),
            **{f: getattr(self, f).to(dev) for f in
               ("node_mask", "n_nodes", "ref_latency", "feats", "adj")})

    def graph_sim(self, i: int) -> SimGraph:
        """The i-th graph's padded SimGraph slice."""
        return SimGraph(*(x[i] for x in self.sim))


def _padded_sim_arrays(g: WorkloadGraph, arr: dict, n_max: int,
                       w_max: int, max_in: int):
    """Numpy arrays of one graph padded to the batch-wide shapes;
    ``release_idx`` at the graph's own fan-in width (the caller pads it
    to the batch maximum)."""
    n = g.n

    def pad1(x, fill=0.0, dtype=np.float32):
        out = np.full(n_max, fill, dtype)
        out[:n] = x
        return out

    last = np.arange(n_max, dtype=np.int32)       # pads self-consume
    last[:n] = arr["last_consumer"].astype(np.int32)
    in_acts = -np.ones((n_max, max_in), np.int32)
    for i, ps in enumerate(arr["producers_of"]):
        in_acts[i, :len(ps)] = ps
    t_arr = np.arange(n_max, dtype=np.int32)
    return dict(
        weight_bytes=pad1(arr["weight_bytes"]),
        weight_frac=pad1(arr["weight_frac"]),
        act_bytes=pad1(arr["act_bytes"]),
        flops=pad1(arr["flops"]),
        last_consumer=last,
        in_acts=in_acts,
        release_idx=build_release_idx(last),
        ring_t=(t_arr % w_max).astype(np.int32),
        ring_lc=(last % w_max).astype(np.int32),
        self_release=(last == t_arr).astype(np.float32),
        ring_init=np.zeros((w_max, T.N_TIERS), np.float32),
        total_bytes=total_bytes_np(arr["weight_bytes"], arr["act_bytes"]),
    )


def build_graph_batch(graphs: Sequence[WorkloadGraph], n_max: int = None,
                      *, w_max: int = None, in_width: int = None,
                      release_width: int = None,
                      device: DeviceLike = "cuda") -> GraphBatch:
    """Stack heterogeneous workloads into one padded GraphBatch on
    ``device`` (the compiler references are evaluated there).

    ``n_max`` over-pads beyond the largest graph (>= max(g.n));
    ``w_max`` / ``in_width`` / ``release_width`` are least widths of the
    release ring, the producer lists and the release-index table: the
    widths the graphs need are rounded up to them, never down.  All
    of these paddings leave every per-graph result unchanged, bit for
    bit."""
    from repro_torch.memsim.compiler import compiler_reference

    if not graphs:
        raise ValueError("empty graph batch")
    dev = resolve_device(device)
    arrs = [g.arrays() for g in graphs]
    largest = max(g.n for g in graphs)
    n_max = largest if n_max is None else n_max
    if n_max < largest:
        raise ValueError(f"n_max {n_max} < the largest graph's {largest} "
                         f"nodes")
    max_in = max(1, max((len(p) for arr in arrs
                         for p in arr["producers_of"]), default=0))
    if in_width is not None:
        max_in = max(max_in, in_width)
    w_need = max(int((arr["last_consumer"] - np.arange(g.n)).max()) + 1
                 for g, arr in zip(graphs, arrs))
    w_max = w_need if w_max is None else max(w_max, w_need)
    per_graph = [_padded_sim_arrays(g, arr, n_max, w_max, max_in)
                 for g, arr in zip(graphs, arrs)]
    max_release = max(p["release_idx"].shape[1] for p in per_graph)
    if release_width is not None:
        max_release = max(max_release, release_width)
    for p in per_graph:
        ridx = p["release_idx"]
        p["release_idx"] = np.concatenate(
            [ridx, -np.ones((n_max, max_release - ridx.shape[1]),
                            np.int32)], axis=1)

    def stack(field):
        return torch.as_tensor(np.stack([p[field] for p in per_graph]),
                               device=dev)

    sim = SimGraph(*(stack(f) for f in SimGraph._fields))

    node_mask = np.zeros((len(graphs), n_max), np.float32)
    feats = np.zeros((len(graphs), n_max, graphs[0].features().shape[1]),
                     np.float32)
    adj = np.zeros((len(graphs), n_max, n_max), np.float32)
    ref = np.zeros(len(graphs), np.float32)
    for i, g in enumerate(graphs):
        node_mask[i, :g.n] = 1.0
        feats[i, :g.n] = g.features()
        adj[i, :g.n, :g.n] = g.adjacency()
        adj[i, np.arange(g.n, n_max), np.arange(g.n, n_max)] = 1.0
        _, ref[i] = compiler_reference(g, dev)
    return GraphBatch(
        sim=sim,
        node_mask=torch.as_tensor(node_mask, device=dev),
        n_nodes=torch.tensor([g.n for g in graphs], dtype=torch.int32,
                             device=dev),
        ref_latency=torch.as_tensor(ref, device=dev),
        feats=torch.as_tensor(feats, device=dev),
        adj=torch.as_tensor(adj, device=dev),
        names=tuple(g.name for g in graphs),
        sizes=tuple(g.n for g in graphs),
    )
