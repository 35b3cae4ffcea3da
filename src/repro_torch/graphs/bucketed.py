"""Size-bucketed zoo IR: K ``GraphBatch``es, each padded only to its own
bucket's ``(N_max_k, W_max_k)``, instead of one batch padded to the
zoo-wide maxima.

Counterpart of ``src/repro/graphs/bucketed.py``.  Consumers
(``memsim.batch``, ``core.gnn``, ``core.egrl``, ``core.sac``) run once
per bucket and gather per-graph results back to zoo order through the
stable ``graph_bucket`` / ``graph_slot`` index maps.

Bucketing policy (``REPRO_ZOO_BUCKETS``, or the ``buckets`` argument of
``build_bucketed_zoo`` / ``ZooEGRL``; resolved fail-loud by
``utils.envpolicy``):

- ``"auto"`` (default): octave bands anchored at the largest graph --
  graph n lands in band ``floor(log2(n_max / n))``;
- an integer K: ``[n_min, n_max]`` split into K geometric intervals,
  empty ones dropped;
- ``"off"``: one bucket, the arrays of ``build_graph_batch``;
- ``"autotune"``: the K whose predicted makespan over the visible
  devices is smallest, from per-bucket times measured on the octave
  bucketing (``distributed.dispatch.autotune_bucket_k``).

Buckets are ordered by ascending ``N_max_k``; within a bucket graphs
keep their zoo order.  The JAX package's per-bucket PRNG plumbing
(``bucket_keys``) has no counterpart: the port takes each bucket's
random draws as explicit tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike
from repro_torch.graphs.batch import GraphBatch, build_graph_batch
from repro_torch.graphs.graph import WorkloadGraph
from repro_torch.utils.envpolicy import env_policy


def resolve_bucket_policy(override: Union[str, int, None] = None
                          ) -> Union[str, int]:
    """``REPRO_ZOO_BUCKETS`` -> "auto" | "off" | "autotune" | int >= 1,
    fail-loud.  "autotune" picks K from a measured per-bucket time model
    (``distributed.dispatch``) and is resolved by ``build_bucketed_zoo``:
    it needs the graphs, not just their sizes."""
    return env_policy("REPRO_ZOO_BUCKETS",
                      choices=("auto", "off", "autotune"),
                      default="auto", override=override, int_ok=True)


def assign_buckets(sizes: Sequence[int],
                   policy: Union[str, int, None] = None) -> List[int]:
    """Bucket id per graph (ids dense, 0..K-1, ascending bucket size); a
    pure function of the node counts and the resolved policy."""
    policy = resolve_bucket_policy(policy)
    if policy == "autotune":
        raise ValueError(
            "REPRO_ZOO_BUCKETS=autotune needs the graphs (it measures "
            "per-bucket times) — call build_bucketed_zoo, which resolves "
            "autotune to a concrete K before assigning")
    n = len(sizes)
    if n == 0:
        raise ValueError("empty zoo")
    if policy == "off" or policy == 1 or n == 1 or min(sizes) == max(sizes):
        return [0] * n
    top = max(sizes)
    if policy == "auto":
        # octave bands anchored at the largest graph; band 0 = largest
        bands = [int(math.floor(math.log2(top / s))) for s in sizes]
    else:
        k = int(policy)
        lo = min(sizes)
        span = math.log(top) - math.log(lo)
        bands = [min(k - 1, int(k * (math.log(top) - math.log(s)) / span))
                 for s in sizes]
    # drop empty bands, relabel ascending-size (band 0 holds the largest)
    remap = {b: i for i, b in enumerate(sorted(set(bands), reverse=True))}
    return [remap[b] for b in bands]


@dataclasses.dataclass(frozen=True)
class BucketedZoo:
    """K per-size-class GraphBatches + zoo-order index maps."""
    buckets: Tuple[GraphBatch, ...]
    graph_bucket: Tuple[int, ...]   # zoo index -> bucket id
    graph_slot: Tuple[int, ...]     # zoo index -> row inside its bucket
    names: Tuple[str, ...]          # zoo order

    # ------------------------------------------------------- geometry
    @property
    def n_graphs(self) -> int:
        return len(self.names)

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def n_features(self) -> int:
        return self.buckets[0].n_features

    @property
    def device(self) -> torch.device:
        return self.buckets[0].device

    @property
    def bucket_sizes(self) -> Tuple[int, ...]:
        """Graph count G_k per bucket."""
        return tuple(b.n_graphs for b in self.buckets)

    @property
    def node_slots(self) -> Tuple[int, ...]:
        """Padded node width per zoo graph: its bucket's N_max_k."""
        return tuple(self.buckets[b].n_max for b in self.graph_bucket)

    @property
    def n_eff(self) -> int:
        """Total padded node slots sum_k(G_k * N_max_k): the Boltzmann
        genome grid, bucket-major (bucket 0's graphs first)."""
        return sum(b.n_graphs * b.n_max for b in self.buckets)

    def real_sizes(self) -> Tuple[int, ...]:
        """Real node count per zoo graph."""
        return tuple(self.buckets[b].sizes[s] for b, s in
                     zip(self.graph_bucket, self.graph_slot))

    def pad_waste_frac(self) -> float:
        """Fraction of padded node slots that are padding."""
        real = sum(sum(b.sizes) for b in self.buckets)
        return 1.0 - real / self.n_eff

    # ---------------------------------------------- zoo-order round trip
    def zoo_perm(self) -> np.ndarray:
        """(G,) int32: position of zoo graph i in the bucket-major
        concatenation (bucket 0's slots, then bucket 1's, ...)."""
        offs = np.concatenate(
            [[0], np.cumsum([b.n_graphs for b in self.buckets])])
        return np.asarray([offs[b] + s for b, s in
                           zip(self.graph_bucket, self.graph_slot)], np.int32)

    def gather_zoo(self, per_bucket: Sequence[torch.Tensor]) -> torch.Tensor:
        """Per-bucket (..., G_k) tensors -> one (..., G) tensor in zoo
        order: a concatenation and an exact gather."""
        cat = torch.cat(list(per_bucket), dim=-1)
        perm = torch.as_tensor(self.zoo_perm().astype(np.int64),
                               device=cat.device)
        return torch.index_select(cat, -1, perm)

    def split_zoo_mappings(self, maps: torch.Tensor
                           ) -> Tuple[torch.Tensor, ...]:
        """Zoo-order mappings (..., G, N_max, 2) -> per-bucket
        (..., G_k, N_max_k, 2) slices."""
        out = []
        for k, b in enumerate(self.buckets):
            ids = [i for i in range(self.n_graphs)
                   if self.graph_bucket[i] == k]    # slot order == zoo order
            idx = torch.as_tensor(ids, dtype=torch.long, device=maps.device)
            out.append(torch.index_select(maps, -3, idx)[..., :b.n_max, :])
        return tuple(out)

    def to(self, device: DeviceLike) -> "BucketedZoo":
        """This zoo on ``device`` (itself when it is there already)."""
        buckets = tuple(b.to(device) for b in self.buckets)
        if all(a is b for a, b in zip(buckets, self.buckets)):
            return self
        return dataclasses.replace(self, buckets=buckets)

    @classmethod
    def from_batch(cls, gb: GraphBatch) -> "BucketedZoo":
        """A flat GraphBatch as a single-bucket zoo (shared, not
        copied)."""
        g = gb.n_graphs
        return cls(buckets=(gb,), graph_bucket=(0,) * g,
                   graph_slot=tuple(range(g)), names=gb.names)


def build_bucketed_zoo(graphs: Sequence[WorkloadGraph],
                       buckets: Union[str, int, None] = None,
                       device: DeviceLike = "cuda",
                       devices: Optional[Sequence[DeviceLike]] = None
                       ) -> BucketedZoo:
    """Bucket ``graphs`` by node count (policy: ``buckets``, else
    ``REPRO_ZOO_BUCKETS``) and build one GraphBatch per bucket on
    ``device``, each padded only to its own (N_max_k, W_max_k).  The
    "autotune" policy measures a per-bucket time model on ``device``
    first and resolves to the K whose predicted makespan over
    ``devices`` (default: every visible device of ``device``'s type) is
    smallest."""
    if not graphs:
        raise ValueError("empty zoo")
    policy = resolve_bucket_policy(buckets)
    if policy == "autotune":
        # imported here: the dispatch module imports this one
        from repro_torch.distributed.dispatch import autotune_bucket_k
        policy = autotune_bucket_k(graphs, device=device, devices=devices)
    assign = assign_buckets([g.n for g in graphs], policy)
    n_buckets = max(assign) + 1
    per_bucket = [[g for g, a in zip(graphs, assign) if a == k]
                  for k in range(n_buckets)]
    slots, counters = [], [0] * n_buckets
    for a in assign:
        slots.append(counters[a])
        counters[a] += 1
    return BucketedZoo(
        buckets=tuple(build_graph_batch(gs, device=device)
                      for gs in per_bucket),
        graph_bucket=tuple(assign),
        graph_slot=tuple(slots),
        names=tuple(g.name for g in graphs))
