"""Canonical WorkloadGraph hashing — the exact-match cache key of the
placement service (serving/placement_service.py).

Two structurally identical workloads must hash identically even when
their nodes were inserted in a different (topologically equivalent)
order, while ANY change that the memory simulator can observe — a node
payload field, an edge, the activation-lifetime ring width — must change
the hash.  The construction:

1. **Payload labels.**  Every node gets a label hashing the full
   simulator-visible payload (op, weight bytes, ifm/ofm dims, flops,
   conv params, batch, weight_access_frac).
2. **WL refinement.**  A few rounds of Weisfeiler–Lehman relabeling mix
   each node's label with the sorted multisets of its predecessor and
   successor labels (direction-aware), so nodes are distinguished by
   their neighborhood structure, not their position in the node list.
3. **Canonical topological order.**  Kahn's algorithm with the ready
   set ordered by (WL label, payload) produces a deterministic
   topological order that depends only on the graph's structure — any
   valid relabeling of the input yields the same canonical order (up to
   automorphisms, which serialize identically by definition).
4. **Serialization.**  The hash covers the payloads in canonical order,
   the canonically re-indexed edge list, and the release-ring width of
   the canonical order (the simulator's W; redundant with the edges but
   pinned explicitly so the property "a ring-width perturbation changes
   the hash" is direct).

The hash is a pure host-side function — no device work — and
costs O(rounds * E log E), microseconds-to-milliseconds for <=1k-node
graphs (cheap enough to run per request).

**WL similarity sketch**: the placement service's
nearest-neighbor cache needs "almost the same graph" on top of the
exact key above.  ``wl_sketch`` turns the per-round WL label SETS into
a fixed-width minhash signature (``_SKETCH_SLOTS`` independent minhash
functions per refinement round, salted blake2b), so two graphs that
differ in one resized layer agree on most slots — round 0 differs only
at the touched node, and each later round only within its WL
neighborhood — while structurally different graphs agree on ~none.
``SketchIndex`` buckets signatures by bands of consecutive slots
(classic banded LSH), so a lookup probes a handful of dict buckets
instead of scanning the cache; candidates are re-ranked by the exact
slot-agreement fraction (``sketch_similarity``).  Everything is
content-derived and deterministic across processes (no per-process
hash seeds), so a persisted index re-loads byte-for-byte.

Copied from ``src/repro/graphs/hashing.py`` (hashlib only), so both
packages key the same graph to the same hash and sketch.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.graphs.graph import Node, WorkloadGraph

_WL_ROUNDS = 3
_SKETCH_SLOTS = 8        # minhash functions per WL round
_BAND_ROWS = 2           # sketch slots per LSH band


def _h(*parts) -> str:
    m = hashlib.sha256()
    for p in parts:
        m.update(repr(p).encode())
        m.update(b"\x1f")
    return m.hexdigest()


def node_payload(nd: Node) -> Tuple:
    """The simulator-visible fields of one node, as a stable tuple."""
    return (
        nd.op,
        float(nd.weight_bytes),
        tuple(int(x) for x in nd.ifm),
        tuple(int(x) for x in nd.ofm),
        float(nd.flops),
        int(nd.groups),
        tuple(int(x) for x in nd.kernel),
        int(nd.stride), int(nd.pad), int(nd.dilation),
        int(nd.batch),
        float(nd.weight_access_frac),
    )


def _adjacency(g: WorkloadGraph) -> Tuple[List[List[int]], List[List[int]]]:
    preds: List[List[int]] = [[] for _ in range(g.n)]
    succs: List[List[int]] = [[] for _ in range(g.n)]
    for s, d in g.edges:
        preds[d].append(s)
        succs[s].append(d)
    return preds, succs


def _wl_label_rounds(payloads: List[Tuple], preds: List[List[int]],
                     succs: List[List[int]]) -> List[List[str]]:
    """Per-node WL labels for rounds 0.._WL_ROUNDS (round 0 = the pure
    payload label; each later round mixes in the sorted predecessor /
    successor label multisets, direction-aware).  Shared by the exact
    canonical form (which keys on the LAST round) and the similarity
    sketch (which keys on ALL rounds)."""
    n = len(payloads)
    labels = [_h("node", p) for p in payloads]
    rounds = [labels]
    for _ in range(_WL_ROUNDS):
        labels = [_h(labels[i],
                     sorted(labels[p] for p in preds[i]),
                     sorted(labels[s] for s in succs[i]))
                  for i in range(n)]
        rounds.append(labels)
    return rounds


def canonical_form(g: WorkloadGraph):
    """(payloads in canonical order, canonical edges, canonical ring
    width) — the serialization ``canonical_hash`` covers.  Useful in
    tests to see WHY two graphs hash differently."""
    n = g.n
    payloads = [node_payload(nd) for nd in g.nodes]
    preds, succs = _adjacency(g)
    labels = _wl_label_rounds(payloads, preds, succs)[-1]

    # Kahn with a deterministic, structure-only priority.  The original
    # index enters the key ONLY as the final tie-break between true
    # automorphic twins, whose serializations are identical either way.
    indeg = [len(p) for p in preds]
    ready = sorted((labels[i], payloads[i], i) for i in range(n)
                   if indeg[i] == 0)
    order: List[int] = []
    while ready:
        _, _, i = ready.pop(0)
        order.append(i)
        added = False
        for s in succs[i]:
            indeg[s] -= 1
            if indeg[s] == 0:
                ready.append((labels[s], payloads[s], s))
                added = True
        if added:
            ready.sort()
    assert len(order) == n, "cycle in workload graph"

    inv = [0] * n
    for new, old in enumerate(order):
        inv[old] = new
    canon_nodes = tuple(payloads[i] for i in order)
    canon_edges = tuple(sorted((inv[s], inv[d]) for s, d in g.edges))

    # release-ring width of the canonical order (simulator W)
    last = list(range(n))
    for s, d in canon_edges:
        last[s] = max(last[s], d)
    ring = max(last[i] - i for i in range(n)) + 1 if n else 0
    return canon_nodes, canon_edges, ring


def canonical_hash(g: WorkloadGraph) -> str:
    """Exact-match cache key: 64-hex sha256 of the canonical form."""
    nodes, edges, ring = canonical_form(g)
    return _h("workload-graph", len(nodes), nodes, edges, ring)


# ------------------------------------------------------------------ sketch
def _minhash(label: str, round_idx: int, slot: int) -> int:
    d = hashlib.blake2b(f"{round_idx}|{slot}|{label}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(d, "big")


def wl_sketch(g: WorkloadGraph,
              slots: int = _SKETCH_SLOTS) -> Tuple[int, ...]:
    """Similarity signature: ``slots`` independent minhashes of the WL
    label SET of every round (rounds 0.._WL_ROUNDS), concatenated —
    ``(_WL_ROUNDS + 1) * slots`` 64-bit ints.  Invariant under node
    relabeling (a label set does not see node order); a one-node payload
    perturbation leaves most slots untouched (round 0 changes one set
    element; round r only relabels the radius-r neighborhood), so
    near-identical graphs agree on most slots and structurally different
    graphs on ~none."""
    payloads = [node_payload(nd) for nd in g.nodes]
    preds, succs = _adjacency(g)
    sig: List[int] = []
    for r, labels in enumerate(_wl_label_rounds(payloads, preds, succs)):
        uniq = sorted(set(labels))
        for j in range(slots):
            sig.append(min((_minhash(lab, r, j) for lab in uniq),
                           default=0))
    return tuple(sig)


def sketch_similarity(a: Sequence[int], b: Sequence[int]) -> float:
    """Fraction of agreeing sketch slots — an unbiased estimate of the
    average per-round Jaccard similarity of the WL label sets."""
    if len(a) != len(b) or not a:
        return 0.0
    return sum(x == y for x, y in zip(a, b)) / len(a)


class SketchIndex:
    """Banded-LSH index over WL sketches: ``add`` buckets a signature by
    bands of ``_BAND_ROWS`` consecutive slots; ``query`` unions the
    band buckets that match the probe and re-ranks the candidates by
    exact ``sketch_similarity`` (ties broken by sorted key, so lookups
    are deterministic).  A band matches when ALL its rows agree, so with
    per-slot agreement s the probe finds a stored near-neighbor with
    probability 1 - (1 - s^rows)^bands — ~1 for the one-resized-layer
    case, ~0 for unrelated graphs.  ``group`` partitions the index
    (the placement service groups by size class, so a neighbor always
    shares the probe's canonical batch geometry)."""

    def __init__(self, band_rows: int = _BAND_ROWS):
        self.band_rows = int(band_rows)
        self._sigs: Dict[str, Tuple[int, ...]] = {}
        self._groups: Dict[str, object] = {}
        self._buckets: Dict[Tuple[object, int, Tuple[int, ...]],
                            Set[str]] = {}

    def __len__(self) -> int:
        return len(self._sigs)

    def __contains__(self, key: str) -> bool:
        return key in self._sigs

    def _bands(self, sig: Sequence[int]):
        for bi in range(0, len(sig), self.band_rows):
            yield bi, tuple(sig[bi:bi + self.band_rows])

    def add(self, key: str, sig: Sequence[int], group=None) -> None:
        if key in self._sigs:
            return
        sig = tuple(int(x) for x in sig)
        self._sigs[key] = sig
        self._groups[key] = group
        for bi, band in self._bands(sig):
            self._buckets.setdefault((group, bi, band), set()).add(key)

    def items(self):
        """(key, signature, group) triples — for persistence."""
        return [(k, self._sigs[k], self._groups[k]) for k in self._sigs]

    def query(self, sig: Sequence[int], group=None,
              exclude: Sequence[str] = ()
              ) -> Tuple[Optional[str], float]:
        """Best stored near-neighbor of ``sig`` within ``group``:
        (key, similarity), or (None, 0.0) when no band matches."""
        sig = tuple(int(x) for x in sig)
        cands: Set[str] = set()
        for bi, band in self._bands(sig):
            cands |= self._buckets.get((group, bi, band), set())
        cands -= set(exclude)
        best, best_sim = None, 0.0
        for k in sorted(cands):
            s = sketch_similarity(sig, self._sigs[k])
            if s > best_sim:
                best, best_sim = k, s
        return best, best_sim
