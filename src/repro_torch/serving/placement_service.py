"""Placement-as-a-service: a persistent optimizer server answering
"(arch, shape) -> memory placement" requests.

Counterpart of ``src/repro/serving/placement_service.py``: the same
size classes, canonical-hash cache, WL-sketch nearest-neighbour cache,
miss queue, refinement slots (``off`` / ``step`` / ``thread`` /
``thread:N``), budget autoscaling, persistence, fault isolation,
``stats()`` read from one ``MetricsRegistry`` and ``REPRO_SERVE_*``
knobs (fail-loud).  Read the JAX module's docstring for the design; what
differs here, and why:

- **Device.**  ``device`` (default ``"cuda"``) is where every batch,
  refinement and re-score runs; without CUDA only ``device="cpu"``
  runs, on the kernels' plain versions.  Each refinement is
  ``ZooEGRL(filled, cfg, mode="ea", zoo=batch)`` on one single-bucket
  ``GraphBatch``: per generation one population forward (4 ``gat_mp``
  launches) and one ``memsim_zoo`` launch; a neighbour re-score is one
  ``memsim_zoo`` launch; every compiler reference one ``memsim`` launch.
  The counters ``generations{cls=n<class>}``, ``prior_forwards``,
  ``nn_rescored`` and ``compiler_refs`` count them.
- **Canonical geometry.**  ``n_max`` is the class (it sizes the
  Boltzmann grid, so it shapes the search), graph slots are filled
  cyclically to ``batch_max``, producer and release widths are powers
  of two, as in JAX.  The release ring is the batch's own ring width
  rounded up to a power of two, not the class: JAX pads it to the class
  only to pin one jitted executable per class, the port has no jit, and
  the simulator kernel keeps the ring in shared memory (a ring of 1024
  does not fit).  Ring padding changes no result (``graphs/batch.py``).
- **``thread:N`` equals ``off``.**  As in JAX, every refinement
  warm-starts from the one GNN prior the refinement before it left.  So
  that this prior, and with it every placement, depends on the stream
  and not on timing, a ``thread`` service keeps one refinement in flight
  whatever N is, and ``run`` dispatches at ``off``'s points (``batch_max``
  distinct unclaimed misses, then the rest at the end), each after the
  refinement before it has drained.  An exact miss whose class is
  refining waits for that refinement before it looks up the caches, as
  the commit would have come first in ``off``.  What the worker thread
  buys is that exact hits stream while a refinement runs.  It runs on a
  CUDA stream of its own, synchronised before its slot counts as
  finished.

The placements are deterministic within the port; they are not JAX's
(Philox draws, not threefry).  Everything that does not draw random
numbers (hashes, sketches, size classes, exact-cache hits with ``nn``
off, the compiler fallback, ``_warm_logits`` given a prior) matches the
JAX service.  A directory the JAX service persisted restores here with
its cache, sketch index, class stats and prior, and the other way round.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import os
import threading
import time
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint import manager as ckpt
from repro_torch.core.egrl import EGRLConfig, ZooEGRL
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs.batch import build_graph_batch
from repro_torch.graphs.extract import extract_for
from repro_torch.graphs.graph import WorkloadGraph
from repro_torch.graphs.hashing import SketchIndex, wl_sketch
from repro_torch.memsim.batch import evaluate_zoo
from repro_torch.memsim.compiler import compiler_reference
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.utils.envpolicy import env_policy

_N_CLASS_MIN = 64        # smallest canonical node count
_IN_WIDTH_MIN = 4        # producer-list width floor
_RELEASE_MIN = 4         # release-table width floor
_AUTO_BUDGET = 4         # generations per miss batch
_AUTO_BATCH = 4          # distinct graphs per refinement batch
_NN_THRESHOLD = 0.4      # min sketch similarity for a neighbor
_NN_LOGIT_SCALE = 4.0    # one-hot logit magnitude for mapping seeds
_WEAK_WIN_RATE = 0.5     # egrl win rate below this = weak prior
_AUTOSCALE_FACTOR = 2    # weak classes get factor x base generations
_PERSIST_KEEP = 3        # checkpoints retained per service


def _pow2(x: int, lo: int = 1) -> int:
    return max(lo, 1 << max(0, x - 1).bit_length())


def size_class(n: int) -> int:
    """Canonical padded node count for an ``n``-node graph: the next
    power of two (>= ``_N_CLASS_MIN``), so the whole registry lands in
    a handful of classes."""
    return _pow2(n, _N_CLASS_MIN)


@dataclasses.dataclass(frozen=True)
class PlacementRequest:
    request_id: int
    arch: str               # registry id or paper-workload name
    shape: str              # configs.base.SHAPES key


@dataclasses.dataclass
class PlacementResult:
    request_id: int
    arch: str
    shape: str
    status: str                            # "ok" | "failed"
    cache_hit: bool = False
    nn_hit: bool = False                   # served from a near neighbor
    graph_hash: Optional[str] = None
    mapping: Optional[np.ndarray] = None   # (n, 2) int32 per-op tiers
    speedup: float = 0.0                   # vs the heuristic compiler
    latency_ms: float = 0.0
    source: str = ""          # "egrl" | "compiler" | "neighbor" (ok only)
    error: Optional[str] = None
    wall_ms: float = 0.0                   # time-to-placement

    @property
    def ok(self) -> bool:
        return self.status == "ok"


@dataclasses.dataclass
class _Pending:
    """One queued miss, with everything its eventual commit needs."""
    req: PlacementRequest
    graph: WorkloadGraph
    hash: str
    t0: float
    sketch: Optional[Tuple[int, ...]] = None


class _RefinementSlot:
    """One in-flight size-class refinement (see the JAX class).
    ``prior_vec`` is the warm-start prior fixed at dispatch."""

    def __init__(self, n_class: int, items: List[Tuple[str, WorkloadGraph]],
                 budget: int, idx: int = 0, prior_vec=None):
        self.n_class = n_class
        self.items = items
        self.budget = budget
        self.idx = idx
        self.prior_vec = prior_vec
        self.hashes = frozenset(h for h, _ in items)
        self.result: Optional[Dict[str, dict]] = None
        self.gen: Optional[Iterator] = None          # off / step modes
        self.thread: Optional[threading.Thread] = None   # thread mode

    @property
    def finished(self) -> bool:
        if self.thread is not None and self.thread.is_alive():
            return False
        return self.result is not None

    def wait(self, timeout: Optional[float] = None) -> None:
        if self.thread is not None:
            self.thread.join(timeout)


class PlacementService:
    """Persistent placement server; see the module docstring.

    ``submit`` answers exact hits, neighbor hits and extraction
    failures immediately and queues the remaining misses; ``tick``
    drains/dispatches/advances the refinement slots; ``run`` drives a
    whole request stream (drain at the end, persist if configured)."""

    def __init__(self, seed: int = 0, cache: Optional[str] = None,
                 budget=None, batch=None, pop_size: int = 8,
                 reward_scale: float = 5.0, slots: Optional[str] = None,
                 nn: Optional[str] = None, persist: Optional[str] = None,
                 nn_threshold: float = _NN_THRESHOLD,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.seed = int(seed)
        self.cache_enabled = env_policy(
            "REPRO_SERVE_CACHE", choices=("on", "off"), default="on",
            override=cache) == "on"
        b = env_policy("REPRO_SERVE_BUDGET", choices=("auto",),
                       default="auto", override=budget, int_ok=True)
        self.budget = _AUTO_BUDGET if b == "auto" else int(b)
        self.autoscale = b == "auto"
        m = env_policy("REPRO_SERVE_BATCH", choices=("auto",),
                       default="auto", override=batch, int_ok=True)
        self.batch_max = _AUTO_BATCH if m == "auto" else int(m)
        s = env_policy(
            "REPRO_SERVE_SLOTS", choices=("off", "step", "thread"),
            default="off", override=slots, int_prefixes=("thread",))
        # "thread:N" -> N concurrent worker slots; bare modes get one
        if s.startswith("thread:"):
            self.slots, self.n_slots = "thread", int(s.split(":", 1)[1])
        else:
            self.slots, self.n_slots = s, 1
        self.nn_enabled = self.cache_enabled and env_policy(
            "REPRO_SERVE_NN", choices=("on", "off"), default="on",
            override=nn) == "on"
        self.nn_threshold = float(nn_threshold)
        # path-valued: case-sensitive, so read the env var directly
        # (env_policy lowercases values); empty string means unset
        raw = os.environ.get("REPRO_SERVE_PERSIST", "") \
            if persist is None else persist
        self.persist_dir = str(raw).strip() or None
        self.pop_size = int(pop_size)
        self.reward_scale = float(reward_scale)

        self._cache: Dict[str, dict] = {}      # hash -> placement entry
        self._index = SketchIndex()            # hash -> WL sketch (LSH)
        self._queue: List[_Pending] = []       # misses, arrival order
        self._slots: List[_RefinementSlot] = []   # in dispatch order
        self._slot_seq = 0                     # per-slot span attribution
        self._tls = threading.local()          # worker-local current slot
        self._nbr_seeds: Dict[str, np.ndarray] = {}   # hash -> mapping
        self._last_sketch: Optional[Tuple[int, ...]] = None
        self._class_stats: Dict[int, Tuple[int, int]] = {}  # (wins, n)
        self._prior_vec: Optional[np.ndarray] = None   # continual prior
        self._answered: List[PlacementResult] = []   # drained in submit
        self._persist_step = 0
        # per-service metrics: THE bookkeeping (stats() reads these);
        # pre-created so stats() has stable keys before any traffic
        self.metrics = MetricsRegistry()
        for name in ("served", "hits", "misses", "failed", "ticks",
                     "faults", "evaluator_calls", "nn_hits",
                     "nn_rescored", "compiler_refs", "prior_forwards"):
            self.metrics.counter(name)
        if self.persist_dir:
            self._load_persisted()

    @property
    def evaluator_calls(self) -> int:
        """Refinement batches run (cache hits never increment it)."""
        return self.metrics.counter("evaluator_calls").value

    # ------------------------------------------------------------ intake
    def submit(self, req: PlacementRequest,
               graph: Optional[WorkloadGraph] = None
               ) -> Optional[PlacementResult]:
        """Exact cache hits, neighbor hits and extraction failures come
        back immediately; misses enqueue and return ``None`` (answered
        by a later ``tick``).  ``graph`` injects a pre-built
        ``WorkloadGraph`` instead of extracting ``(arch, shape)``."""
        t0 = time.perf_counter()
        with obs.span("submit", request_id=req.request_id, arch=req.arch,
                      shape=req.shape) as sp:
            try:
                with obs.span("extract", injected=graph is not None):
                    g = graph if graph is not None \
                        else extract_for(req.arch, req.shape)
                with obs.span("hash"):
                    h = g.canonical_hash()
            except Exception as e:  # unknown arch/shape, malformed graph
                sp.set(outcome="fault")
                return self._result(
                    req, None, {"error": f"{type(e).__name__}: {e}"}, t0)
            with obs.span("cache_lookup") as cl:
                entry = self._cache.get(h) if self.cache_enabled else None
                if entry is None and self.slots == "thread":
                    # a miss whose class is refining sees that class's
                    # commit first, as it would in "off" mode
                    self._wait_slots(size_class(g.n))
                    entry = self._cache.get(h) if self.cache_enabled \
                        else None
                cl.set(hit=entry is not None)
            if entry is not None:
                # the hit path never builds a batch, never runs a driver
                self.metrics.counter("hits").inc()
                sp.set(outcome="hit")
                return self._result(req, h, entry, t0, cache_hit=True)
            # exact miss: probe the WL-sketch index for a near-identical
            # cached graph (always emitted so the miss-path taxonomy is
            # complete on every trace, even with the knob off)
            sketch: Optional[Tuple[int, ...]] = None
            with obs.span("nn_lookup", enabled=self.nn_enabled) as nsp:
                if self.nn_enabled:
                    served = self._nn_lookup(req, g, h, t0, nsp)
                    if served is not None:
                        sp.set(outcome="nn_hit")
                        return served
                    sketch = self._last_sketch
            self.metrics.counter("misses").inc()
            sp.set(outcome="miss")
            self._queue.append(_Pending(req, g, h, t0, sketch))
            return None

    def _nn_lookup(self, req: PlacementRequest, g: WorkloadGraph,
                   h: str, t0: float, nsp) -> Optional[PlacementResult]:
        """Probe the sketch index; serve the re-scored neighbor mapping
        if it beats the compiler, else stash it as a warm-start seed for
        the queued refinement.  Returns a result only when serving."""
        n_class = size_class(g.n)
        sketch = wl_sketch(g)
        self._last_sketch = sketch
        nbr_hash, sim = self._index.query(sketch, group=n_class,
                                          exclude=(h,))
        nsp.set(neighbor=nbr_hash is not None, sim=round(sim, 4),
                served=False)
        if nbr_hash is None or sim < self.nn_threshold:
            return None
        nbr = self._cache.get(nbr_hash)
        if nbr is None or "mapping" not in nbr:
            return None
        adapted = self._adapt_mapping(g, nbr["mapping"])
        sp_, lat_ms, rect, ref_ms = self._rescore_neighbor(g, adapted)
        self.metrics.counter("nn_rescored").inc()
        nsp.set(rescored_speedup=round(sp_, 4))
        if sp_ <= 1.0:
            # never worse than the compiler: do NOT serve; refine
            # instead, warm-started from the neighbor's mapping
            self._nbr_seeds[h] = adapted
            return None
        entry = {"mapping": rect, "speedup": sp_, "latency_ms": lat_ms,
                 "ref_latency_ms": ref_ms, "source": "neighbor"}
        self._cache[h] = entry
        self._index.add(h, sketch, group=n_class)
        self.metrics.counter("nn_hits").inc()
        nsp.set(served=True)
        return self._result(req, h, entry, t0, nn=True)

    def _compiler_reference(self, g: WorkloadGraph):
        self.metrics.counter("compiler_refs").inc()
        return compiler_reference(g, self.device)

    def _adapt_mapping(self, g: WorkloadGraph, nbr_map) -> np.ndarray:
        """A neighbor's (possibly padded) mapping fitted to ``g``:
        shared rows copied, tail rows filled from ``g``'s own compiler
        reference.  Always re-scored before use."""
        cmap, _ = self._compiler_reference(g)
        m = np.asarray(cmap, np.int32).copy()
        nbr_map = np.asarray(nbr_map, np.int32)
        k = min(nbr_map.shape[0], g.n)
        m[:k] = nbr_map[:k]
        return m

    def _rescore_neighbor(self, g: WorkloadGraph, mapping: np.ndarray
                          ) -> Tuple[float, float, np.ndarray, float]:
        """Score ``mapping`` on ``g``'s canonical class geometry (one
        simulator zoo launch); returns (speedup, latency_ms, rectified
        (n, 2) mapping, ref_latency_ms).  Invalid mappings score speedup
        0.0, so they can never pass the > 1.0 serve bar."""
        n_class = size_class(g.n)
        _, batch = self._canonical_batch(n_class, [g])
        maps = np.zeros((self.batch_max, n_class, 2), np.int32)
        maps[:, :g.n] = np.clip(mapping[None, :g.n], 0, 2)
        with torch.no_grad():
            res = evaluate_zoo(batch, torch.as_tensor(maps,
                                                      device=self.device),
                               reward_scale=self.reward_scale)
        sp = float(res["speedup"][0])
        lat_ms = float(res["latency"][0]) * 1e3
        ref_ms = float(batch.ref_latency[0]) * 1e3
        rect = res["rectified"][0][:g.n].cpu().numpy().astype(np.int32)
        return sp, lat_ms, rect, ref_ms

    # ------------------------------------------------------- refinement
    def tick(self) -> List[PlacementResult]:
        """One service heartbeat: drain every finished slot (commit to
        the cache + sketch index, answer every queued request they
        cover), dispatch the oldest request's size class when no slot is
        in flight, and advance a non-thread slot (to completion in
        ``off`` mode, by one unit in ``step`` mode).  Never blocks on an
        in-flight ``thread``-mode slot."""
        if not self._queue and not self._slots and not self._answered:
            return []
        with obs.span("tick", queued=len(self._queue)) as sp:
            self.metrics.counter("ticks").inc()
            out = self._take_answered() + self._drain_slots()
            if not self._slots and self._queue:
                self._dispatch()
            for slot in list(self._slots):
                if self.slots == "off":
                    collections.deque(slot.gen, maxlen=0)
                elif self.slots == "step":
                    next(slot.gen, None)
            out += self._drain_slots()
            sp.set(answered=len(out), in_flight=bool(self._slots),
                   slots=len(self._slots))
            return out

    def _take_answered(self) -> List[PlacementResult]:
        out, self._answered = self._answered, []
        return out

    def _wait_slots(self, n_class: Optional[int] = None) -> None:
        """``thread`` mode: wait for the in-flight refinement (of
        ``n_class``, when given) and drain it; its answers go out with
        the next tick."""
        for slot in [s for s in self._slots if s.thread is not None
                     and n_class in (None, s.n_class)]:
            slot.wait()
            self._answered += self._drain_one(slot)

    def _dispatch(self) -> None:
        """Claim up to ``batch_max`` distinct graphs of the OLDEST
        queued request's size class and start a slot for them (called
        with no slot in flight, so nothing queued is claimed yet)."""
        with obs.span("slot_dispatch", mode=self.slots,
                      slot=self._slot_seq) as sp:
            n_class = size_class(self._queue[0].graph.n)
            todo: Dict[str, WorkloadGraph] = {}
            for p in self._queue:
                if size_class(p.graph.n) == n_class \
                        and p.hash not in todo \
                        and len(todo) < self.batch_max:
                    todo[p.hash] = p.graph
            budget = self._budget_for(n_class)
            items = sorted(todo.items())   # hash order: arrival-order
            slot = _RefinementSlot(n_class, items, budget,  # independence
                                   idx=self._slot_seq,
                                   prior_vec=self._prior_vec)
            self._slot_seq += 1
            self._slots.append(slot)
            sp.set(n_class=n_class, graphs=len(items), budget=budget)
            gen = self._guarded_refine(slot)
            if self.slots == "thread":
                slot.thread = threading.Thread(
                    target=self._work, args=(gen,),
                    name=f"refine{slot.idx}-n{n_class}", daemon=True)
                slot.thread.start()
            else:
                slot.gen = gen

    def _work(self, gen) -> None:
        """A ``thread``-mode worker: drain the slot's generator on a CUDA
        stream of its own, and wait for that stream before returning
        (the slot counts as finished only once the thread has ended)."""
        if self.device.type != "cuda":
            collections.deque(gen, maxlen=0)
            return
        stream = torch.cuda.Stream(self.device)
        with torch.cuda.device(self.device), torch.cuda.stream(stream):
            collections.deque(gen, maxlen=0)
        stream.synchronize()

    def _budget_for(self, n_class: int) -> int:
        """Autoscaled generation budget for one dispatch: classes whose
        prior is weak (EGRL won < ``_WEAK_WIN_RATE`` of at least
        ``batch_max`` commits) get ``_AUTOSCALE_FACTOR`` x the base.
        Reads only deterministic commit outcomes."""
        with obs.span("budget_rebalance", n_class=n_class) as sp:
            base = self.budget
            wins, total = self._class_stats.get(n_class, (0, 0))
            weak = total >= self.batch_max \
                and wins < _WEAK_WIN_RATE * total
            budget = base * _AUTOSCALE_FACTOR \
                if (self.autoscale and weak) else base
            hist = self.metrics.histogram("refine_ms", cls=f"n{n_class}")
            sp.set(base=base, budget=budget, wins=wins, commits=total,
                   weak=weak,
                   refine_p50_ms=round(hist.quantile(0.5), 3)
                   if hist.count else 0.0)
            return budget

    def _drain_slots(self) -> List[PlacementResult]:
        """Drain every finished slot, in dispatch order."""
        out: List[PlacementResult] = []
        for slot in [s for s in self._slots if s.finished]:
            out.extend(self._drain_one(slot))
        return out

    def _drain_one(self, slot: _RefinementSlot) -> List[PlacementResult]:
        """Commit a FINISHED slot's results (cache + sketch index +
        class stats, all on the main thread) and answer every queued request they cover, duplicates
        included."""
        with obs.span("slot_drain", n_class=slot.n_class,
                      graphs=len(slot.items), slot=slot.idx) as sp:
            self._slots.remove(slot)
            refined = slot.result or {}
            n_egrl = 0
            for h, entry in refined.items():
                if "error" in entry:
                    continue   # failures are never cached or counted
                src = entry.get("source", "")
                if src in ("egrl", "compiler"):
                    wins, total = self._class_stats.get(slot.n_class,
                                                        (0, 0))
                    self._class_stats[slot.n_class] = (
                        wins + (src == "egrl"), total + 1)
                    n_egrl += src == "egrl"
                if self.cache_enabled:
                    self._cache[h] = entry
            out, keep = [], []
            for p in self._queue:
                entry = refined.get(p.hash)
                if entry is None and self.cache_enabled:
                    entry = self._cache.get(p.hash)
                if entry is None:
                    keep.append(p)
                    continue
                if self.nn_enabled and p.sketch is not None \
                        and "error" not in entry \
                        and p.hash in self._cache:
                    self._index.add(p.hash, p.sketch, group=slot.n_class)
                self._nbr_seeds.pop(p.hash, None)
                out.append(self._result(p.req, p.hash, entry, p.t0))
            self._queue = keep
            sp.set(answered=len(out), egrl=n_egrl)
            return out

    def _refine_overridden(self) -> bool:
        """Tests monkeypatch ``_refine_class``; an overridden unit runs
        un-stepped (one shot) so the patch sees its exact signature."""
        return "_refine_class" in self.__dict__ or \
            type(self)._refine_class is not PlacementService._refine_class

    def _guarded_refine(self, slot: _RefinementSlot):
        """Generator driving one slot to completion with fault
        isolation: a failing class batch is retried one graph at a time
        so only the poisoned graph fails; every span (including the
        error-attributed ``refine_class``) closes before the result
        lands."""
        t0 = time.perf_counter()
        out: Dict[str, dict] = {}
        self._tls.slot = slot
        try:
            if self.slots == "step" and not self._refine_overridden():
                out = yield from self._refine_class_steps(
                    slot.n_class, slot.items, slot.budget)
            else:
                # the refine_class span wraps the CALL (not the body),
                # so a monkeypatched/faulting refinement still closes
                # its span with the exception as an ``error`` attribute
                with obs.span("refine_class", n_class=slot.n_class,
                              graphs=len(slot.items)):
                    out = self._refine_class(slot.n_class, slot.items)
        except Exception as e:
            self.metrics.counter("faults").inc()
            if len(slot.items) == 1:
                h = slot.items[0][0]
                out = {h: {"error": f"{type(e).__name__}: {e}"}}
            else:
                out = {}
                for h, g in slot.items:    # isolate the bad graph
                    try:
                        with obs.span("refine_class",
                                      n_class=slot.n_class,
                                      graphs=1, retry=True):
                            out.update(
                                self._refine_class(slot.n_class,
                                                   [(h, g)]))
                    except Exception as e1:
                        self.metrics.counter("faults").inc()
                        out[h] = {"error": f"{type(e1).__name__}: {e1}"}
        finally:
            self._tls.slot = None
        self.metrics.histogram(
            "refine_ms", cls=f"n{slot.n_class}").observe(
            (time.perf_counter() - t0) * 1e3)
        slot.result = out
        return out

    def _active_budget(self) -> int:
        """Budget of the slot the CALLING thread is refining, else the
        base budget (direct ``_refine_class`` calls)."""
        slot = getattr(self._tls, "slot", None)
        return slot.budget if slot is not None else self.budget

    def _active_prior(self) -> Optional[np.ndarray]:
        """Warm-start prior for the calling thread's slot (fixed at
        dispatch), else the service's prior."""
        slot = getattr(self._tls, "slot", None)
        return slot.prior_vec if slot is not None else self._prior_vec

    def _canonical_batch(self, n_class: int,
                         graphs: List[WorkloadGraph]):
        """Canonical class geometry: ``batch_max`` graph slots (cyclic
        fill; filler results are discarded), ``n_max`` = the class, pow2
        producer / release / ring widths, slot names ``slot<i>``.  Shared
        by refinement and the neighbor re-score."""
        filled = [graphs[i % len(graphs)] for i in range(self.batch_max)]
        arrs = [g.arrays() for g in filled]
        fan = max(1, max((len(p) for a in arrs
                          for p in a["producers_of"]), default=0))
        # bincount of last_consumer bounds the release-table
        # multiplicity
        rel = max(int(np.bincount(
            a["last_consumer"].astype(np.int64), minlength=1).max())
            for a in arrs)
        ring = max(g.ring_width() for g in filled)
        self.metrics.counter("compiler_refs").inc(len(filled))
        batch = build_graph_batch(
            [dataclasses.replace(g, name=f"slot{i}")
             for i, g in enumerate(filled)],
            n_max=n_class, w_max=_pow2(ring),
            in_width=_pow2(fan, _IN_WIDTH_MIN),
            release_width=_pow2(rel, _RELEASE_MIN), device=self.device)
        return filled, batch

    def _assemble(self, n_class: int,
                  items: List[Tuple[str, WorkloadGraph]]):
        """Batch assembly + warm start for one class refinement."""
        hashes = [h for h, _ in items]
        graphs = [g for _, g in items]
        with obs.span("batch_assembly", n_class=n_class,
                      graphs=len(items)):
            filled, batch = self._canonical_batch(n_class, graphs)
            cfg = EGRLConfig(pop_size=self.pop_size,
                             seed=self._batch_seed(hashes),
                             reward_scale=self.reward_scale)
            drv = ZooEGRL(filled, cfg, mode="ea", zoo=batch,
                          device=self.device)
        seeds = {h: self._nbr_seeds[h] for h in hashes
                 if h in self._nbr_seeds}
        prior = self._active_prior()
        # always emitted (warm=False on a class's first batch) so the
        # serve span taxonomy is complete on every trace
        with obs.span("warm_start", warm=prior is not None,
                      nn_seeds=len(seeds)):
            if prior is not None or seeds:
                vec = prior if prior is not None \
                    else drv.best_gnn_vec()
                drv.warm_start(vec, logits=self._warm_logits(
                    drv, n_class, items, seeds, vec, prior is not None))
        return drv, batch

    def _warm_logits(self, drv, n_class: int,
                     items: List[Tuple[str, WorkloadGraph]],
                     seeds: Dict[str, np.ndarray], vec,
                     has_prior: bool) -> np.ndarray:
        """The Boltzmann seeding grid: the GNN prior's posterior logits
        (zeros when there is no prior yet) with one-hot mapping logits
        written into the node rows of every slot whose graph has a
        nearest-neighbor seed."""
        if has_prior:
            self.metrics.counter("prior_forwards").inc()
            base = drv.prior_logits(vec).cpu().numpy().astype(np.float32)
        else:
            base = np.zeros((self.batch_max * n_class, 2, 3), np.float32)
        base = base.reshape(self.batch_max * n_class, 2, 3)
        for slot_i in range(self.batch_max):
            h, g = items[slot_i % len(items)]
            m = seeds.get(h)
            if m is None:
                continue
            idx = np.clip(np.asarray(m[:g.n], np.int64), 0, 2)
            seg = base[slot_i * n_class: slot_i * n_class + n_class]
            rows = np.arange(g.n)
            for d in (0, 1):
                seg[:g.n, d, :] = -_NN_LOGIT_SCALE
                seg[rows, d, idx[:, d]] = _NN_LOGIT_SCALE
        return base

    def _generation(self, drv, n_class: int) -> None:
        self.metrics.counter("generations", cls=f"n{n_class}").inc()
        with torch.no_grad():
            drv.generation()

    def _refine_class(self, n_class: int,
                      items: List[Tuple[str, WorkloadGraph]]
                      ) -> Dict[str, dict]:
        """One short warm-started EGRL refinement over a canonical-grid
        batch; returns {hash: placement entry} for every item.  The
        service's prior becomes the refinement's best genome."""
        budget = self._active_budget()
        drv, batch = self._assemble(n_class, items)
        self.metrics.counter("evaluator_calls").inc()
        with obs.span("evolve", n_class=n_class, generations=budget):
            for _ in range(budget):
                self._generation(drv, n_class)
            self._prior_vec = drv.best_gnn_vec()  # continual warm start
        return self._commit_results(drv, batch, items)

    def _refine_class_steps(self, n_class: int,
                            items: List[Tuple[str, WorkloadGraph]],
                            budget: int):
        """Generation-granular ``_refine_class`` for ``slots=step``: one
        yield per unit of work and no span held across a yield."""
        with obs.span("refine_class", n_class=n_class,
                      graphs=len(items), phase="assemble"):
            drv, batch = self._assemble(n_class, items)
        self.metrics.counter("evaluator_calls").inc()
        yield
        for k in range(budget):
            with obs.span("refine_class", n_class=n_class,
                          graphs=len(items), phase="evolve"):
                with obs.span("evolve", n_class=n_class, generations=1,
                              step=k):
                    self._generation(drv, n_class)
            yield
        self._prior_vec = drv.best_gnn_vec()
        with obs.span("refine_class", n_class=n_class,
                      graphs=len(items), phase="commit"):
            return self._commit_results(drv, batch, items)

    def _commit_results(self, drv, batch,
                        items: List[Tuple[str, WorkloadGraph]]
                        ) -> Dict[str, dict]:
        with obs.span("commit", graphs=len(items)) as commit_sp:
            out = {}
            n_egrl = 0
            ref_lat = batch.ref_latency.cpu().numpy()
            for i, (h, g) in enumerate(items):  # later slots: fillers
                sp = float(drv.best_reward[i]) / self.reward_scale
                ref_ms = float(ref_lat[i]) * 1e3
                if sp > 1.0:   # valid AND beats the heuristic compiler
                    n_egrl += 1
                    out[h] = {
                        "mapping": np.asarray(drv.best_mapping[i],
                                              np.int32),
                        "speedup": sp, "latency_ms": ref_ms / sp,
                        "ref_latency_ms": ref_ms, "source": "egrl",
                    }
                else:
                    # never worse than the compiler: fall back to the
                    # always-valid heuristic reference mapping
                    cmap, _ = self._compiler_reference(g)
                    out[h] = {
                        "mapping": np.asarray(cmap, np.int32),
                        "speedup": 1.0, "latency_ms": ref_ms,
                        "ref_latency_ms": ref_ms, "source": "compiler",
                    }
            commit_sp.set(egrl=n_egrl, compiler=len(items) - n_egrl)
        return out

    def _batch_seed(self, hashes: List[str]) -> int:
        """Content-derived refinement seed: sorted member hashes folded
        with the service seed."""
        m = hashlib.sha256()
        for h in sorted(hashes):
            m.update(h.encode())
            m.update(b",")
        m.update(str(self.seed).encode())
        return int.from_bytes(m.digest()[:4], "little")

    # ---------------------------------------------------------- results
    def _result(self, req: PlacementRequest, h: Optional[str],
                entry: dict, t0: float, cache_hit: bool = False,
                nn: bool = False) -> PlacementResult:
        wall = (time.perf_counter() - t0) * 1e3
        self.metrics.counter("served").inc()
        if "error" in entry:
            self.metrics.counter("failed").inc()
            return PlacementResult(
                request_id=req.request_id, arch=req.arch, shape=req.shape,
                status="failed", cache_hit=cache_hit, graph_hash=h,
                error=entry["error"], wall_ms=wall)
        path = "hit" if cache_hit else ("nn" if nn else "miss")
        self.metrics.histogram("wall_ms", path=path).observe(wall)
        return PlacementResult(
            request_id=req.request_id, arch=req.arch, shape=req.shape,
            status="ok", cache_hit=cache_hit, nn_hit=nn, graph_hash=h,
            mapping=entry["mapping"].copy(), speedup=entry["speedup"],
            latency_ms=entry["latency_ms"],
            source=entry.get("source", ""), wall_ms=wall)

    # ------------------------------------------------------- persistence
    def persist(self) -> Optional[str]:
        """Checkpoint cache + sketch index + GNN prior + class stats to
        ``persist_dir`` (the JAX service's layout); returns the
        checkpoint path, or None when persistence is off."""
        if not self.persist_dir:
            return None
        maps = {h: np.asarray(e["mapping"], np.int32)
                for h, e in self._cache.items()}
        tree: Dict[str, object] = {"maps": maps}
        if self._prior_vec is not None:
            tree["prior"] = np.asarray(self._prior_vec, np.float32)
        extra = {
            "entries": {h: {k: e[k] for k in ("speedup", "latency_ms",
                                              "ref_latency_ms", "source")
                            if k in e}
                        for h, e in self._cache.items()},
            "sketches": {k: list(sig)
                         for k, sig, _ in self._index.items()},
            "groups": {k: grp for k, _, grp in self._index.items()},
            "class_stats": {str(k): list(v)
                            for k, v in self._class_stats.items()},
            "has_prior": self._prior_vec is not None,
            "seed": self.seed,
        }
        self._persist_step += 1
        return ckpt.save(self.persist_dir, self._persist_step, tree,
                         extra=extra, keep=_PERSIST_KEEP)

    def _load_persisted(self) -> None:
        """Restore the latest checkpoint from ``persist_dir`` (no-op on
        an empty/missing directory; fail-loud on a corrupt one).  A
        directory of the JAX service restores too."""
        step = ckpt.latest_step(self.persist_dir)
        if step is None:
            return
        path = os.path.join(self.persist_dir, f"step_{step:08d}")
        if not ckpt.verify(path):
            raise IOError(f"REPRO_SERVE_PERSIST: corrupt checkpoint "
                          f"at {path}")
        data = np.load(os.path.join(path, "arrays.npz"))
        extra = ckpt.load_manifest(self.persist_dir, step)["extra"]
        for h, meta in extra.get("entries", {}).items():
            entry = dict(meta)
            entry["mapping"] = np.asarray(data[f"maps{ckpt.SEP}{h}"],
                                          np.int32)
            self._cache[h] = entry
        groups = extra.get("groups", {})
        for k, sig in extra.get("sketches", {}).items():
            self._index.add(k, [int(x) for x in sig],
                            group=int(groups[k]))
        self._class_stats = {
            int(k): (int(v[0]), int(v[1]))
            for k, v in extra.get("class_stats", {}).items()}
        if extra.get("has_prior") and "prior" in data.files:
            self._prior_vec = np.asarray(data["prior"], np.float32)
        self._persist_step = step

    # ----------------------------------------------------------- driving
    def _distinct_queued(self) -> int:
        """Distinct UNCLAIMED graphs waiting."""
        claimed = {h for s in self._slots for h in s.hashes}
        return len({p.hash for p in self._queue} - claimed)

    def run(self, requests: Iterable[PlacementRequest]
            ) -> List[PlacementResult]:
        """Drive a request stream: submit each request, tick whenever
        ``batch_max`` distinct unclaimed misses wait (in ``thread`` mode
        after the in-flight refinement has drained, so batches form
        where ``off`` forms them), drain at the end, persist if
        configured.  Results come back in completion order (sort by
        ``request_id`` for a per-request view)."""
        out = []
        for req in requests:
            r = self.submit(req)
            if r is not None:
                out.append(r)
            while self._distinct_queued() >= self.batch_max:
                self._wait_slots()
                out.extend(self.tick())
            # thread mode: the answers of a refinement that has finished
            out.extend(self._take_answered() + self._drain_slots())
        out.extend(self.run_until_drained())
        if self.persist_dir:
            self.persist()
        return out

    def run_until_drained(self, max_ticks: int = 1000
                          ) -> List[PlacementResult]:
        """Tick until the queue is empty and no slot is in flight; in
        ``thread`` mode a tick that answered nothing waits for the
        oldest slot, so every iteration makes progress."""
        out = self._take_answered()
        ticks = 0
        while self._queue or self._slots:
            ticks += 1
            assert ticks <= max_ticks, "placement queue is not draining"
            got = self.tick()
            out.extend(got)
            if not got and self._slots and self.slots == "thread":
                self._slots[0].wait()
        return out

    def stats(self) -> dict:
        """Service counters, read straight off the per-service metrics
        registry (one bookkeeping source of truth)."""
        c = {k: self.metrics.counter(k).value
             for k in ("served", "hits", "misses", "failed", "ticks",
                       "faults", "nn_hits")}
        c.update(queued=len(self._queue), cache_size=len(self._cache),
                 evaluator_calls=self.evaluator_calls,
                 hit_rate=c["hits"] / max(c["served"], 1),
                 in_flight=bool(self._slots),
                 slots_in_flight=len(self._slots))
        return c
