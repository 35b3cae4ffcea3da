"""Bucket-parallel dispatch: run the BucketedZoo's K per-bucket pipelines
on DIFFERENT devices, so a generation's wall time approaches the slowest
bucket instead of the sum of all buckets.

Counterpart of ``src/repro/distributed/dispatch.py``.  The serial zoo
path (``core.egrl.ZooEGRL``) runs one forward + sample + evaluate
pipeline per size bucket on the primary device, back to back.  The
buckets are independent -- each has its own padded GraphBatch and its
own draws -- so the dispatcher:

1. assigns buckets to devices with a greedy LPT (longest processing
   time first) bin packing over a per-bucket cost model, ``G_k *
   N_max_k^2`` (the GAT forward is attention-bound) until ``measure()``
   replaces the proxy with MEASURED per-bucket pipeline times;
2. stages the immutable per-bucket state (the bucket's GraphBatch and
   its mask) on the assigned devices once, at construction;
3. per generation, copies the population to each bucket's device and
   issues the per-bucket forward, sample and evaluate there; CUDA
   launches do not wait for their device, so the devices overlap
   whatever the one host thread issues ahead of them;
4. copies per-bucket results back to the primary device only where a
   cross-bucket op needs them: the zoo-order reward gather and the EA
   step's bucket-major logits.

The JAX package donates each population replica to its forward; a copy
to another device is a fresh tensor here, so nothing is donated.

Everything is bit-equal to the serial path: the per-bucket functions
are the same, on the same values and the same draws.

Policy (``REPRO_BUCKET_DISPATCH``, or the ``dispatch=`` argument of
``ZooEGRL``):

- ``"auto"`` (default): dispatch when the zoo has K > 1 buckets AND the
  device list holds more than one device; a one-card host keeps the
  serial path.
- ``"async"``: dispatch whenever K > 1, on one device too (the same
  math, the code path under test).
- ``"off"``: always serial.

The dispatcher and the population sharding are either/or: ``ZooEGRL``
builds a dispatcher only when the sharding is inactive.

``autotune_bucket_k`` picks the bucket count: it measures per-bucket
pipeline times on the octave bucketing, fits ``t = c0 + c1 * G * N^2``,
and returns the K whose predicted LPT makespan over the devices is
smallest.  ``REPRO_ZOO_BUCKETS=autotune`` resolves through it
(``graphs.bucketed.build_bucketed_zoo``).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import gnn
from repro_torch.core import params as P_
from repro_torch.device import (DeviceLike, normalize_device, resolve_device,
                                same_type_devices)
from repro_torch.memsim.batch import SCALARS, evaluate_population_zoo
from repro_torch.utils.envpolicy import env_policy


def resolve_dispatch_policy(override: Optional[str] = None) -> str:
    """``REPRO_BUCKET_DISPATCH`` -> "auto" | "off" | "async", fail-loud
    through the shared envpolicy resolver."""
    return env_policy("REPRO_BUCKET_DISPATCH",
                      choices=("auto", "off", "async"),
                      default="auto", override=override)


def _lpt_assign(costs: Sequence[float], n_bins: int) -> List[int]:
    """Greedy longest-processing-time-first bin packing: bin id per
    item.  Deterministic (ties broken by item index, then bin index)."""
    order = sorted(range(len(costs)), key=lambda k: (-costs[k], k))
    load = [0.0] * n_bins
    out = [0] * len(costs)
    for k in order:
        d = min(range(n_bins), key=lambda i: (load[i], i))
        out[k] = d
        load[d] += costs[k]
    return out


def _lpt_makespan(costs: Sequence[float], n_bins: int) -> float:
    """Wall-time estimate of running ``costs`` over ``n_bins`` devices."""
    assign = _lpt_assign(costs, n_bins)
    load = [0.0] * n_bins
    for k, d in enumerate(assign):
        load[d] += costs[k]
    return max(load)


def _block(x: torch.Tensor) -> None:
    """Wait for ``x``'s device (CUDA only: CPU ops have finished when
    they return)."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


class BucketDispatcher:
    """Per-bucket device placement for one BucketedZoo.

    Construct once per ``ZooEGRL``; when ``active`` is False every method
    must be bypassed (``ZooEGRL`` keeps the serial path).  The population
    handed to ``forward`` is one tensor on the primary device (the
    zoo's)."""

    def __init__(self, zoo, *, policy: Optional[str] = None,
                 devices: Optional[Sequence[DeviceLike]] = None):
        self.zoo = zoo
        self.policy = resolve_dispatch_policy(policy)
        devices = same_type_devices(devices, zoo.device)
        self.active = (zoo.n_buckets > 1 and self.policy != "off"
                       and (self.policy == "async" or len(devices) > 1))
        if not self.active:
            return
        self.devices = devices
        self.primary = normalize_device(zoo.device)
        self.bucket_ms: Optional[Dict[int, float]] = None
        self._assign_and_stage()

    # ------------------------------------------------------- placement
    def _cost(self, k: int) -> float:
        """Per-bucket cost: measured pipeline ms when available, else
        the G*N^2 proxy (the GAT forward is attention-bound)."""
        if self.bucket_ms is not None:
            return self.bucket_ms[k]
        b = self.zoo.buckets[k]
        return float(b.n_graphs) * float(b.n_max) ** 2

    def _assign_and_stage(self) -> None:
        """LPT-assign buckets to devices and stage each bucket's
        GraphBatch and mask there.  Re-run by ``measure()`` once real
        timings replace the proxy."""
        zoo = self.zoo
        costs = [self._cost(k) for k in range(zoo.n_buckets)]
        self._bins = _lpt_assign(costs, len(self.devices))
        self.bucket_device = [self.devices[d] for d in self._bins]
        self._staged = tuple(b.to(dev) for b, dev in
                             zip(zoo.buckets, self.bucket_device))
        self._masks = tuple(b.adj > 0 for b in self._staged)

    def device_map(self) -> Dict[int, int]:
        """bucket id -> position of its device in the device list."""
        return {k: d for k, d in enumerate(self._bins)}

    def time_model(self) -> Optional[Dict[int, float]]:
        """Measured per-bucket pipeline ms (None until ``measure``)."""
        return dict(self.bucket_ms) if self.bucket_ms is not None else None

    def _forward(self, k: int, pop: torch.Tensor) -> torch.Tensor:
        b = self._staged[k]
        return gnn.population_logits_zoo(pop, b.feats, self._masks[k],
                                         b.node_mask, b.n_nodes)

    # ------------------------------------------------- per-generation
    def forward(self, pop: torch.Tensor) -> List[torch.Tensor]:
        """The K per-bucket population forwards, each on its bucket's
        device (a copy of ``pop`` goes there first, none where it lies
        already).  Returns per-bucket logits on their bucket devices."""
        return [self._forward(k, pop.to(dev))
                for k, dev in enumerate(self.bucket_device)]

    def sample(self, gumbel: Sequence[torch.Tensor],
               logits: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """Per-bucket action sampling next to the logits, on the serial
        path's per-bucket Gumbel draws (copied to the bucket's device)."""
        return tuple(gnn.sample_actions(lg, g.to(lg.device))
                     for g, lg in zip(gumbel, logits))

    def pull(self, arrays: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Copy per-bucket results back to the primary device so
        cross-bucket ops (concatenations, gathers) see one device."""
        return [a.to(self.primary) for a in arrays]

    def evaluate(self, mappings: Sequence[torch.Tensor],
                 reward_scale: float = 5.0) -> Dict:
        """``evaluate_population_bucketed`` with per-bucket placement:
        each bucket's mappings are evaluated on its device against the
        staged bucket (one simulator launch each), and only the
        per-graph scalars come back to the primary device for the
        zoo-order gather.  The serial path's dict, bit for bit."""
        if len(mappings) != self.zoo.n_buckets:
            raise ValueError(f"{len(mappings)} mapping stacks for "
                             f"{self.zoo.n_buckets} buckets")
        per = [evaluate_population_zoo(self._staged[k],
                                       m.to(dev).contiguous(), reward_scale)
               for k, (m, dev) in enumerate(zip(mappings,
                                                self.bucket_device))]
        out = {key: self.zoo.gather_zoo([r[key].to(self.primary)
                                         for r in per])
               for key in SCALARS}
        out["rectified"] = tuple(r["rectified"] for r in per)
        return out

    # ------------------------------------------------------ time model
    def measure(self, pop: torch.Tensor, *, reward_scale: float = 5.0,
                reps: int = 2, seed: int = 0) -> Dict[int, float]:
        """Per-bucket pipeline times (ms), each bucket alone and waited
        for: copy of ``pop`` -> forward -> sample -> evaluate.  Their sum
        is what the serial path pays per generation; the measured model
        replaces the G*N^2 proxy and the buckets are re-assigned (LPT).
        Recorded per bucket as ``dispatch.bucket<k>_ms`` gauges."""
        gen = torch.Generator(self.primary).manual_seed(seed)
        ms: Dict[int, float] = {}
        with torch.no_grad():
            for k, dev in enumerate(self.bucket_device):
                b = self._staged[k]
                gum = gnn.gumbel((pop.shape[0], b.n_graphs, b.n_max,
                                  P_.N_SUB, P_.N_TIER), gen)

                def run_bucket():
                    lg = self._forward(k, pop.to(dev))
                    acts = gnn.sample_actions(lg, gum.to(dev))
                    r = evaluate_population_zoo(b, acts.contiguous(),
                                                reward_scale)
                    _block(r["reward"])

                run_bucket()                     # warm-up
                t0 = time.perf_counter()
                for _ in range(reps):
                    run_bucket()
                ms[k] = (time.perf_counter() - t0) / reps * 1e3
                obs.gauge(f"dispatch.bucket{k}_ms").set(ms[k])
        self.bucket_ms = ms
        self._assign_and_stage()
        return ms


# ------------------------------------------------------ bucket-K autotune
def fit_time_model(points: Sequence[Tuple[int, int, float]]
                   ) -> Tuple[float, float]:
    """Least-squares fit of ``t_ms = c0 + c1 * G * N^2`` over measured
    per-bucket ``(G, N, ms)`` points.  With a single point the per-call
    overhead c0 is pinned to a small floor so candidate bucketings that
    multiply the call count still pay for it."""
    pts = list(points)
    x = np.asarray([float(g) * float(n) ** 2 for g, n, _ in pts])
    y = np.asarray([t for _, _, t in pts])
    if len(pts) < 2:
        c0 = min(0.05, float(y[0]) / 2)
        c1 = max(float(y[0]) - c0, 1e-9) / max(float(x[0]), 1.0)
        return c0, c1
    a = np.stack([np.ones_like(x), x], axis=1)
    coef, *_ = np.linalg.lstsq(a, y, rcond=None)
    # a degenerate fit (negative overhead or slope) falls back to the
    # through-origin slope with a small overhead floor
    c0, c1 = float(coef[0]), float(coef[1])
    if c0 <= 0 or c1 <= 0:
        c0 = 0.05
        c1 = max(float((y / np.maximum(x, 1.0)).mean()), 1e-9)
    return c0, c1


def predict_bucket_ms(model: Tuple[float, float], g: int, n: int) -> float:
    c0, c1 = model
    return c0 + c1 * float(g) * float(n) ** 2


_AUTOTUNE_CACHE: Dict[tuple, int] = {}
_AUTOTUNE_REPORT: Dict[tuple, Dict] = {}


def _autotune_key(graphs, device, devices) -> tuple:
    dev = normalize_device(resolve_device(device))
    return (tuple(g.n for g in graphs), len(same_type_devices(devices, dev)),
            str(dev))


def autotune_bucket_k(graphs, *, pop: int = 4, reps: int = 2,
                      max_k: int = 8, device: DeviceLike = "cuda",
                      devices: Optional[Sequence[DeviceLike]] = None) -> int:
    """Pick the bucket count K from a MEASURED per-bucket time model
    instead of octave geometry.

    Measures per-bucket pipeline times on ``device`` over the octave
    bucketing (a small probe population), fits the ``c0 + c1*G*N^2``
    model, then scores every distinct assignment for K = 1..max_k by its
    predicted LPT makespan over ``devices`` (default: every visible
    device of ``device``'s type; the sum on one device) and returns the
    argmin K.  Cached per (size signature, device count, device): repeated
    zoo builds in one process measure once; ``autotune_report`` holds
    what the choice rested on."""
    from repro_torch.graphs.bucketed import assign_buckets, build_bucketed_zoo

    key = _autotune_key(graphs, device, devices)
    if key in _AUTOTUNE_CACHE:
        return _AUTOTUNE_CACHE[key]
    sizes, n_dev = key[0], key[1]
    with obs.span("bucket_autotune", graphs=len(sizes), n_dev=n_dev) as sp:
        probe = build_bucketed_zoo(graphs, "auto", device=device)
        measured = _probe_bucket_ms(probe, pop=pop, reps=reps)
        model = fit_time_model(
            [(b.n_graphs, b.n_max, measured[k])
             for k, b in enumerate(probe.buckets)])

        best_k, best_cost = 1, float("inf")
        seen = set()
        for k in range(1, min(len(set(sizes)), max_k) + 1):
            assign = tuple(assign_buckets(sizes, k))
            if assign in seen:
                continue
            seen.add(assign)
            n_buckets = max(assign) + 1
            costs = []
            for bk in range(n_buckets):
                members = [s for s, a in zip(sizes, assign) if a == bk]
                costs.append(predict_bucket_ms(
                    model, len(members), max(members)))
            cost = _lpt_makespan(costs, n_dev)
            if cost < best_cost - 1e-9:
                best_cost, best_k = cost, k
        sp.set(chosen_k=best_k, predicted_ms=round(best_cost, 3),
               c0=round(model[0], 4))
    _AUTOTUNE_CACHE[key] = best_k
    _AUTOTUNE_REPORT[key] = {
        "chosen_k": best_k, "predicted_ms": best_cost, "c0": model[0],
        "c1": model[1], "n_dev": n_dev, "probe_ms": measured,
        "probe_buckets": [(b.n_graphs, b.n_max) for b in probe.buckets]}
    return best_k


def autotune_report(graphs, *, device: DeviceLike = "cuda",
                    devices: Optional[Sequence[DeviceLike]] = None
                    ) -> Optional[Dict]:
    """What ``autotune_bucket_k`` measured and chose for these graphs on
    these devices (None before it ran): the chosen K, its predicted ms,
    the fitted c0 / c1, the probe's per-bucket ms and (G, N_max)."""
    return _AUTOTUNE_REPORT.get(_autotune_key(graphs, device, devices))


def _probe_bucket_ms(zoo, *, pop: int = 4, reps: int = 2,
                     seed: int = 0) -> Dict[int, float]:
    """Per-bucket pipeline timing on the zoo's device, each bucket alone
    and waited for (the autotune probe: relative costs are what the model
    needs)."""
    gen = torch.Generator(zoo.device).manual_seed(seed)
    vec = P_.init_gnn(gen, zoo.n_features)
    pops = vec[None].expand(pop, -1).contiguous()
    ms: Dict[int, float] = {}
    with torch.no_grad():
        for k, b in enumerate(zoo.buckets):
            mask = b.adj > 0
            gum = gnn.gumbel((pop, b.n_graphs, b.n_max, P_.N_SUB, P_.N_TIER),
                             gen)

            def run_bucket():
                lg = gnn.population_logits_zoo(pops, b.feats, mask,
                                               b.node_mask, b.n_nodes)
                acts = gnn.sample_actions(lg, gum).contiguous()
                _block(evaluate_population_zoo(b, acts)["reward"])

            run_bucket()                         # warm-up
            t0 = time.perf_counter()
            for _ in range(reps):
                run_bucket()
            ms[k] = (time.perf_counter() - t0) / reps * 1e3
    return ms
