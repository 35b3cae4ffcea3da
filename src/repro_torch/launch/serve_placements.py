"""Placement-service entry point: drive a seeded synthetic request
stream over the ``configs/`` registry x {train, prefill, decode}
through a persistent ``PlacementService`` and report serving SLOs
(p50/p99 time-to-placement split by cache hit/miss, placements/sec,
hit rate).

The stream is Zipf-weighted over the (arch, shape) catalog — a few hot
pairs dominate, as in a real placement service fronting a model fleet —
and fully seeded, so a run is reproducible end to end (the service
itself is deterministic per stream; see serving/placement_service.py).

Counterpart of ``src/repro/launch/serve_placements.py``, with the same
flags plus ``--device`` (default ``cuda``; ``cpu`` runs the kernels'
plain versions):

    PYTHONPATH=src python -m repro_torch.launch.serve_placements \
        --requests 50 --seed 0 --out experiments/serve.json
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.obs.log import get_logger
from repro_torch.serving.placement_service import (PlacementRequest,
                                                   PlacementResult,
                                                   PlacementService)

_log = get_logger("serve_placements")

# the serving shapes: every registry arch supports all three (long_500k
# is SSM/hybrid-only, so it is not part of the default serving catalog)
SERVE_SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def synthetic_stream(n: int, seed: int = 0,
                     archs: Optional[Sequence[str]] = None,
                     shapes: Sequence[str] = SERVE_SHAPES
                     ) -> List[PlacementRequest]:
    """``n`` seeded requests, Zipf-weighted over the (arch, shape)
    catalog (rank order shuffled by the seed so the hot set is not
    alphabetical)."""
    archs = list(archs) if archs else list(ARCH_IDS)
    pairs = [(a, s) for a in archs for s in shapes]
    rng = np.random.default_rng(seed)
    ranks = rng.permutation(len(pairs))
    w = 1.0 / (1.0 + ranks)
    w /= w.sum()
    idx = rng.choice(len(pairs), size=n, p=w)
    return [PlacementRequest(i, *pairs[j]) for i, j in enumerate(idx)]


def _pct(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


def slo_summary(results: List[PlacementResult]) -> dict:
    """Serving SLOs of one result set: time-to-placement percentiles
    split by cache hit/miss, hit rate, and placement quality."""
    ok = [r for r in results if r.ok]
    hits = [r.wall_ms for r in ok if r.cache_hit]
    nn = [r.wall_ms for r in ok if r.nn_hit]
    misses = [r.wall_ms for r in ok if not r.cache_hit and not r.nn_hit]
    return {
        "requests": len(results),
        "ok": len(ok),
        "failed": len(results) - len(ok),
        "cache_hits": len(hits),
        "nn_hits": len(nn),
        "cache_misses": len(misses),
        "hit_rate": round(len(hits) / max(len(ok), 1), 4),
        "hit_p50_ms": round(_pct(hits, 50), 3),
        "hit_p99_ms": round(_pct(hits, 99), 3),
        "nn_p50_ms": round(_pct(nn, 50), 3),
        "miss_p50_ms": round(_pct(misses, 50), 3),
        "miss_p99_ms": round(_pct(misses, 99), 3),
        "egrl_frac": round(float(np.mean(
            [r.source == "egrl" for r in ok])) if ok else 0.0, 4),
        "mean_speedup": round(float(np.mean(
            [r.speedup for r in ok])) if ok else 0.0, 4),
    }


def serve(requests: List[PlacementRequest], seed: int = 0,
          cache: Optional[str] = None, budget=None, batch=None,
          pop_size: int = 8, slots: Optional[str] = None,
          nn: Optional[str] = None, persist: Optional[str] = None,
          device="cuda", log=_log.info):
    """Run a request stream through a fresh service on ``device``;
    returns (results, summary dict incl. service stats + throughput,
    service).  ``log=None`` silences the SLO lines (bench mode)."""
    t0 = time.perf_counter()
    svc = PlacementService(seed=seed, cache=cache, budget=budget,
                           batch=batch, pop_size=pop_size, slots=slots,
                           nn=nn, persist=persist, device=device)
    results = svc.run(requests)
    wall = time.perf_counter() - t0
    summary = slo_summary(results)
    summary.update(
        placements_per_sec=round(len(results) / wall, 3),
        wall_s=round(wall, 2),
        archs=len({r.arch for r in requests}),
        budget=svc.budget, batch_max=svc.batch_max,
        pop_size=svc.pop_size,
        slots=f"{svc.slots}:{svc.n_slots}"
        if svc.n_slots > 1 else svc.slots,
        **{k: v for k, v in svc.stats().items()
           if k in ("evaluator_calls", "cache_size", "ticks")})
    if log:
        log(f"served {summary['ok']}/{summary['requests']} "
            f"({summary['failed']} failed) over {summary['archs']} archs "
            f"in {wall:.1f}s ({summary['placements_per_sec']:.2f}/s)")
        log(f"cache: {summary['cache_hits']} hits / "
            f"{summary['nn_hits']} neighbor hits / "
            f"{summary['cache_misses']} misses "
            f"(rate {summary['hit_rate']:.2f}); time-to-placement "
            f"hit p50/p99 {summary['hit_p50_ms']:.1f}/"
            f"{summary['hit_p99_ms']:.1f} ms, miss p50/p99 "
            f"{summary['miss_p50_ms']:.0f}/{summary['miss_p99_ms']:.0f} ms")
        log(f"quality: mean speedup {summary['mean_speedup']:.3f} "
            f"vs compiler, egrl-sourced {summary['egrl_frac']:.2f}")
    # close the trace with the service's counter/histogram snapshot so
    # trace_report can render it next to the span tree (no-op when off)
    obs.emit_metrics(svc.metrics)
    return results, summary, svc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--requests", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--archs", nargs="*", default=None,
                    help="registry ids (default: all)")
    ap.add_argument("--shapes", nargs="*", default=list(SERVE_SHAPES),
                    choices=list(SHAPES))
    ap.add_argument("--cache", default=None, choices=["on", "off"],
                    help="override REPRO_SERVE_CACHE")
    ap.add_argument("--budget", default=None,
                    help="override REPRO_SERVE_BUDGET (generations)")
    ap.add_argument("--batch", default=None,
                    help="override REPRO_SERVE_BATCH (graphs per batch)")
    ap.add_argument("--slots", default=None,
                    help="override REPRO_SERVE_SLOTS: off | step | "
                         "thread | thread:N (one refinement in "
                         "flight, beside the hits); "
                         "validated fail-loud by the service")
    ap.add_argument("--nn", default=None, choices=["on", "off"],
                    help="override REPRO_SERVE_NN (neighbor cache)")
    ap.add_argument("--persist", default=None,
                    help="override REPRO_SERVE_PERSIST (checkpoint dir)")
    ap.add_argument("--pop", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="write the summary JSON here")
    args = ap.parse_args(argv)

    reqs = synthetic_stream(args.requests, seed=args.seed,
                            archs=args.archs, shapes=args.shapes)
    _, summary, _ = serve(reqs, seed=args.seed, cache=args.cache,
                          budget=args.budget, batch=args.batch,
                          pop_size=args.pop, slots=args.slots,
                          nn=args.nn, persist=args.persist,
                          device=args.device)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
            f.write("\n")
        _log.info(f"summary written to {args.out}")
    return summary


if __name__ == "__main__":
    main()
