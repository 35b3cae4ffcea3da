"""Multi-workload (zoo) EGRL training entry point on the port.

Counterpart of ``src/repro/launch/train_zoo.py``, with the same flags
(plus ``--device``), report schema and CSV lines.  Trains one
population -- with the ``ZooSAC`` member in "egrl" mode -- against
several workloads at once (``core.egrl.ZooEGRL``), then reports the
best speedup per training graph and the zero-shot speedup on held-out
workloads (``evaluate_gnn_zoo``, one launch per size bucket).

    python -m repro_torch.launch.train_zoo --train resnet50 resnet101 \
        --holdout bert --steps 2000 --agg worst --buckets auto
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.core.egrl import EGRLConfig, ZooEGRL, evaluate_gnn_zoo
from repro_torch.device import resolve_device
from repro_torch.graphs.zoo import WORKLOADS


def train_zoo(train, holdout=(), steps: int = 2000, mode: str = "egrl",
              agg: str = None, seed: int = 0, buckets=None, log=print,
              device="cuda"):
    """Train on the ``train`` workloads, score ``holdout`` zero-shot;
    returns (report dict, the trained ZooEGRL)."""
    dev = resolve_device(device)
    algo = ZooEGRL([WORKLOADS[n]() for n in train],
                   EGRLConfig(total_steps=steps, seed=seed),
                   mode=mode, fitness_agg=agg, buckets=buckets, device=dev)
    algo.train(log=log)
    scale = algo.cfg.reward_scale
    report = {
        "train": list(train), "mode": mode, "agg": algo.agg,
        "env_steps": algo.steps, "best_fitness": float(algo.best_fitness),
        "buckets": [
            {"n_max": b.n_max, "w_max": b.w_max, "graphs": list(b.names)}
            for b in algo.zoo.buckets],
        "pad_waste_frac": round(algo.zoo.pad_waste_frac(), 4),
        # reward > 0 means a valid mapping was found: reward = scale x speedup
        "train_best_speedup": {
            name: float(max(algo.best_reward[i], 0.0)) / scale
            for i, name in enumerate(algo.zoo.names)},
    }
    vec = algo.best_gnn_vec()
    if holdout and vec is not None:
        report["zero_shot_speedup"] = evaluate_gnn_zoo(
            [WORKLOADS[n]() for n in holdout], vec, seed=seed, device=dev)
    return report, algo


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--train", nargs="+", default=["resnet50", "resnet101"],
                    choices=list(WORKLOADS))
    ap.add_argument("--holdout", nargs="*", default=["bert"],
                    choices=list(WORKLOADS))
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--mode", default="egrl", choices=["egrl", "ea", "pg"])
    ap.add_argument("--agg", default=None, choices=[None, "mean", "worst"],
                    help="fitness aggregation (default: REPRO_FITNESS_AGG)")
    ap.add_argument("--buckets", default=None,
                    help="size-bucketing policy: auto | off | K "
                         "(default: REPRO_ZOO_BUCKETS)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="experiments/zoo")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-generation progress lines")
    args = ap.parse_args(argv)

    report, _ = train_zoo(args.train, args.holdout, args.steps, args.mode,
                          args.agg, args.seed, args.buckets,
                          log=None if args.quiet else print,
                          device=args.device)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(
        args.out, f"zoo_{'-'.join(args.train)}_{args.mode}.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    # the CSV lines are the script's output: --quiet keeps them
    for name, sp in report["train_best_speedup"].items():
        print(f"train,{name},{sp:.3f}")
    for name, sp in report.get("zero_shot_speedup", {}).items():
        print(f"zero_shot,{name},{sp:.3f}")
    if not args.quiet:
        print(f"report written to {path}")
    return report


if __name__ == "__main__":
    main()
