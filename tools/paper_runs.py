#!/usr/bin/env python3
"""The paper's Figure 4 and Figure 5 runs on the card, through the port's
entry points.

    python3 tools/paper_runs.py [--fig4-steps 4000] [--fig5-steps 2000]
        [--archs resnet50 resnet101 bert] [--modes egrl ea pg]
        [--skip-fig4] [--skip-fig5]

Figure 4: ``launch.optimize_placement.optimize`` per (arch, mode), seed
0, at the paper's budget (Table 2: 4000 steps).  Figure 5:
``launch.train_zoo.train_zoo`` on resnet50 + resnet101 with bert held
out, "egrl" mode, seed 0.  Each run prints one JSON line: the speedups,
the environment steps, the generations, the wall time by the host clock
(synchronised) and its mean per generation, and the card's name and
power limit.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fig4-steps", type=int, default=4000)
    ap.add_argument("--fig5-steps", type=int, default=2000)
    ap.add_argument("--archs", nargs="+",
                    default=["resnet50", "resnet101", "bert"])
    ap.add_argument("--modes", nargs="+", default=["egrl", "ea", "pg"])
    ap.add_argument("--skip-fig4", action="store_true")
    ap.add_argument("--skip-fig5", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("paper_runs: no CUDA device")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch.optimize_placement import optimize
    from repro_torch.launch.train_zoo import train_zoo
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi()

    runs = [] if args.skip_fig4 else [(a, m) for a in args.archs
                                      for m in args.modes]
    for arch, mode in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan, algo = optimize(arch, "-", args.fig4_steps, mode, seed=0,
                              device="cuda", log=None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        gens = len(algo.history)
        print(json.dumps({
            "figure": 4, "arch": arch, "mode": mode, "seed": 0,
            "steps": args.fig4_steps, "env_steps": algo.steps,
            "speedup": plan["speedup_vs_compiler"],
            "best_speedup_history": algo.history[-1]["best_speedup"],
            "generations": gens, "wall_s": wall,
            "generation_ms_mean": wall * 1e3 / gens,
            "nvidia_smi": smi}), flush=True)

    if not args.skip_fig5:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        report, algo = train_zoo(["resnet50", "resnet101"], ["bert"],
                                 steps=args.fig5_steps, mode="egrl", seed=0,
                                 log=None, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        gens = len(algo.history)
        print(json.dumps({
            "figure": 5, **report, "generations": gens, "wall_s": wall,
            "generation_ms_mean": wall * 1e3 / gens, "nvidia_smi": smi}),
            flush=True)


if __name__ == "__main__":
    main()
