#!/usr/bin/env python3
"""Time EGRL generations of the port on the card, by the host clock.

    python3 tools/egrl_time.py [--src src] [--gens 5]

``--src`` is the ``src/`` directory of the checkout to time, so two
checkouts (a change and its parent, unpacked with ``git archive``) can
be compared in turns on one card.  For BERT in "egrl" and "ea" mode,
seed 1: two generations first (the replay buffer then holds a batch),
then ``--gens`` generations, each ended by a synchronise; beside them
the time of the SAC updates (synchronised before and after) per
gradient step.  Where the checkout has ``ZooEGRL``, the same for the
7-graph zoo ("auto" buckets) in "egrl" mode.  Prints one JSON line per
reading and the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys
import time


def time_generations(torch, algo, gens):
    """(ms per generation, ms per SAC step) over ``gens`` generations
    after two."""
    sac = {"s": 0.0, "steps": 0}
    learner = getattr(algo, "learner", None)
    if learner is not None:
        update = learner.update

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = update(*args, **kwargs)
            torch.cuda.synchronize()
            sac["s"] += time.perf_counter() - t
            sac["steps"] += args[1] if out else 0
            return out
        learner.update = timed
    for _ in range(2):
        algo.generation()
    torch.cuda.synchronize()
    sac["s"], sac["steps"] = 0.0, 0
    ms = []
    for _ in range(gens):
        t = time.perf_counter()
        algo.generation()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    step = sac["s"] * 1e3 / sac["steps"] if sac["steps"] else None
    return ms, step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    ap.add_argument("--gens", type=int, default=5)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("egrl_time: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.core import egrl
    from repro_torch.graphs import zoo
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    runs = [("bert", "egrl"), ("bert", "ea")]
    if hasattr(egrl, "ZooEGRL"):
        runs.append(("zoo7", "egrl"))
    for name, mode in runs:
        cfg = egrl.EGRLConfig(seed=1)
        if name == "zoo7":
            algo = egrl.ZooEGRL([make() for make in zoo.WORKLOADS.values()],
                                cfg, mode=mode, buckets="auto",
                                device="cuda")
        else:
            algo = egrl.EGRL(zoo.WORKLOADS[name](), cfg, mode=mode,
                             device="cuda")
        ms, step = time_generations(torch, algo, args.gens)
        print(json.dumps({"src": args.src, "graph": name, "mode": mode,
                          "generation_ms": ms,
                          "generation_ms_mean": sum(ms) / len(ms),
                          "sac_step_ms": step, "nvidia_smi": smi}),
              flush=True)


if __name__ == "__main__":
    main()
