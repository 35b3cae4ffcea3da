#!/usr/bin/env python3
"""Time the port's simulator kernel on the card on the zoo graphs.

    python3 tools/memsim_time.py [--src src] [--reps 50]

``--src`` is the ``src/`` directory of the checkout to time, so two
checkouts (a change and its parent, unpacked with ``git archive``) can
be compared in turns on one card.  Inputs are made on the card from
seed 0, the same for every checkout: on each of the 7 zoo graphs, P =
1, 9, 20 and 256 mappings (a PG rollout, Greedy-DP's 9 candidates, the
population, a large batch), the first four the compiler's heuristic,
all-HBM, all-CMEM and all-VMEM, the rest random tiers.  Per case it
prints the time per launch of the wrapper's launch
(``simulator._launch``): the profiler's device time (with the number of
profiles taken) and CUDA events around ``reps`` back-to-back launches.
Then the SM clock under load and its maximum, and the card's name and
power limit.
"""
import argparse
import json
import os
import subprocess
import sys

from timing import device_ms, event_ms, sm_clock_mhz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POPULATIONS = (1, 9, 20, 256)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        sys.exit("memsim_time: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    from chip_smoke import memsim_mappings
    from repro_torch.graphs import zoo
    from repro_torch.memsim import compiler, simulator as sim

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator("cuda").manual_seed(0)
    clock = None
    for name, make in zoo.WORKLOADS.items():
        g = make()
        sg = sim.build_sim_graph(g, "cuda")
        _, ref = compiler.compiler_reference(g)
        for P in POPULATIONS:
            maps = memsim_mappings(torch, g, compiler.heuristic_mapping, P,
                                   gen)

            def call():
                sim._launch(sg, maps, ref, 5.0)
            dev, tries, _ = device_ms(torch, call, args.reps)
            print(json.dumps({"graph": name, "N": g.n,
                              "W": sg.ring_init.shape[0],
                              "max_in": sg.in_acts.shape[1], "P": P,
                              "device_ms": dev, "profile_tries": tries,
                              "event_ms": event_ms(torch, call, args.reps),
                              "src": args.src}), flush=True)
            if name == "bert" and P == 20:
                clock = sm_clock_mhz(torch, call)
    print(json.dumps({"sm_clock_mhz": clock[0], "sm_clock_max_mhz": clock[1],
                      "src": args.src}), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
