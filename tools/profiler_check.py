#!/usr/bin/env python3
"""When torch.profiler's short windows lose kernel records.

    python3 tools/profiler_check.py [--seconds 120] [--reps 20]

For ``--seconds`` it profiles, every second or so, ``reps`` back-to-back
launches of the port's simulator kernel (BERT, P = 20), as
``tools/timing.py`` profiles them and, in turn, with the host idle for
50 ms inside the window before the first launch and after the
synchronize.  Halfway it takes one large profile (20,000 elementwise
launches), as chip_smoke.py's profile phase takes one of a whole
generation.  Per window it prints the seconds since the start, the
set-up, the launches recorded (of ``reps``), and the offset in us
between the first recorded kernel's start and the first launch call's
start (a kernel starts after its launch; a negative offset is a clock
offset between the card's timestamps and the host's).  Then per set-up
and half the windows that recorded every launch, and the card's name and
power limit.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")


def window(torch, fn, reps, pad):
    """(launches recorded, offset us) of one profile of ``reps`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad)
    evs = prof.events()
    kern = [e.time_range.start for e in evs
            if e.device_type == DeviceType.CUDA and "memsim_kernel" in e.name]
    calls = [e.time_range.start for e in evs
             if e.device_type == DeviceType.CPU and e.name in LAUNCH_CALLS]
    offset = min(kern) - min(calls) if kern and calls else None
    return len(kern), offset


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=120.0)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        sys.exit("profiler_check: no CUDA device")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.graphs import zoo
    from repro_torch.memsim import compiler, simulator as sim

    g = zoo.bert()
    sg = sim.build_sim_graph(g, "cuda")
    _, ref = compiler.compiler_reference(g)
    maps = torch.randint(0, 3, (20, g.n, 2), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(0)
                         ).int()
    x = torch.zeros(1 << 20, device="cuda")

    def call():
        sim._launch(sg, maps, ref, 5.0)
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    big_done = False
    tally = {}
    while time.perf_counter() - t0 < args.seconds:
        if not big_done and time.perf_counter() - t0 > args.seconds / 2:
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]):
                for _ in range(20000):
                    x.add_(1.0)
                torch.cuda.synchronize()
            big_done = True
        for pad in (0.0, 0.05):
            n, offset = window(torch, call, args.reps, pad)
            half = "after" if big_done else "before"
            t = tally.setdefault(f"pad={pad} {half} the large profile",
                                 [0, 0])
            t[0] += n == args.reps
            t[1] += 1
            print(json.dumps({"s": round(time.perf_counter() - t0, 3),
                              "pad_s": pad, "recorded": n, "of": args.reps,
                              "offset_us": offset}), flush=True)
        for _ in range(500):
            x.add_(1.0)
        torch.cuda.synchronize()
        time.sleep(0.5)
    print(json.dumps({"complete_windows": {k: f"{a} of {b}" for k, (a, b)
                                           in tally.items()}}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
