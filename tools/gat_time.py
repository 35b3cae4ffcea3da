#!/usr/bin/env python3
"""Time the port's GAT kernels on the card at the main path's shapes.

    python3 tools/gat_time.py [--src src] [--reps 50]

``--src`` is the ``src/`` directory of the checkout to time, so two
checkouts (a change and its parent, unpacked with ``git archive``) can
be compared in turns on one card.  Inputs are made on the card from
seed 0, the same for every checkout.  Per shape of the BERT search
(the critic's forward and backward at B = 24 over the shared mask; the
four launches of one population forward, P = 16; the actor's backward
levels at B = 1) it prints the time per call of ``gat_mp`` /
``gat_mp_bwd``: the profiler's device time (every kernel the call
launches, summed) and CUDA events around ``reps`` back-to-back calls.
Then one "egrl" BERT generation, after two that fill the replay buffer,
runs under the profiler: the device time and calls of every kernel
whose name holds ``gat_fwd`` or ``gat_bwd``, the device busy time and
the wall time.  Prints one JSON line per reading and the card's name
and power limit.
"""
import argparse
import json
import os
import subprocess
import sys
import time

from timing import device_ms, event_ms, padded_profile


def generation_profile(torch, egrl, zoo):
    from torch.autograd import DeviceType
    algo = egrl.EGRL(zoo.bert(), egrl.EGRLConfig(seed=1), mode="egrl",
                     device="cuda")
    for _ in range(2):
        algo.generation()
    torch.cuda.synchronize()
    with padded_profile() as prof:
        t0 = time.perf_counter()
        algo.generation()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    gat, busy = {}, 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        busy += us
        if "gat_fwd" in e.key or "gat_bwd" in e.key:
            gat[e.key[:60]] = {"calls": e.count, "device_ms": us / 1e3}
    return {"wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
            "trained": "critic_loss" in algo.history[-1], "gat": gat}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        sys.exit("gat_time: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.core import egrl
    from repro_torch.graphs import zoo
    from repro_torch.kernels.gat_mp import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator("cuda").manual_seed(0)
    bert = torch.as_tensor(zoo.bert().adjacency() > 0, device="cuda")

    def pooled(n, B):
        return torch.stack([bert[idx][:, idx] for idx in (
            torch.randperm(388, generator=gen, device="cuda")[:n]
            for _ in range(B))]).contiguous()

    def inputs(B, adj):
        N = adj.shape[-1]
        z = torch.randn((B, N, 128), generator=gen, device="cuda")
        es = torch.randn((B, N, 4), generator=gen, device="cuda")
        ed = torch.randn((B, N, 4), generator=gen, device="cuda")
        return z, es, ed, adj

    shapes = [("fwd", "critic", 24, bert[None]),
              ("fwd", "population:level0", 16, bert[None]),
              ("fwd", "population:level1", 16, pooled(194, 16)),
              ("fwd", "population:level2", 16, pooled(97, 16)),
              ("fwd", "population:level3", 16, pooled(194, 16)),
              ("bwd", "critic", 24, bert[None]),
              ("bwd", "actor:level0", 1, bert[None]),
              ("bwd", "actor:level1", 1, pooled(194, 1)),
              ("bwd", "actor:level2", 1, pooled(97, 1))]
    for which, name, B, adj in shapes:
        z, es, ed, a = inputs(B, adj)
        if which == "fwd":
            def call():
                ops.gat_mp(z, es, ed, a)
        else:
            out, m, l = ops.gat_mp(z, es, ed, a)
            g = torch.randn(z.shape, generator=gen, device="cuda")

            def call():
                ops.gat_mp_bwd(z, es, ed, a, m, l, out, g)
        dev, tries, _ = device_ms(torch, call, args.reps)
        print(json.dumps({"kernel": which, "shape": name, "B": B,
                          "N": adj.shape[-1], "mask_batch": adj.shape[0],
                          "device_ms": dev, "profile_tries": tries,
                          "event_ms": event_ms(torch, call, 4 * args.reps),
                          "src": args.src}), flush=True)
    print(json.dumps({"generation": "bert egrl", "src": args.src,
                      **generation_profile(torch, egrl, zoo)}), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
