#!/usr/bin/env python3
"""Time the port's SSD scan kernel on the card at the served prefill shapes.

    python3 tools/ssd_time.py [--src src] [--reps 50]

``--src`` is the ``src/`` directory of the checkout to time, so two
checkouts (a change and its parent, unpacked with ``git archive``) can
be compared in turns on one card.  Inputs are made on the card from
seed 0, the same for every checkout: the kernel's f32 operands (xd, la,
B, C) of one B = 1 prefill of each served Mamba2 model at each prompt
length the serve runs use (zamba2-1.2b: 256, 512, 1024, 2048 tokens;
mamba2-780m: 1024, 2048; chunk 256).  Per shape it prints the time per
call of the wrapper's launch (``ssd_scan._launch``): the profiler's
device time, summed over every kernel the call launches and per kernel,
and CUDA events around ``reps`` back-to-back calls.  Then the card's
name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys

from timing import event_ms, kernel_ms

# (model, prompt lengths) of chip_smoke.py's SERVE_RUNS that run Mamba2
SERVED = (("zamba2-1.2b", (256, 512, 1024, 2048)),
          ("mamba2-780m", (1024, 2048)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        sys.exit("ssd_time: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.models.mamba2 import _dims

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator("cuda").manual_seed(0)
    for arch, lengths in SERVED:
        cfg = get_config(arch)
        H, hd, N = _dims(cfg)[1], cfg.ssm.head_dim, cfg.ssm.d_state
        for S in lengths:
            x = torch.randn((1, S, H, hd), generator=gen, device="cuda")
            dt = torch.nn.functional.softplus(
                torch.randn((1, S, H), generator=gen, device="cuda"))
            A_log = torch.randn((H,), generator=gen, device="cuda") * 0.3
            Bm = torch.randn((1, S, N), generator=gen, device="cuda")
            Cm = torch.randn((1, S, N), generator=gen, device="cuda")
            xd, la = ops._operands(x, dt, A_log)

            def call():
                ops._launch(xd, la, Bm, Cm, cfg.ssm.chunk, None)
            per, tries, _ = kernel_ms(torch, call, args.reps)
            total = sum(per.values()) if per else "not measured"
            print(json.dumps({"arch": arch, "S": S, "H": H, "hd": hd,
                              "N": N, "Q": min(cfg.ssm.chunk, S),
                              "device_ms": total, "device_ms_by_kernel": per,
                              "profile_tries": tries,
                              "event_ms": event_ms(torch, call,
                                                   2 * args.reps),
                              "src": args.src}), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
