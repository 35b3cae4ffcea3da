#!/usr/bin/env python3
"""Time the port's attention backward on the card at the training shapes.

    python3 tools/flash_bwd_time.py [--src src] [--reps 20]

``--src`` is the ``src/`` directory of the checkout to time, so two
checkouts (a change and its parent, unpacked with ``git archive``) can
be compared in turns on one card.  Inputs are made on the card from
seed 0, the same for every checkout, in bf16, causal: qwen3-0.6b's
training shape (B 4, S 4096, 8 KV heads x 2 queries of 128) and
zamba2-1.2b's heads at S 4096 (B 1, 32 heads of 64).  Per shape it
prints the time per call of ``flash_attention_bwd`` (the route the
wrapper takes): the profiler's device time, summed over the call's
kernels and per kernel, and CUDA events around ``reps`` back-to-back
calls.  Then the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys

from timing import event_ms, kernel_ms

# (name, B, S, K, G, h)
SHAPES = (("qwen3-0.6b:train", 4, 4096, 8, 2, 128),
          ("zamba2-1.2b:S=4096", 1, 4096, 32, 1, 64))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        sys.exit("flash_bwd_time: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels.flash_attention import ops

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator("cuda").manual_seed(0)
    for name, B, S, K, G, h in SHAPES:
        def draw(*shape):
            return torch.randn(shape, generator=gen, device="cuda").bfloat16()
        q, g = draw(B, S, K, G, h), draw(B, S, K, G, h)
        k, v = draw(B, S, K, h), draw(B, S, K, h)
        out, lse = ops.flash_attention(q, k, v, causal=True, return_lse=True)

        def call():
            ops.flash_attention_bwd(q, k, v, out, lse, g, causal=True)
        # one call a window: windows of several calls at this size have
        # lost launches
        per, tries, counts = kernel_ms(torch, call, 1)
        print(json.dumps({
            "case": name, "B": B, "S": S, "K": K, "G": G, "h": h,
            "src": args.src,
            "device_ms": sum(per.values()) if per else "not measured",
            "device_ms_by_kernel": per, "profiles": tries, "records": counts,
            "ms": event_ms(torch, call, args.reps)}), flush=True)
        del q, k, v, g, out, lse
        torch.cuda.empty_cache()
    print(smi, flush=True)


if __name__ == "__main__":
    main()
