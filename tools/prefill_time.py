#!/usr/bin/env python3
"""Time one prefill of a served model of the PyTorch port on the card.

    python3 tools/prefill_time.py [--src src] [--arch qwen3-0.6b] \
        [--lens 1024 2048] [--reps 5]

``--src`` is the ``src/`` directory of the checkout to time, so two
checkouts (a change and its parent, unpacked with ``git archive``) can
be compared in turns on one card.  Per prompt length: the model at its
published config with random weights from seed 0 prefills one prompt
at B = 1 under ``torch.no_grad``; after a warm-up prefill, the host
clock around ``reps`` prefills, each ended by a synchronize (median and
all values, ms); then one more prefill under ``torch.profiler`` gives
the device busy time and the device time of the attention kernels
(every kernel whose name holds ``flash_fwd``).  Prints one JSON line per
length, with the card's name and power limit.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--lens", type=int, nargs="+", default=[1024, 2048])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        sys.exit("prefill_time: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.src))
    from torch.autograd import DeviceType

    from timing import padded_profile
    from repro_torch.configs.registry import get_config
    from repro_torch.models.zoo import get_model

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    cfg = get_config(args.arch)
    model = get_model(cfg)
    model.init(torch.Generator("cuda").manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    for S in args.lens:
        tokens = torch.randint(0, cfg.vocab_size, (1, S),
                               generator=gen).cuda()

        def prefill():
            model.prefill(model.params, tokens, S)

        with torch.no_grad():
            prefill()
            torch.cuda.synchronize()
            ms = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                prefill()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            with padded_profile() as prof:
                prefill()
                torch.cuda.synchronize()
        busy = attn = 0.0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            busy += us
            if "flash_fwd" in e.key:
                attn += us
        print(json.dumps({
            "src": args.src, "arch": cfg.name, "prompt": S, "layers":
            cfg.n_layers, "prefill_ms_median": statistics.median(ms),
            "prefill_ms": ms, "device_busy_ms": busy / 1e3,
            "attention_device_ms": attn / 1e3, "device": smi}), flush=True)


if __name__ == "__main__":
    main()
