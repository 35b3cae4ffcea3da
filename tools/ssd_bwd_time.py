#!/usr/bin/env python3
"""Time kernel F, the SSD scan's backward, on the card at the training
shapes, in variants built from CUDA sources.

    python3 tools/ssd_bwd_time.py [--variant LABEL=SOURCE[:FLAG,...]] ...
                                  [--rounds 2] [--reps 10]

Each variant is a source with the C interface of
``src/repro_torch/csrc/ssd_scan_bwd.cu`` (default: that file, no flags),
compiled by ``nvcc`` with the port's flags, the extra ones given (e.g.
``-DNAME=1``) and ``csrc/`` on the include path, into
``build/ssd_bwd_time/`` (all variants in parallel; each kernel's
registers and spills are printed).  Each runs through
the port's wrapper (``ops._launch_bwd``: the same scratch and
arguments) with its own library.  Inputs: ``chip_smoke``'s two train
cases (zamba2-1.2b with slow decay, mamba2-780m with fast; B 4, S 4096,
chunk 256), seed 0, a random dy and final-state cotangent.  Per case,
the variants run in turns for ``rounds`` rounds; each prints its
largest error against the first variant (over each output's largest
element), whether two launches are bit-equal, the profiler's device ms
a call (summed and per CUDA kernel) and CUDA events' ms a call.  Then
the card's name and power limit.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402
from timing import event_ms, kernel_ms  # noqa: E402

CSRC = os.path.join(ROOT, "src", "repro_torch", "csrc")
OUT = os.path.join(ROOT, "build", "ssd_bwd_time")


def parse_variant(text):
    """LABEL=SOURCE[:FLAG,...] -> (label, source, [flags])."""
    label, _, rest = text.partition("=")
    source, _, flags = rest.partition(":")
    return label, source, [f for f in flags.split(",") if f]


def compile_variant(label, source, flags):
    from repro_torch.kernels import build
    out = os.path.join(OUT, f"{label}.so")
    cmd = [build._nvcc(), *build._flags("ssd_scan_bwd"), *flags,
           f"-I{CSRC}", "-o", out, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{label}: nvcc failed\n{proc.stdout}"
                           f"{proc.stderr}")
    report = cs.ptxas_kernels({label: {"log": proc.stdout + proc.stderr}})
    return out, report.get(label, {})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    variants = [parse_variant(v) for v in args.variant] or [
        ("repo", os.path.join(CSRC, "ssd_scan_bwd.cu"), [])]

    import torch
    if not torch.cuda.is_available():
        sys.exit("ssd_bwd_time: no CUDA device")
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(OUT, exist_ok=True)
    build.build(["ssd_scan"])
    with ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(lambda v: compile_variant(*v), variants))
    fns = {}
    for (label, source, flags), (path, report) in zip(variants, built):
        fn = ctypes.CDLL(path).ssd_scan_bwd
        fn.argtypes = ops._BWD_ARGTYPES
        fn.restype = ctypes.c_int
        fns[label] = fn
        print(json.dumps({"variant": label, "source": source, "flags": flags,
                          "kernels": report}), flush=True)

    real_function = build.function
    gen = torch.Generator("cuda").manual_seed(0)
    try:
        for name, B, S, H, hd, N, chunk, dtype, init, decay in \
                cs.SSD_TRAIN_CASES:
            x, dt, A_log, Bm, Cm, st0 = cs.ssd_inputs(
                torch, gen, B, S, H, hd, N, dtype, init, decay)
            xd, la = ops._operands(x, dt, A_log)
            xd, la = xd.contiguous(), la.contiguous()
            Bf, Cf = Bm.float().contiguous(), Cm.float().contiguous()
            _, _, saved = ops._launch(xd, la, Bf, Cf, chunk, st0, keep=True)
            dy = torch.randn(xd.shape, generator=gen, device="cuda")
            dfinal = torch.randn((B, H, N, hd), generator=gen, device="cuda")
            first = None
            for rnd in range(args.rounds):
                for label, fn in fns.items():
                    build.function = (
                        lambda lib, name, types, _fn=fn: _fn
                        if name == "ssd_scan_bwd"
                        else real_function(lib, name, types))

                    def call():
                        return ops._launch_bwd(xd, la, Bf, Cf, saved, dy,
                                               dfinal, chunk, st0 is not None)
                    got, again = call(), call()
                    torch.cuda.synchronize()
                    row = {"case": name, "variant": label, "round": rnd,
                           "bit_equal": all(
                               a is None or torch.equal(a, b)
                               for a, b in zip(got, again))}
                    if first is None:
                        first = got
                    row["max_rel_err_vs_first"] = max(
                        ((a - b).abs().max() / b.abs().max()).item()
                        for a, b in zip(got, first) if b is not None)
                    del got, again
                    per, tries, counts = kernel_ms(torch, call, args.reps)
                    row.update({
                        "device_ms": sum(per.values()) if per
                        else "not measured",
                        "device_ms_by_kernel": {
                            k.split("::")[-1].split("(")[0]: v
                            for k, v in per.items()},
                        "ms": event_ms(torch, call, args.reps)})
                    print(json.dumps(row), flush=True)
            del first, saved, x, xd, la, dy
            torch.cuda.empty_cache()
    finally:
        build.function = real_function
    print(cs.nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()
