#!/usr/bin/env python3
"""Run some phases of ``chip_smoke.py`` on the card, without the rest.

    python3 tools/smoke_phases.py ssd_bwd [flash] [flash_bwd] [ssd] \
        [serve_check] [serve] [serve_new] [serve_encdec] [train_check] [train] \
        [train_ssm] [train_moe] [train_encdec] [train_mesh] [serve_mesh] \
        [shard] [--mesh-runs NAME ...]

Builds the attention and SSD sources, forward and backward (one ``nvcc``
each, in parallel), prints each kernel's registers and spills, then runs
the named phases (``serve``: the serve phase's runs; ``serve_new``: the
serve runs of qwen3-moe-30b-a3b and
chameleon-34b; ``train_ssm``: the train phase of mamba2-780m, then of
zamba2-1.2b; ``train_moe`` and ``train_encdec``: that of
qwen3-moe-30b-a3b and of seamless-m4t-medium; ``train_mesh``: the runs
of ``tools/train_mesh.py`` over the visible cards, one process per
card, each held against its own one-card reference (qwen3-0.6b's alone,
without the train phase's run A; ``--mesh-runs``: only the runs of
those names); ``serve_mesh``: the runs of ``tools/serve_mesh.py``
over the visible cards, each against its own one-card reference (and
qwen3-0.6b's (1, 1) layout bit-equal to the serve phase's qwen3-0.6b
run when ``serve`` ran before it; ``--mesh-runs`` names its runs too);
``shard``:
the search
across several devices, which also builds the GAT and simulator
sources) in the order given, each
printing the JSON lines it prints in the whole script.  For quick checks
of one path; ``chip_smoke.py`` stays the proof of the whole port.
Exits non-zero without CUDA or when a phase fails.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402

PHASES = ("flash", "flash_bwd", "ssd", "ssd_bwd", "serve_check",
          "serve_new", "serve_encdec", "train_check", "train", "train_ssm",
          "train_moe", "train_encdec", "train_mesh", "serve_mesh", "shard",
          "serve")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("phases", nargs="+", choices=PHASES)
    ap.add_argument("--mesh-runs", nargs="*",
                    help="train_mesh: only the runs of these names")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("smoke_phases: no CUDA device")
    from repro_torch import device as rdev
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_scan import ops as sops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.emit({"phase": "device", "nvidia_smi": cs.nvidia_smi(),
             "torch": torch.__version__, "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    rep = build.build(["flash_attention", "flash_attention_bwd", "ssd_scan",
                       "ssd_scan_bwd"]
                      + (["gat_mp", "gat_mp_bwd", "memsim"]
                         if "shard" in args.phases else []))
    cs.emit({"phase": "build", "seconds": time.perf_counter() - t0,
             "kernels": cs.ptxas_kernels(rep)})
    gen = torch.Generator("cuda").manual_seed(0)
    done = {}
    for name in args.phases:
        t0 = time.perf_counter()
        done[name] = run_phase(name, cs, torch, np, rdev, fops, sops, gen,
                               done, args.mesh_runs)
        print(json.dumps({"phase_done": name,
                          "seconds": time.perf_counter() - t0}), flush=True)


def run_phase(name, cs, torch, np, rdev, fops, sops, gen, done,
              mesh_runs=None):
    """Run phase ``name`` of ``chip_smoke.py`` (imported as ``cs``);
    ``done``: what the phases run before it returned (train_mesh takes
    the train phase's run A as its reference when it ran)."""
    if name == "flash":
        cs.phase_flash(torch, fops, gen)
    elif name == "flash_bwd":
        cs.phase_flash_bwd(torch, fops, gen)
    elif name == "ssd":
        cs.phase_ssd(torch, sops, gen)
    elif name == "ssd_bwd":
        cs.phase_ssd_bwd(torch, sops, rdev, gen)
    elif name == "serve_check":
        cs.phase_serve_check(torch, rdev)
    elif name == "serve_new":
        cs.phase_serve(torch, np, rdev, runs=[
            r for r in cs.SERVE_RUNS
            if r[0] in (cs.MOE_TRAIN[0], "chameleon-34b")],
            rerun_first=False)
    elif name == "serve_encdec":
        cs.phase_serve_encdec(torch, np, rdev)
    elif name == "train_check":
        cs.phase_train_check(torch, rdev)
    elif name == "train":
        return cs.phase_train(torch, np, rdev)
    elif name == "train_mesh":
        return cs.phase_train_mesh(torch, np, done.get("train"),
                                   names=mesh_runs)
    elif name == "serve":
        return cs.phase_serve(torch, np, rdev)[2]
    elif name == "serve_mesh":
        return cs.phase_serve_mesh(torch, np, done.get("serve"),
                                   names=mesh_runs)
    elif name == "train_moe":
        cs.phase_train_repeat(torch, np, rdev, cs.MOE_TRAIN[0])
    elif name == "train_encdec":
        cs.phase_train_repeat(torch, np, rdev, cs.ENCDEC_ARCH)
    elif name == "shard":
        from repro_torch.core import egrl
        from repro_torch.graphs import zoo
        cs.phase_shard(torch, np, zoo, egrl, rdev)
    else:
        for arch in cs.TRAIN_SSM:
            cs.phase_train(torch, np, rdev, arch, cs.TRAIN_STEPS,
                           cs.TRAIN_SSM_LAYERS[arch])


if __name__ == "__main__":
    main()
