#!/usr/bin/env python3
"""Where the simulator kernel's time goes: SM cycles per phase of its
walk and of its helpers.

    python3 tools/memsim_phases.py [--graphs bert ...] [--P 1 20]

Builds ``src/repro_torch/csrc/memsim.cu`` with the kernel's own flags
and ``-DMEMSIM_PHASE_CYCLES`` into ``build/repro_torch/`` and launches it
in place of the plain build, on the zoo graphs with the mappings of
chip_smoke.py's memsim phase (seed 0).  Block 0 records per phase (a
tile of 64 nodes) the SM cycles (clock64) warp 0 spends walking the
tile and warp 1 spends on its helper work (staging the next tile, the
latency terms and rectified tiers of the last) up to the helpers'
barrier.  Per case it prints both lists, the walk's cycles per node over
the full tiles and the phases where the helpers took longer than the
walk; then the card's name and power limit.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TN = 64                 # nodes per tile, as in csrc/memsim.cu


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--graphs", nargs="+",
                    default=["bert", "moe_transformer", "dense_cnn"])
    ap.add_argument("--P", type=int, nargs="+", default=[1, 20])
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("memsim_phases: no CUDA device")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(1, ROOT)
    from chip_smoke import memsim_mappings
    from repro_torch.graphs import zoo
    from repro_torch.kernels import build
    from repro_torch.memsim import compiler, simulator as sim

    lib_path = build.BUILD_DIR / "phase_cycles_memsim.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build._flags("memsim"),
                    "-DMEMSIM_PHASE_CYCLES", "-o", str(lib_path),
                    str(build.CSRC / "memsim.cu")], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.memsim_evaluate
    fn.argtypes, fn.restype = sim._ARGTYPES, ctypes.c_int
    read = lib.memsim_phase_cycles_read
    read.argtypes, read.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    build.function = lambda *a, **k: fn      # the wrapper's library lookup

    gen = torch.Generator("cuda").manual_seed(0)
    for name in args.graphs:
        g = zoo.WORKLOADS[name]()
        sg = sim.build_sim_graph(g, "cuda")
        _, ref = compiler.compiler_reference(g)
        for P in args.P:
            maps = memsim_mappings(torch, g, compiler.heuristic_mapping, P,
                                   gen)
            sim._launch(sg, maps, ref, 5.0)
            torch.cuda.synchronize()
            nt = -(-g.n // TN)
            cyc = np.zeros(2 * (nt + 1), np.int64)
            if read(cyc.ctypes.data, cyc.size):
                sys.exit("memsim_phases: could not read the cycle counts")
            walk, helpers = cyc[0::2].tolist(), cyc[1::2].tolist()
            full = walk[:g.n // TN]
            print(json.dumps({
                "graph": name, "N": g.n, "P": P, "walk_cycles": walk,
                "helper_cycles": helpers,
                "walk_cycles_per_node": (sum(full) / len(full) / TN
                                         if full else None),
                "phases_helpers_longer": sum(
                    h > w for w, h in zip(walk, helpers))}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
