#!/usr/bin/env python3
"""The dry run of ``chip_smoke.py``'s train_mesh runs, on the CPU.

    python3 tools/dryrun_train_mesh.py [NAME ...]

For each run of ``tools/train_mesh.py`` ``RUNS`` (or those named: e.g.
``qwen3-0.6b granite-3-8b:40``) and each of its layouts, runs one train
step as rank 0 of a fake process group of the layout's size, on meta
tensors, at the run's config, batch and sequence length
(``launch/programs.py`` ``build_cell``, ``distributed/cost.py``
``count_step``), and prints one JSON line: the argument bytes (this
rank's parameter and optimizer shards and its rows), the peak bytes of
the step's intermediates, their sum (the dry run's per-rank bytes, to
set beside a rank's measured peak), the FLOPs and the collectives a
step.  Needs no card.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import train_mesh as tm  # noqa: E402  (puts ROOT and src on the path)


def main(argv=None):
    names = set(sys.argv[1:] if argv is None else argv)
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.distributed.cost import count_step
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.programs import argument_bytes, build_cell
    for run in tm.RUNS:
        if names and run.name not in names:
            continue
        for shape, over in run.layouts:
            t0 = time.perf_counter()
            with fake_world(shape[0] * shape[1]):
                mesh = make_process_mesh(shape, ("data", "model"),
                                         device="meta")
                fn, kwargs, _, _ = build_cell(
                    run.arch, ShapeCfg("train_mesh", run.seq, run.batch,
                                       "train"),
                    mesh, {**run.cut, **over})
                args = argument_bytes(kwargs)
                with count_step() as c:
                    fn(**kwargs)
            s = c.summary()
            print(json.dumps({
                "run": run.name, "layout": tm.tag(shape, over),
                "batch": run.batch, "seq": run.seq,
                "argument_gb": args / 1e9,
                "peak_temp_gb": s["peak_temp_bytes"] / 1e9,
                "per_rank_gb": (args + s["peak_temp_bytes"]) / 1e9,
                "flops": s["flops"], "collectives": s["collectives"],
                "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
