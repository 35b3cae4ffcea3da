"""The port's dry runs for ``tests/test_torch_dryrun.py``, in a process of
their own: the fake process group they run over is process-global.

    python tests/_torch_dryrun_worker.py OUT.json

Writes one JSON object: per family, the smoke config's train and decode
cells on one device with no plan (argument bytes and the step's count);
qwen3-0.6b's train step at (4, 1), B 4, S 4096, full width, over a fake
group of 4 (the count, and ``chip_smoke.step_collectives`` of the
model); a smoke qwen3 train step on a fake (2, 2, 2) pod/data/model
mesh, at more microbatches than a rank's rows; and ``dryrun.main`` over
a cell made to fail (its return code and what it logged).
"""
import contextlib
import io
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, os.path.join(HERE, ".."))

import torch  # noqa: E402

torch.set_num_threads(1)

from repro_torch.configs.base import ShapeCfg  # noqa: E402
from repro_torch.distributed.cost import count_step  # noqa: E402
from repro_torch.launch import dryrun, programs  # noqa: E402
from repro_torch.launch.mesh import make_process_mesh  # noqa: E402

FAMILIES = {"dense": "qwen3-0.6b", "moe": "qwen3-moe-30b-a3b",
            "ssm": "mamba2-780m", "hybrid": "zamba2-1.2b",
            "encdec": "seamless-m4t-medium"}
SMOKE_B, SMOKE_S = 2, 64
# train_mesh's qwen3-0.6b run at (4, 1) (tools/train_mesh.py RUNS)
MESH_B, MESH_S = 4, 4096


def count(arch, shape, mesh, smoke, overrides=None):
    fn, kwargs, _, meta = programs.build_cell(arch, shape, mesh, overrides,
                                              smoke=smoke)
    with count_step() as c:
        fn(**kwargs)
    return {"argument_bytes": programs.argument_bytes(kwargs),
            **c.summary()}, meta


def main(out_path):
    out = {"smoke": {}}
    for fam, arch in FAMILIES.items():
        for kind in ("train", "decode"):
            rec, _ = count(arch, ShapeCfg(kind, SMOKE_S, SMOKE_B, kind),
                           None, True)
            out["smoke"][f"{fam}:{kind}"] = rec
    import chip_smoke
    with dryrun.fake_world(4):
        mesh = make_process_mesh((4, 1), ("data", "model"), device="meta")
        rec, meta = count("qwen3-0.6b",
                          ShapeCfg("train", MESH_S, MESH_B, "train"), mesh,
                          False)
        out["mesh_4x1"] = {**rec, "step_collectives":
                           chip_smoke.step_collectives(meta["model"])}
    with dryrun.fake_world(8):
        mesh = make_process_mesh((2, 2, 2), ("pod", "data", "model"),
                                 device="meta")
        # 4 microbatches of a rank's 2 rows: one row a microbatch
        rec, meta = count("qwen3-0.6b", ShapeCfg("train", SMOKE_S, 8,
                                                 "train"), mesh, True,
                          {"grad_accum_microbatches": 4})
        out["pod"] = {**rec, "batch_axes": meta["plan"].batch_axes}
    # a cell that fails: the multi-pod mesh's, made to raise
    build = dryrun.build_cell

    def failing(arch, shape, mesh, overrides=None):
        if "pod" in mesh.axis_names:
            raise RuntimeError("made to fail")
        return build(arch, shape, mesh, overrides)

    dryrun.build_cell = failing
    log = io.StringIO()
    with contextlib.redirect_stdout(log), contextlib.redirect_stderr(log):
        rc = dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k",
                          "--mesh", "both", "--out",
                          os.path.join(os.path.dirname(out_path), "cells")])
    out["failing"] = {"rc": rc, "log": log.getvalue(),
                      "files": sorted(os.listdir(os.path.join(
                          os.path.dirname(out_path), "cells")))}
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
