"""The dry run: each (arch x shape) cell's program run once, as one rank
of the (16, 16) or (2, 16, 16) mesh of H100s, on meta tensors, counting
what a rank holds, computes and sends.

Counterpart of ``src/repro/launch/dryrun.py``.  JAX lowers each cell
for a 256- or 512-chip mesh on XLA:CPU with fake devices and reads the
compiled program: memory, FLOPs, HBM bytes and collective bytes.  Torch
has no HLO, so the port runs the program itself:
- the mesh is ``launch/mesh.py`` ``make_production_mesh(device="meta")``
  over a fake process group of 256 or 512 ranks
  (``torch.testing._internal.distributed.fake_pg``'s ``FakeStore``,
  backend "fake": every collective completes at once and moves no
  data), this process playing rank 0, whose blocks are every rank's
  shapes;
- the inputs are ``launch/programs.py`` ``build_cell``'s meta tensors of
  that rank's blocks, and the program is the train step, the prefill or
  one decode step;
- ``distributed/cost.py`` ``count_step`` counts the run: FLOPs, HBM
  bytes, the peak bytes of the intermediates, every collective.

A record keeps JAX's keys where they mean something here.
``per_device_bytes`` is the argument bytes plus the peak bytes the run
made (its ``memory_analysis``: argument, output, alias and temp bytes,
as JAX's add up), and ``fits_hbm`` holds it against one card's memory.
Dropped: ``cpu_upcast_overhead_bytes``, ``hbm_projected_tpu_bytes`` and
``fits_hbm_tpu_projected``, which correct XLA:CPU's bf16 upcasts (the
port has none), and ``cost_analysis()``'s counts of loop bodies once
(the port runs every trip: its counts are JAX's trip-aware ones).
``lower_s`` / ``compile_s`` become ``run_s``.

Run it on the CPU, no card needed: ``python -m
repro_torch.launch.dryrun --all --mesh single`` (or ``--arch``,
``--shape``, ``--mesh multi|both``, ``--out DIR``).  A cell that fails is
logged as FAIL with its reason and makes ``main`` return 1.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch

from repro_torch.configs.base import SHAPES as SH
from repro_torch.configs.base import supports_shape
from repro_torch.configs.registry import ARCH_IDS, SHAPES, all_cells, \
    get_config
from repro_torch.distributed.cost import count_step
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.programs import argument_bytes, build_cell
from repro_torch.obs.log import get_logger

_log = get_logger("dryrun")

# One card's memory where no card is present: an NVIDIA H100 80GB HBM3
# as `nvidia-smi --query-gpu=memory.total` reads it on the card (81559
# MiB).  JAX's HBM_PER_CHIP is a TPU v5e's 16 GiB and does not carry
# over.
H100_80GB_HBM3_BYTES = 81559 * 2 ** 20


def hbm_per_card() -> int:
    """The card's memory when one is present, else the H100's."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory
    return H100_80GB_HBM3_BYTES


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank
    0, for the block; torn down after it.  Raises if a group is
    already initialised."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run needs its own (fake) process group; "
                           "one is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _leaves(tree):
    """The tensors of a nest of dicts, ParameterDicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _leaves(x)]
    if hasattr(tree, "values"):
        return [t for x in tree.values() for t in _leaves(x)]
    return []


def _storage_bytes(tensors) -> int:
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def run_cell(arch: str, shape: str, multi_pod: bool, outdir=None,
             overrides=None, verbose=True, tag=""):
    n_chips = 512 if multi_pod else 256
    with fake_world(n_chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
        t0 = time.time()
        fn, kwargs, _, _ = build_cell(arch, shape, mesh, overrides)
        args = argument_bytes(kwargs)
        arg_storages = {t.untyped_storage()._cdata
                        for t in _leaves(kwargs)}
        with count_step() as c:
            out = fn(**kwargs)
        run_s = time.time() - t0
        cost = c.summary()
        outs = _leaves(out)
        output = _storage_bytes(outs)
        alias = _storage_bytes([t for t in outs if t.untyped_storage()._cdata
                                in arg_storages])
        del out, outs
    fresh = output - alias
    temp = max(0, cost["peak_temp_bytes"] - fresh)
    per_dev = args + output - alias + temp
    hbm = hbm_per_card()
    coll = cost["collectives"]
    rec = {
        "arch": arch, "shape": shape,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": n_chips,
        "fits_hbm": bool(per_dev <= hbm),
        "hbm_per_card_bytes": int(hbm),
        "per_device_bytes": int(per_dev),
        "memory_analysis": {
            "argument_bytes": int(args),
            "output_bytes": int(output),
            "alias_bytes": int(alias),
            "temp_bytes": int(temp),
        },
        "cost_analysis": {
            "flops_tripaware": cost["flops"],
            "hbm_bytes_tripaware": cost["hbm_bytes"],
            "n_ops": cost["n_ops"],
            "kernel_ops": cost["kernel_ops"],
        },
        "collectives": coll,
        "run_s": round(run_s, 2),
        "overrides": {k: str(v) for k, v in (overrides or {}).items()},
    }
    if verbose:
        _log.info(f"--- {arch} x {shape} on {rec['mesh']} ---")
        _log.info(str(rec["memory_analysis"]))
        _log.info(f"flops {cost['flops']:.3e} hbm bytes "
                  f"{cost['hbm_bytes']:.3e} ({cost['n_ops']} ops)")
        _log.info(f"collective bytes/device: "
                  f"{coll['total_per_device_bytes']:.3e} "
                  f"({coll['n_ops']} ops)")
        _log.info(f"per-device HBM: {per_dev / 2**30:.2f} GiB "
                  f"({'fits' if rec['fits_hbm'] else 'does not fit'} "
                  f"{hbm / 2**30:.2f} GiB)  run {run_s:.1f}s")
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        name = f"{arch}__{shape}__{rec['mesh']}{tag}.json"
        with open(os.path.join(outdir, name), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS) + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true", help="all 40 cells")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    cells = []
    if args.all:
        for a, s, ok, why in all_cells(include_skipped=True):
            if ok:
                cells.append((a, s))
            else:
                _log.info(f"SKIP {a} x {s}: {why}")
    else:
        archs = [args.arch] if args.arch else list(ARCH_IDS)
        shapes = [args.shape] if args.shape else list(SHAPES)
        for a in archs:
            for s in shapes:
                ok, why = supports_shape(get_config(a), SH[s])
                if ok:
                    cells.append((a, s))
                else:
                    _log.info(f"SKIP {a} x {s}: {why}")

    failures = []
    for a, s in cells:
        for mp in meshes:
            try:
                run_cell(a, s, mp, outdir=args.out)
            except Exception as e:  # noqa: BLE001
                failures.append((a, s, mp, repr(e)))
                _log.error(f"FAIL {a} x {s} multi_pod={mp}: {e}")
                traceback.print_exc()
    _log.info(f"{len(cells) * len(meshes) - len(failures)} ok, "
              f"{len(failures)} failed")
    for f_ in failures:
        _log.error(f"  FAILED: {f_}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
