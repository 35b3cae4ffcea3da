#!/usr/bin/env python3
"""One rank of ``chip_smoke.py``'s train_mesh phase: qwen3-0.6b trained
over the cards of one host, one process per card.

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        tools/train_mesh.py --out DIR

N is 1, 2 or 4.  Joins the NCCL process group (``launch.train``
``init_distributed``: this rank on ``cuda:LOCAL_RANK``), then:

1. rank 0 alone runs ``STEPS`` one-card ``TrainLoop`` steps (mesh None):
   the reference, at the published config (bf16 activations, f32
   parameters, remat "full", AdamW), B ``chip_smoke.TRAIN_BATCH``, S
   ``chip_smoke.TRAIN_SEQ``, seed 0 -- what ``phase_train``'s run A does;
2. every layout of ``LAYOUTS[N]`` (("data", "model") process meshes)
   runs ``STEPS`` steps of a ``TrainLoop(mesh=)`` from the same seed; the
   last one saves a checkpoint at step ``SAVE_AT``;
3. restore onto another layout: loops on ``RESTORES[N]`` (on one card a
   one-card ``TrainLoop``) restore that checkpoint and run step 3.

Per layout each rank records its losses, step ms (host clock; a step
ends when the rank has its loss), launches, peak device memory and the
bytes of its parameter and optimizer shards, then profiles a 4th step
(``profile_step``: device busy and idle, NCCL, GEMM and attention
device ms, the top kernels); rank 0 gathers the
parameters and holds them against the reference (``compare``).  Each
rank writes ``DIR/rank<r>.json``, then checks the gates (``gates``) and
exits non-zero if one misses.
"""
import argparse
import json
import math
import os
import shutil
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402

STEPS = cs.MESH_STEPS
SAVE_AT = 2
LAYOUTS = {1: [(1, 1)], 2: [(2, 1), (1, 2)], 4: [(4, 1), (1, 4), (2, 2)]}
# loops that restore the last layout's checkpoint (None: one card, no
# mesh)
RESTORES = {1: [None], 2: [(2, 1)], 4: [(4, 1), (1, 4)]}
# a layout against the one-card reference.  Losses within LOSS_TOL
# relative: the same bf16 model, its products and f32 sums in another
# order (row-parallel partials summed over ranks, the vocab-parallel
# softmax, cuBLAS choosing its algorithm by row count).  Parameters:
# each element within PARAM_ABS_TOL of the reference's, twice the most
# 3 AdamW steps at this warm-up move one (the learning rates 3e-6, 6e-6
# and 9e-6 sum to 1.8e-5; an update's size is at most about 1, weight
# decay adds 0.1 |p| of it): a layout that lost or scrambled a shard
# misses it by the parameters' own size; and the steps' movement (after
# - before, over every parameter) at a cosine of at least MOVE_COS_MIN
# with the reference's, where a wrong gradient would give ~0 (AdamW's
# first steps move each element by about lr times the sign of its
# gradient, so only gradients within rounding of 0 may turn).  One rank
# runs the one-card ops: bit-equal.
LOSS_TOL = 1e-3
PARAM_ABS_TOL = 4e-5
MOVE_COS_MIN = 0.9


def tag(shape):
    return "one-card" if shape is None else "x".join(map(str, shape))


def compare(torch, full, ref, p0):
    """Per-leaf largest |full - ref| and the movement's cosine."""
    dot = nf = nr = 0.0
    worst = {}
    for n, x in full.items():
        r = ref["params"][n]
        worst[n] = float((x - r).abs().max())
        a, b = (x - p0[n]).double(), (r - p0[n]).double()
        dot += float((a * b).sum())
        nf += float((a * a).sum())
        nr += float((b * b).sum())
    return {"max_abs_param_err": max(worst.values()),
            "worst_leaf": max(worst, key=worst.get),
            "move_cosine": dot / math.sqrt(max(nf * nr, 1e-300))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    import torch
    import torch.distributed as dist
    from repro_torch import device as rdev
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import device_batch
    from repro_torch.distributed import parallel as par
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.train import TrainLoop, init_distributed
    from repro_torch.models.zoo import get_model
    from repro_torch.utils.params import tree_leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = init_distributed("cuda")
    rank, world = dist.get_rank(), dist.get_world_size()
    if world not in LAYOUTS:
        raise ValueError(f"train_mesh runs on 1, 2 or 4 cards, not {world}")
    cfg = get_config(cs.TRAIN_ARCH)
    B, S = cs.TRAIN_BATCH, cs.TRAIN_SEQ
    per_step = cs.step_launches(cfg, True)
    quiet = lambda _: None      # noqa: E731
    out = {"rank": rank, "world": world, "device": str(dev),
           "card": torch.cuda.get_device_name(dev), "layouts": [],
           "restores": []}

    def flat(tree):
        return {n: x.detach() for n, x in tree_leaves(tree)}

    ref = p0 = None
    if rank == 0:
        t0 = time.perf_counter()
        loop = TrainLoop(cfg, global_batch=B, seq=S, device=dev)
        params, _, _ = loop.run(STEPS, log=quiet)
        ref = {"losses": [h["loss"] for h in loop.history],
               "step_ms": [h["ms"] for h in loop.history],
               "checksums": cs.checksum(torch, params),
               "params": {n: x.clone() for n, x in flat(params).items()}}
        del loop, params
        p0 = flat(get_model(cfg).init(torch.Generator(dev).manual_seed(0)))
        torch.cuda.empty_cache()
        out["reference"] = {k: ref[k] for k in ("losses", "step_ms",
                                                "checksums")}
        out["reference"]["seconds"] = time.perf_counter() - t0
    dist.barrier()

    ckpt_dir = os.path.join(ROOT, "build", "train_mesh_ckpt")
    if rank == 0:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    dist.barrier()

    def profile_step(loop, params, state):
        """One more step (the 4th) under the profiler, every rank at
        once: this rank's wall ms (host clock, to its loss), device busy
        ms (the union of its kernels' intervals: NCCL runs on a stream
        of its own, beside the compute) and idle share, and the device
        ms of the NCCL kernels (their transfers and their waits for the
        other ranks), the GEMMs and attention."""
        from torch.autograd import DeviceType
        batch = device_batch(loop.data.batch_at(STEPS), loop.device,
                             loop.mesh, loop.plan.batch_axes if loop.plan
                             else None)
        torch.cuda.synchronize()
        dist.barrier()
        with cs.padded_profile() as prof:
            t0 = time.perf_counter()
            _, _, met = loop.step_fn(params, state, batch, STEPS)
            float(met["loss"])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        # "nccl:<op>" records repeat their kernels' time: left out
        evts = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                and not e.name.startswith("nccl:")]
        kernels, spans = {}, []
        for e in evts:
            ms, n = kernels.get(e.name[:80], (0.0, 0))
            kernels[e.name[:80]] = (ms + e.time_range.elapsed_us() / 1e3,
                                    n + 1)
            spans.append((e.time_range.start, e.time_range.end))
        busy, end = 0.0, None
        for a, b in sorted(spans):
            if end is None or a > end:
                busy, end = busy + (b - a), b
            elif b > end:
                busy, end = busy + (b - end), b

        def by(*words):
            return sum(ms for k, (ms, _) in kernels.items()
                       if any(w in k.lower() for w in words))
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
        return {"wall_ms": wall, "device_busy_ms": busy / 1e3,
                "device_idle_share": 1.0 - busy / 1e3 / wall if spans
                else "not measured",
                "nccl_ms": by("nccl"), "gemm_ms": by("gemm", "cutlass",
                                                      "nvjet", "xmma"),
                "attention_ms": by("flash_"),
                "top_kernels": [{"name": k, "device_ms": ms, "calls": n}
                                for k, (ms, n) in top]}

    def check_against_ref(row, full):
        if rank != 0:
            return
        first = row["steps"][0] - 1
        row["max_rel_loss_err"] = max(
            abs(x - y) / abs(y) for x, y in
            zip(row["losses"], ref["losses"][first:]))
        row.update(compare(torch, full, ref, p0))
        row["checksums"] = cs.checksum(torch, full)
        row["bit_equal_to_reference"] = (
            row["losses"] == ref["losses"][first:]
            and row["checksums"] == ref["checksums"])

    def run(shape, profile=False, **kw):
        """One loop's row, its parameters (gathered) held against the
        reference before a profiled 4th step moves them."""
        mesh = None if shape is None else make_process_mesh(
            shape, ("data", "model"), "cuda")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loop = TrainLoop(cfg, global_batch=B, seq=S, mesh=mesh, device=dev,
                         ckpt_dir=kw.pop("ckpt_dir", None))
        rdev.reset_launch_counts()
        params, state, _ = loop.run(STEPS, log=quiet, **kw)
        torch.cuda.synchronize()
        counts = rdev.launch_counts()
        ms = [h["ms"] for h in loop.history]
        row = {"layout": tag(shape), "steps": [h["step"] for h in
                                               loop.history],
               "losses": [h["loss"] for h in loop.history], "step_ms": ms,
               "median_step_ms": statistics.median(ms[1:] or ms),
               "launches": counts,
               "launches_per_step": {k: v // len(ms) for k, v in
                                     counts.items() if v},
               "peak_memory_bytes": torch.cuda.max_memory_allocated(),
               "param_shard_bytes": sum(x.numel() * x.element_size() for
                                        _, x in tree_leaves(params)),
               "opt_shard_bytes": sum(x.numel() * x.element_size() for
                                      _, x in tree_leaves(state)),
               "seconds": time.perf_counter() - t0}
        row["tokens_per_s"] = B * S / row["median_step_ms"] * 1e3
        full = (flat(params) if mesh is None else flat(par.gather_tree(
            params, loop.model.param_specs(), mesh)))
        check_against_ref(row, full)
        del full
        if profile:
            row["profile"] = profile_step(loop, params, state)
        del loop, params, state
        return row

    save_layout = LAYOUTS[world][-1]
    for shape in LAYOUTS[world]:
        save = shape == save_layout
        out["layouts"].append(run(
            shape, profile=True,
            **({"ckpt_dir": ckpt_dir, "save_every": SAVE_AT} if save
               else {})))
        dist.barrier()
    for shape in RESTORES[world]:
        if shape is None and rank != 0:
            continue
        row = run(shape, ckpt_dir=ckpt_dir)
        row["restored_from"] = tag(save_layout)
        out["restores"].append(row)
    dist.barrier()
    if rank == 0:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    try:
        gates(out, ref, per_step)
    finally:
        dist.destroy_process_group()


def gates(out, ref, per_step):
    """Exactly ``step_launches`` a step on every rank; on rank 0 every
    loss finite and, against the reference, one rank bit-equal and more
    within the tolerances above; a restored loop ran step 3 alone."""
    want = {k: v * STEPS for k, v in per_step.items()}
    for row in out["layouts"]:
        got = {k: v for k, v in row["launches"].items() if v}
        cs.check(got == want, f"train_mesh {row['layout']} rank "
                 f"{out['rank']}: launches {got}, want {want}")
    for row in out["restores"]:
        cs.check(row["steps"] == [STEPS], f"train_mesh restore "
                 f"{row['layout']}: steps {row['steps']}")
    if ref is None:
        return
    cs.check(all(math.isfinite(x) for x in ref["losses"]),
             f"train_mesh reference losses {ref['losses']}")
    for row in out["layouts"] + out["restores"]:
        what = f"train_mesh {row['layout']}"
        if out["world"] == 1:
            cs.check(row["bit_equal_to_reference"],
                     f"{what}: not bit-equal to the one-card run: losses "
                     f"{row['losses']} against {ref['losses']}")
            continue
        cs.check(row["max_rel_loss_err"] <= LOSS_TOL,
                 f"{what}: losses {row['losses']} against {ref['losses']}")
        cs.check(row["max_abs_param_err"] <= PARAM_ABS_TOL,
                 f"{what}: parameter error {row['max_abs_param_err']} in "
                 f"{row['worst_leaf']}")
        cs.check(row["move_cosine"] >= MOVE_COS_MIN,
                 f"{what}: movement cosine {row['move_cosine']}")


if __name__ == "__main__":
    main()
