#!/usr/bin/env python3
"""One rank of ``chip_smoke.py``'s train_mesh phase: the port's models
trained over the cards of one host, one process per card.

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        tools/train_mesh.py --out DIR [--runs NAME ...]

Joins the NCCL process group (``launch.train`` ``init_distributed``:
this rank on ``cuda:LOCAL_RANK``), then takes each run of ``RUNS`` made
for a world of N processes (or those named), in order:

1. unless the run has none, rank 0 alone runs ``STEPS`` one-card steps
   (mesh None): the reference, at the run's config (bf16 activations,
   f32 parameters, remat "full", AdamW, the run's depth cut and
   microbatches), B the run's (``chip_smoke.TRAIN_BATCH`` unless it says),
   S the run's, seed 0 -- for qwen3-0.6b what ``phase_train``'s run A
   does; a ``layerwise`` run draws its parameters a layer's slice at a
   time (``draw_params``), each rank keeping its shard, here and below;
2. every layout of the run (("data", "model") process meshes, with the
   run's config overrides, e.g. ``seq_shard_activations``) runs
   ``STEPS`` steps of a ``TrainLoop(mesh=)`` from the same seed (the
   encdec family on ``chip_smoke.encdec_batch``'s batches); the run's
   saving layout saves a checkpoint at step ``SAVE_AT``;
3. restore onto another layout: loops on the run's restore layouts
   (None: a one-card loop) restore that checkpoint and run step 3.

Per layout each rank records its losses, step ms (host clock; a step
ends when the rank has its loss), launches, its FSDP all-gathers and
reduce-scatters over the data axes a step (``parallel.fsdp_counts``:
counts and the largest tensors, against
``chip_smoke.step_collectives``), peak device memory and the bytes of
its parameter and optimizer shards, the token-count all-reduces a
step (``parallel.token_reduces``: one per batch axis over one process
in a masked run's step, none in an unmasked one's), then profiles a 4th
step
(``profile_step``: device busy and idle, NCCL by collective, GEMM,
attention and SSD device ms, the top kernels); rank 0 gathers the
parameters and holds them against the reference (``compare``) and, for
the run's ``pairs``, one layout's against another's.  A ``mask`` run's
batches carry ``instruction_mask``'s loss mask, and each layout also
records ``mask_check``: each rank's token count, the global counts per
microbatch, the first step's loss beside JAX's formula evaluated apart
and the mean of the ranks' own means (the formula the sharded step had
before it took the global counts).  After every run
each rank checks that run's gates (``gate_run``: a later run that fails
cannot hide an earlier one's result), records what missed under
``gates_missed`` and writes ``DIR/rank<r>.json``; it exits non-zero
after the last run if any gate missed.  A rank that raises stops the
world (torchrun ends the others, which would wait in a collective).
"""
import argparse
import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import sys
import time
import zlib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402

STEPS = cs.MESH_STEPS
SAVE_AT = 2
RESID_SEQ = {"seq_shard_activations": True}
GRANITE, GRANITE_BATCH = "granite-3-8b", 16
# a rank's peak at granite-3-8b's 40 layers at (4, 1), reckoned before
# the run: 5 x 8.37 GB (the parameter shards, AdamW's two moments, the
# f32 accumulator and a microbatch's gradients), 2.1 GB of a stacked
# leaf's gradient summed a layer at a time, ~2 GB of one unit gathered,
# its bf16 casts and its gradient, ~4 GB of the two tables gathered, the
# unembedding's f32 copy and their gradients, 1.3 GB of the 40 layers'
# bf16 inputs (one row of 4096), ~1 GB of one unit's recompute and the
# logits' chunks
GRANITE_PEAK_GB = 52.0


@dataclasses.dataclass(frozen=True)
class Run:
    """A model trained on a world of ``cards`` processes: its layouts
    (shape, config overrides), against rank 0's one-card run of the
    same config (``reference``); ``save`` (an index of ``layouts``) saves
    at ``SAVE_AT`` and ``restores`` (shape or None, overrides) restore
    it; ``pairs`` (i, j): layout j also held against layout i.
    ``alone``: the run gets a torchrun launch of its own (a fresh process
    a card, for a run that fills the card).  ``batch``: the global batch;
    ``layerwise``: the parameters drawn a layer's slice at a time
    (``draw_params``), for a model no card holds whole beside its
    optimizer state; ``peak_gb``: a rank's peak memory as reckoned
    before the run (printed beside the reading); ``grad_compression``:
    the reference and every layout step with int8 gradient compression,
    and each layout also holds ``compression_check``; ``mask``: every
    batch carries ``instruction_mask``'s loss mask (``mask_check``)."""
    name: str
    arch: str
    cards: int
    layouts: tuple
    cut: dict = dataclasses.field(default_factory=dict)
    seq: int = cs.TRAIN_SEQ
    reference: bool = True
    save: int = None
    restores: tuple = ()
    pairs: tuple = ()
    alone: bool = False
    batch: int = cs.TRAIN_BATCH
    layerwise: bool = False
    peak_gb: float = None
    grad_compression: bool = False
    mask: bool = False


RUNS = (
    Run("qwen3-0.6b", cs.TRAIN_ARCH, 1, (((1, 1), {}),), save=0,
        restores=((None, {}),)),
    Run("qwen3-0.6b", cs.TRAIN_ARCH, 2, (((2, 1), {}), ((1, 2), {})),
        save=1, restores=(((2, 1), {}),)),
    # Megatron-SP: (1, 4) with the residual stream cut on S, also held
    # against (1, 4) without it
    Run("qwen3-0.6b", cs.TRAIN_ARCH, 4,
        (((4, 1), {}), ((1, 4), {}), ((2, 2), {}), ((1, 4), RESID_SEQ)),
        save=2, restores=(((4, 1), {}), ((1, 4), {})), pairs=((1, 3),)),
    # the split of the other families and SP.  No restores: the
    # checkpoint manager gathers the whole tree (parameters and AdamW's
    # two moments: 7-37 GB here) onto every rank and rank 0 writes it,
    # minutes of four cards a run; qwen3's restores above and the CPU
    # worker's (tests/_torch_mesh_worker.py RESTORES: mamba2, qwen3-moe,
    # seamless) hold the manager's cut onto another layout
    Run("mamba2-780m", "mamba2-780m", 4, (((1, 4), {}), ((2, 2), {}))),
    Run("zamba2-1.2b", "zamba2-1.2b", 4, (((1, 4), {}),)),
    Run("seamless-m4t-medium", cs.ENCDEC_ARCH, 4, (((1, 4), {}),)),
    # expert parallelism: one card's 4-layer cut (cs.MOE_TRAIN) against
    # one card; then the deepest cut that fits, at 32 experts a rank, held
    # to the other gates (no card holds it alone).  A rank peaks at ~7x
    # its parameter shards (the parameters, AdamW's two moments, the
    # gradients, their f32 accumulator and the update's temporaries): 16
    # layers take 74 GB, in a process of their own; 16 is two groups of
    # scan_block (8), so the two-level remat runs.  (No data axis cuts
    # them at (1, 4); FSDP per unit, granite's 40 layers at (4, 1) peak at
    # 5.7x their shards, 47.6 GB on NVIDIA H100 80GB HBM3 at 700 W.)
    Run("qwen3-moe-30b-a3b:4", cs.MOE_TRAIN[0], 4, (((1, 4), {}),),
        cut={"n_layers": cs.MOE_TRAIN[1],
             "grad_accum_microbatches": cs.MOE_TRAIN[2]}),
    Run("qwen3-moe-30b-a3b:16", cs.MOE_TRAIN[0], 4, (((1, 4), {}),),
        cut={"n_layers": 16, "grad_accum_microbatches": cs.MOE_TRAIN[2]},
        reference=False, alone=True),
    # int8 gradient compression under a mesh: each rank its block of the
    # whole leaf's round trip, against one card's compressed run
    Run("qwen3-0.6b:int8", cs.TRAIN_ARCH, 4, (((4, 1), {}), ((2, 2), {})),
        grad_compression=True),
    # 128 experts do not divide 3 cards: each rank all 128, 256 of each
    # expert's 768 d_ff_expert columns (JAX's "mlp_exp"), attention
    # sequence-parallel (32 heads); the 4-layer cut against one card
    Run("qwen3-moe-30b-a3b:4:1x3", cs.MOE_TRAIN[0], cs.SP_RANKS,
        (((1, cs.SP_RANKS), {}),),
        cut={"n_layers": cs.MOE_TRAIN[1],
             "grad_accum_microbatches": cs.MOE_TRAIN[2]}),
    # the SP fallback, 3 cards, cut to 4 of 48 layers (one card holds
    # the reference)
    Run("qwen2.5-14b", "qwen2.5-14b", cs.SP_RANKS,
        (((1, cs.SP_RANKS), {}),), cut={"n_layers": 4}, seq=cs.SP_SEQ),
    # FSDP one unit at a time at granite-3-8b's published widths, B 16
    # and its config's 4 microbatches (one row a microbatch a rank at
    # (4, 1)): 8 of 40 layers (2.0 B parameters, 8.0 GB in f32), as deep
    # as one card holds the reference at ~7x its parameters; then all 40
    # (8.374 B, 33.5 GB), which no card holds with its optimizer state (a
    # rank's reckoned peak: GRANITE_PEAK_GB)
    Run("granite-3-8b:8", GRANITE, 4, (((4, 1), {}), ((2, 2), {})),
        cut={"n_layers": 8}, batch=GRANITE_BATCH, layerwise=True),
    # a loss mask over several batch shards (instruction_mask): JAX's
    # masked mean per global microbatch, against one card's run of the
    # same masked batches; at (4, 1) and (2, 2) beside the unmasked runs'
    Run("qwen3-0.6b:mask", cs.TRAIN_ARCH, 4, (((4, 1), {}), ((2, 2), {})),
        mask=True),
    Run("granite-3-8b:8:mask", GRANITE, 4, (((4, 1), {}), ((2, 2), {})),
        cut={"n_layers": 8}, batch=GRANITE_BATCH, layerwise=True, mask=True),
    Run("granite-3-8b:40", GRANITE, 4, (((4, 1), {}),), batch=GRANITE_BATCH,
        reference=False, alone=True, layerwise=True, peak_gb=GRANITE_PEAK_GB),
)
# a layout against the one-card reference.  Losses within LOSS_TOL
# relative: the same bf16 model, its products and f32 sums in another
# order (row-parallel partials summed over ranks, the vocab-parallel
# softmax, the split norms, cuBLAS choosing its algorithm by row count;
# the MoE's router may then send a near-tied token elsewhere).
# Parameters: each element within PARAM_ABS_TOL of the reference's,
# twice the most 3 AdamW steps at this warm-up move one (the learning
# rates 3e-6, 6e-6 and 9e-6 sum to 1.8e-5; an update's size is at most
# about 1, weight decay adds 0.1 |p| of it): a layout that lost or
# scrambled a shard misses it by the parameters' own size; and the
# steps' movement (after - before), over every parameter and over each
# leaf, at a cosine of at least MOVE_COS_MIN with the reference's, where
# a wrong gradient would give ~0 (AdamW's first steps move each element
# by about lr times the sign of its gradient, so only gradients within
# rounding of 0 may turn; the MoE's experts, whose tokens a near-tied
# router choice can move, read 0.956 at 4 layers).  One rank runs the
# one-card ops: bit-equal.
LOSS_TOL = 1e-3
# a masked run's first loss against JAX's formula evaluated apart on the
# same parameters and batch (``mask_check``): the same bf16 forward, the
# sums in another order
MASK_LOSS_TOL = 1e-5
PARAM_ABS_TOL = 4e-5
MOVE_COS_MIN = 0.9


def seed_of(*parts) -> int:
    """A generator seed from a leaf's name, layer and chunk."""
    return zlib.crc32(":".join(map(str, parts)).encode())


def _scale(d):
    """``utils/params.py`` ``_draw``'s factor of a standard normal draw
    (``d``: the whole leaf's ParamDef)."""
    if d.init == "scaled":
        fan = d.fan_in_axes or tuple(range(len(d.shape) - 1))
        return 1.0 / math.sqrt(max(1, math.prod(d.shape[i] for i in fan)))
    return 0.02 if d.init == "normal" else 1.0


def draw_params(torch, model, seed, dev, specs=None, mesh=None):
    """The model's parameters from ``seed``, leaf by leaf on ``dev``, a
    leaf's rows on its stacked "layer" axis one at a time, each from a
    generator of its own (``seed_of(seed, leaf, layer)``): any depth cut
    of a config draws the same layers, and a rank keeps only its block
    (``specs`` over ``mesh``; the whole leaf without them) of each row."""
    from repro_torch.distributed import parallel as par
    from repro_torch.utils.params import tree_from_flat, tree_leaves
    sp = dict(tree_leaves(specs)) if specs is not None else {}
    out = {}
    for name, d in tree_leaves(model.param_defs()):
        spec = sp.get(name)
        stacked = d.axes[0] == "layer"
        leaf = None
        for i in range(d.shape[0] if stacked else 1):
            shape = d.shape[1:] if stacked else d.shape
            if d.init in ("zeros", "ones"):
                x = (torch.zeros if d.init == "zeros" else torch.ones)(
                    shape, dtype=d.dtype, device=dev)
            else:
                g = torch.Generator(dev).manual_seed(
                    seed_of(seed, name, i if stacked else -1))
                x = (torch.randn(shape, generator=g, device=dev)
                     * _scale(d)).to(d.dtype)
            if spec is not None:
                x = par.shard_leaf(x, spec[1:] if stacked else spec, mesh)
            if not stacked:
                leaf = x
                break
            if leaf is None:        # the rank's leaf, filled a row at a time
                leaf = x.new_empty((d.shape[0],) + tuple(x.shape))
            leaf[i] = x
            del x
        out[name] = leaf
    return tree_from_flat(model.param_defs(), out)


def instruction_mask(B, S, step, seed=0):
    """A loss mask (B, S) f32 for batch ``step``, as instruction tuning
    gives: each row's first P tokens (P uniform in [S/10, 9S/10]) weigh 0
    (the prompt), and a quarter of the rows also their last 10-30 % of
    positions (padding)."""
    import numpy as np
    rng = np.random.default_rng([seed, step, 32])
    mask = np.ones((B, S), np.float32)
    for r in range(B):
        mask[r, :rng.integers(S // 10, 9 * S // 10 + 1)] = 0.0
    for r in rng.choice(B, max(B // 4, 1), replace=False):
        mask[r, S - rng.integers(-(-S // 10), 3 * S // 10 + 1):] = 0.0
    return mask


def runs_for(world, names=None):
    """The runs of a world of ``world`` processes (those named, when
    given)."""
    return [r for r in RUNS if r.cards == world
            and (not names or r.name in names)]


def tag(shape, over=None):
    if shape is None:
        return "one-card"
    return "x".join(map(str, shape)) + ("+resid-seq" if over and over.get(
        "seq_shard_activations") else "")


def run_config(run):
    from repro_torch.configs.registry import get_config
    return get_config(run.arch).replace(**run.cut)


# elements of a leaf compared at once: the MoE's expert leaves hold 0.8 G
# of them, whose f64 copies would not fit beside the run's state
COMPARE_CHUNK = 1 << 24


def compare(full, ref, p0):
    """Per-leaf largest |full - ref|, and the movement's cosine over
    every parameter and per leaf (f64 sums, a chunk of each leaf at a
    time)."""
    worst, sums = {}, {}
    for n, x in full.items():
        x, r, x0 = (t.reshape(-1) for t in (x, ref[n], p0[n]))
        worst[n], s = 0.0, [0.0, 0.0, 0.0]
        for i in range(0, x.numel(), COMPARE_CHUNK):
            sl = slice(i, i + COMPARE_CHUNK)
            worst[n] = max(worst[n], float((x[sl] - r[sl]).abs().max()))
            a, b = (x[sl] - x0[sl]).double(), (r[sl] - x0[sl]).double()
            for j, t in enumerate((a * b, a * a, b * b)):
                s[j] += float(t.sum())
        sums[n] = s

    def cos(dot, nf, nr):
        return dot / math.sqrt(max(nf * nr, 1e-300))
    return {"max_abs_param_err": max(worst.values()),
            "worst_leaf": max(worst, key=worst.get),
            "move_cosine": cos(*map(sum, zip(*sums.values()))),
            "move_cosine_by_leaf": {n: cos(*s) for n, s in sums.items()}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--runs", nargs="*", help="names of RUNS (default: "
                    "every run made for this world size)")
    args = ap.parse_args(argv)
    import torch
    import torch.distributed as dist
    from repro_torch.launch.train import init_distributed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = init_distributed("cuda")
    rank, world = dist.get_rank(), dist.get_world_size()
    runs = runs_for(world, args.runs)
    if not runs:
        raise ValueError(f"train_mesh: no run for {world} cards "
                         f"(names {args.runs})")
    out = {"rank": rank, "world": world, "device": str(dev),
           "card": torch.cuda.get_device_name(dev), "runs": []}
    try:
        for run in runs:
            t0 = time.perf_counter()
            res = train_run(run, rank, dev)
            res.update(name=run.name, arch=run.arch, cards=run.cards,
                       seq=run.seq, batch=run.batch, cut=run.cut,
                       peak_gb=run.peak_gb,
                       seconds=time.perf_counter() - t0)
            res["gates_missed"] = gate_run(res, rank, world)
            out["runs"].append(res)
            free_device(torch)
            dist.barrier()
            # after every run: what a run cut short still has
            with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
                json.dump(out, f)
        missed = {r["name"]: r["gates_missed"] for r in out["runs"]
                  if r["gates_missed"]}
        cs.check(not missed, f"train_mesh rank {rank}: gates missed "
                 f"{missed}")
    finally:
        dist.destroy_process_group()


def train_run(run, rank, dev):
    """One run's reference, layouts and restores on this rank: its
    record (``reference`` on rank 0, ``layouts``, ``restores``)."""
    import torch
    import torch.distributed as dist
    from repro_torch import device as rdev
    from repro_torch.distributed import parallel as par
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.train import TrainLoop
    from repro_torch.models.zoo import get_model
    from repro_torch.utils.params import tree_leaves
    base = run_config(run)
    B, S = run.batch, run.seq
    batches = None
    if base.family == "encdec":     # the encdec train phase's batches
        batches = lambda step: cs.encdec_batch(torch, base, step)  # noqa
        assert (B, S) == (cs.TRAIN_BATCH, cs.TRAIN_SEQ)
    if run.mask:        # TrainLoop's stream (seed 0) and a mask
        from repro_torch.data.pipeline import SyntheticLM
        data = SyntheticLM(base.vocab_size, S, B, seed=0)
        batches = lambda step: dict(data.batch_at(step),  # noqa: E731
                                    mask=instruction_mask(B, S, step))
    quiet = lambda _: None      # noqa: E731
    res = {"launches_per_step_want": cs.step_launches(base, True),
           "layouts": [], "restores": []}

    def flat(tree):
        return {n: x.detach() for n, x in tree_leaves(tree)}

    ref = p0 = None
    if run.reference and rank == 0:
        t0 = time.perf_counter()
        loop = TrainLoop(base, global_batch=B, seq=S, device=dev,
                         batches=batches,
                         grad_compression=run.grad_compression)
        if run.layerwise:
            layerwise_init(torch, loop, dev)
        params, _, _ = loop.run(STEPS, log=quiet)
        ref = {"losses": [h["loss"] for h in loop.history],
               "step_ms": [h["ms"] for h in loop.history],
               "checksums": cs.checksum(torch, params),
               "params": {n: x.clone() for n, x in flat(params).items()}}
        del loop, params
        m0 = get_model(base)
        p0 = flat(draw_params(torch, m0, 0, dev) if run.layerwise else
                  m0.init(torch.Generator(dev).manual_seed(0)))
        del m0
        free_device(torch)
        res["reference"] = {k: ref[k] for k in ("losses", "step_ms",
                                                "checksums")}
        res["reference"]["seconds"] = time.perf_counter() - t0
    dist.barrier()

    ckpt_dir = os.path.join(ROOT, "build", "train_mesh_ckpt")
    if rank == 0:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    dist.barrier()
    kept = {}       # rank 0: the gathered parameters of the pairs' layouts
    keep = {i for pair in run.pairs for i in pair}

    def check_against_ref(row, full):
        first = row["steps"][0] - 1
        row["max_rel_loss_err"] = max(
            abs(x - y) / abs(y) for x, y in
            zip(row["losses"], ref["losses"][first:]))
        row.update(compare(full, ref["params"], p0))
        row["checksums"] = cs.checksum(torch, full)
        row["bit_equal_to_reference"] = (
            row["losses"] == ref["losses"][first:]
            and row["checksums"] == ref["checksums"])

    def one(shape, over, profile=False, gather=True, **kw):
        """One loop's row, its parameters (gathered unless ``gather`` is
        False) held against the reference before a profiled 4th step
        moves them; and the gathered parameters on rank 0."""
        cfg = base.replace(**over)
        mesh = None if shape is None else make_process_mesh(
            shape, ("data", "model"), "cuda")
        free_device(torch)
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loop = TrainLoop(cfg, global_batch=B, seq=S, mesh=mesh, device=dev,
                         ckpt_dir=kw.pop("ckpt_dir", None), batches=batches,
                         grad_compression=run.grad_compression)
        if run.layerwise:
            layerwise_init(torch, loop, dev)
        rdev.reset_launch_counts()
        par.reset_fsdp_counts()
        par.reset_token_reduces()
        params, state, _ = loop.run(STEPS, log=quiet, **kw)
        torch.cuda.synchronize()
        counts = rdev.launch_counts()
        fsdp = par.fsdp_counts()
        token_reduces = par.token_reduces()
        ms = [h["ms"] for h in loop.history]
        row = {"layout": tag(shape, over), "steps": [h["step"] for h in
                                                     loop.history],
               "losses": [h["loss"] for h in loop.history], "step_ms": ms,
               "median_step_ms": statistics.median(ms[1:] or ms),
               "launches": counts,
               "launches_per_step": {k: v // len(ms) for k, v in
                                     counts.items() if v},
               "collectives_per_step": {
                   k: v if "max" in k else v / len(ms)
                   for k, v in fsdp.items()},
               "collectives_per_step_want": cs.step_collectives(loop.model),
               "token_reduces_per_step": token_reduces / len(ms),
               "token_reduces_per_step_want": len(par.live_axes(
                   mesh, loop.plan.batch_axes))
               if run.mask and mesh is not None else 0,
               "peak_memory_bytes": torch.cuda.max_memory_allocated(),
               "held_bytes_before": held,
               "param_shard_bytes": sum(x.numel() * x.element_size() for
                                        _, x in tree_leaves(params)),
               "opt_shard_bytes": sum(x.numel() * x.element_size() for
                                      _, x in tree_leaves(state)),
               "seconds": time.perf_counter() - t0}
        row["tokens_per_s"] = B * S / row["median_step_ms"] * 1e3
        full = None
        if gather:
            full = (flat(params) if mesh is None else flat(par.gather_tree(
                params, loop.model.param_specs(), mesh)))
        if rank != 0:
            full = None
        elif ref is not None:
            check_against_ref(row, full)
        if profile:
            row["profile"] = profile_step(torch, loop, params, state)
        if (run.grad_compression or run.mask) and mesh is not None:
            del params, state
            free_device(torch)
        if run.grad_compression and mesh is not None:
            row["compression_check"] = compression_check(torch, loop.model,
                                                         mesh, dev)
        if run.mask and mesh is not None:
            row["mask_check"] = mask_check(torch, loop, row["losses"][0])
        del loop
        return row, full

    for i, (shape, over) in enumerate(run.layouts):
        save = {"ckpt_dir": ckpt_dir, "save_every": SAVE_AT} \
            if i == run.save else {}
        row, full = one(shape, over, profile=True,
                        gather=run.reference or i in keep, **save)
        if i in keep and full is not None:
            kept[i] = full
        del full
        res["layouts"].append(row)
        dist.barrier()
    for i, j in run.pairs:
        if rank == 0:
            a, b = kept[i], kept[j]
            row = res["layouts"][j]
            row["against"] = res["layouts"][i]["layout"]
            row["against_max_rel_loss_err"] = max(
                abs(x - y) / abs(y) for x, y in
                zip(row["losses"], res["layouts"][i]["losses"]))
            row["against_max_abs_param_err"] = max(
                float((a[n] - b[n]).abs().max()) for n in a)
    kept.clear()
    if run.save is not None:
        for shape, over in run.restores:
            if shape is not None or rank == 0:
                row, full = one(shape, over, ckpt_dir=ckpt_dir)
                del full
                row["restored_from"] = tag(*run.layouts[run.save])
                res["restores"].append(row)
            dist.barrier()
    if rank == 0:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return res


def compression_check(torch, model, mesh, dev, seed=31):
    """``compression.compress_sharded`` of a fixed tree (standard normal
    leaves at the model's parameter shapes, each scaled by 10^k for k
    from -3 to 3 by leaf, drawn whole on every rank from ``seed``: not a
    gradient of the model) cut by the model's specs on ``mesh``,
    gathered and held bit for bit against the one-card
    ``compress_decompress`` of each whole leaf, a leaf at a time."""
    from repro_torch.distributed import parallel as par
    from repro_torch.distributed.compression import (compress_decompress,
                                                     compress_shard)
    from repro_torch.utils.params import tree_leaves
    specs = dict(tree_leaves(model.param_specs()))
    t0 = time.perf_counter()
    differ, n = [], 0
    for i, (name, d) in enumerate(tree_leaves(model.param_defs())):
        g = torch.Generator(dev).manual_seed(seed_of(seed, name))
        full = torch.randn(d.shape, generator=g, device=dev) * 10.0 ** (
            i % 7 - 3)
        got = par.gather_leaf(compress_shard(
            par.shard_leaf(full, specs[name], mesh), specs[name], mesh),
            specs[name], mesh)
        want = compress_decompress(full)
        n += full.numel()
        if not torch.equal(got.view(torch.uint8), want.view(torch.uint8)):
            differ.append(name)
        del full, got, want
    torch.cuda.synchronize()
    return {"bit_equal": not differ, "leaves_differing": differ,
            "elements": n, "seconds": time.perf_counter() - t0}


def mask_check(torch, loop, step_loss):
    """A masked run's first step against JAX's formula, evaluated apart:
    the loop's first parameters drawn again and batch 0, each rank's
    local microbatches through ``model.loss`` without a gradient, and
    from their ce, aux and token counts c_j, with C_i the mask's sum over
    global microbatch i (m of them, B rows over n batch shards, k local
    microbatches a rank)

        L = sum over ranks and j of ce_j max(c_j, 1) / (m max(C_i(j), 1))
            + aux_j / (n k),

    beside ``step_loss`` (the loop's first loss) and the mean of the
    ranks' own mean losses, which the sharded step gave before it took
    the global counts.  Every rank's token count is gathered."""
    import torch.distributed as dist
    from repro_torch.distributed import parallel as par
    plan, cfg = loop.plan, loop.cfg
    params, state, _ = loop.init_state()
    del state
    batch = loop.batch_at(0)
    axes = par.entry_axes(plan.batch_axes)
    n = math.prod(plan.mesh.shape[a] for a in axes)
    R, m = batch["tokens"].shape[0], cfg.grad_accum_microbatches
    k = min(m, R)
    counts = par.global_token_counts(batch["mask"], m, plan.mesh, axes)
    first = par.block_offsets((R,), (axes,), plan.mesh)[0]
    terms = torch.zeros(3, dtype=torch.float64, device=loop.device)
    with torch.no_grad():
        for j in range(k):
            rows = slice(j * (R // k), (j + 1) * (R // k))
            loss, met = loop.model.loss(params, {key: v[rows] for key, v in
                                                 batch.items()})
            i = (first + rows.start) // (R * n // m)
            terms += torch.stack([
                (met["ce"] * met["tokens"].clamp(min=1.0)).double()
                / (m * counts[i].clamp(min=1.0).double())
                + met["aux"].double() / (n * k),
                loss.double() / (k * n), met["tokens"].double()])
    tokens = terms[2].clone()
    par.all_reduce_(terms[:2], plan.mesh, axes)
    every = [torch.zeros_like(tokens) for _ in range(dist.get_world_size())]
    dist.all_gather(every, tokens)
    formula, old = float(terms[0]), float(terms[1])
    del params
    free_device(torch)
    return {"rank_tokens": [float(t) for t in every],
            "counts": counts.tolist(), "step_loss": step_loss,
            "formula_loss": formula,
            "formula_rel_err": abs(step_loss - formula) / abs(formula),
            "rank_means_loss": old,
            "rank_means_rel_diff": abs(old - formula) / abs(formula)}


def layerwise_init(torch, loop, dev):
    """Make ``loop`` draw its parameters with ``draw_params`` (a layer's
    slice at a time, each rank keeping its shard) in place of
    ``TrainLoop.init_state``'s whole draw."""
    def init_state(seed=0):
        m = loop.model
        specs = None if loop.mesh is None else m.param_specs()
        params = m.load(draw_params(torch, m, seed, dev, specs, loop.mesh))
        return params, loop.opt_init(params), 0
    loop.init_state = init_state


def free_device(torch):
    """Collect a finished run's objects (cycles included) and return the
    card's cached blocks, so the next run starts from what is live."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def profile_step(torch, loop, params, state):
    """One more step (the 4th) under the profiler, every rank at once
    (``device_profile``)."""
    import torch.distributed as dist
    batch = loop.batch_at(STEPS)
    torch.cuda.synchronize()
    dist.barrier()

    def step():
        _, _, met = loop.step_fn(params, state, batch, STEPS)
        float(met["loss"])
    return device_profile(torch, step)


def device_profile(torch, fn):
    """``fn`` once under the profiler: this rank's wall ms (host clock,
    to the card's synchronize), device busy ms (the union of its kernels'
    intervals: NCCL runs on a stream of its own, beside the compute) and
    idle share, and the device ms of the NCCL kernels (their transfers
    and their waits for the other ranks; in all and by collective), the
    GEMMs, attention and the SSD scan, and the top kernels."""
    from torch.autograd import DeviceType
    with cs.padded_profile() as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # "nccl:<op>" records repeat their kernels' time: left out
    evts = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.name.startswith("nccl:")]
    kernels, spans = {}, []
    for e in evts:
        ms, n = kernels.get(e.name[:80], (0.0, 0))
        kernels[e.name[:80]] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
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

    def nccl(op):
        return sum(ms for k, (ms, _) in kernels.items()
                   if "nccl" in k.lower() and op in k.lower())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    return {"wall_ms": wall, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / 1e3 / wall if spans
            else "not measured",
            "nccl_ms": by("nccl"),
            "nccl_ms_by_collective": {
                op: nccl(op.replace("_", "")) for op in (
                    "all_gather", "reduce_scatter", "all_reduce")},
            "gemm_ms": by("gemm", "cutlass",
                                                  "nvjet", "xmma"),
            "attention_ms": by("flash_"),
            "ssd_ms": by("ssd_"),
            "top_kernels": [{"name": k, "device_ms": ms, "calls": n}
                            for k, (ms, n) in top]}


def gate_run(res, rank, world):
    """One run's gates on this rank, what missed (empty when none did):
    exactly ``step_launches`` a step on every rank, and exactly
    ``step_collectives``' FSDP all-gathers and reduce-scatters, none of
    more elements than a unit's slice or a leaf outside the stacks; a
    compressed run's sharded compression bit-equal to one card's
    (``compression_check``); a restored loop ran step 3 alone; on rank 0
    every loss finite and,
    against the reference, one card bit-equal and more cards within the
    tolerances above (and a pair's layouts against each other within
    the same)."""
    missed = []

    def check(ok, msg):
        if not ok:
            missed.append(msg)
    name = f"train_mesh {res['name']}"
    want = {k: v * STEPS for k, v in res["launches_per_step_want"].items()}
    for row in res["layouts"]:
        got = {k: v for k, v in row["launches"].items() if v}
        check(got == want, f"{name} {row['layout']} rank {rank}: launches "
              f"{got}, want {want}")
    for row in res["layouts"]:
        cc = row.get("compression_check")
        check(cc is None or cc["bit_equal"], f"{name} {row['layout']} rank "
              f"{rank}: the sharded compression differs from the one-card "
              f"one in {cc and cc['leaves_differing']}")
    for row in res["layouts"] + res["restores"]:
        check(row["token_reduces_per_step"]
              == row["token_reduces_per_step_want"], f"{name} "
              f"{row['layout']} rank {rank}: token-count all-reduces a step "
              f"{row['token_reduces_per_step']}, want "
              f"{row['token_reduces_per_step_want']}")
        mc = row.get("mask_check")
        check(mc is None or mc["formula_rel_err"] <= MASK_LOSS_TOL,
              f"{name} {row['layout']} rank {rank}: first loss "
              f"{mc and mc['step_loss']} against the masked mean "
              f"{mc and mc['formula_loss']}")
    for row in res["layouts"] + res["restores"]:
        want_c = row["collectives_per_step_want"]
        got_c = {k: row["collectives_per_step"][k] for k in want_c}
        check(got_c == want_c, f"{name} {row['layout']} rank {rank}: FSDP "
              f"collectives a step {got_c}, want {want_c}")
    for row in res["restores"]:
        check(row["steps"] == [STEPS], f"{name} restore {row['layout']}: "
              f"steps {row['steps']}")
    if rank != 0:
        return missed
    ref = res.get("reference")
    if ref is not None:
        check(all(math.isfinite(x) for x in ref["losses"]),
              f"{name} reference losses {ref['losses']}")
    for row in res["layouts"] + res["restores"]:
        what = f"{name} {row['layout']}"
        check(all(math.isfinite(x) for x in row["losses"]),
              f"{what}: losses {row['losses']}")
        if "against" in row:
            check(row["against_max_rel_loss_err"] <= LOSS_TOL
                  and row["against_max_abs_param_err"] <= PARAM_ABS_TOL,
                  f"{what} against {row['against']}: loss "
                  f"{row['against_max_rel_loss_err']}, parameters "
                  f"{row['against_max_abs_param_err']}")
        if ref is None:
            continue
        if world == 1:
            check(row["bit_equal_to_reference"], f"{what}: not bit-equal "
                  f"to the one-card run: losses {row['losses']} against "
                  f"{ref['losses']}")
            continue
        check(row["max_rel_loss_err"] <= LOSS_TOL,
              f"{what}: losses {row['losses']} against {ref['losses']}")
        check(row["max_abs_param_err"] <= PARAM_ABS_TOL,
              f"{what}: parameter error {row['max_abs_param_err']} in "
              f"{row['worst_leaf']}")
        check(row["move_cosine"] >= MOVE_COS_MIN,
              f"{what}: movement cosine {row['move_cosine']}")
        low = {n: c for n, c in row["move_cosine_by_leaf"].items()
               if c < MOVE_COS_MIN}
        check(not low, f"{what}: movement cosines of leaves {low}")
    return missed


if __name__ == "__main__":
    main()
