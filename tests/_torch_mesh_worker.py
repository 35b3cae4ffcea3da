"""One rank of the port's sharded training on the CPU, for
``tests/test_torch_train_mesh.py``.

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        tests/_torch_mesh_worker.py INPUT_DIR OUTPUT_DIR

Joins the gloo process group torchrun describes, then runs every entry
of ``CASES`` in turn over the one world of 4 ranks, each on its own
process mesh: the full parameters come from
``INPUT_DIR/<input_key(case)>.npz`` (dotted leaf names, as the test
wrote them), are cut with
``shard_tree``, and the case takes two steps: the first from
``make_grad_fn`` and the optimizer's update (its gradients recorded, and
every rank's FSDP all-gathers and reduce-scatters in it counted), the
second through ``make_train_step``.  Rank 0 writes what the test compares to
``OUTPUT_DIR/<case>.npz``: the losses, the gathered gradients, the
parameters after each step, the optimizer state after the second,
whether shard -> gather gave the parameters back bit for bit and the
counts of each rank.
The cases of ``MASKED`` carry ``masked_batch``'s loss mask; they also
record, before the update, the loss of the formula the sharded step had
before it took JAX's masked mean per global microbatch
(``rank_means_loss``) and ``make_eval_step(model, plan)`` of the batch
(``eval/...``).  Every case records each rank's token-count all-reduces
in step 1 (``parallel.token_reduces``).
The cases of ``COMPRESSED`` step with ``grad_compression``: their
recorded gradients are the mean gradients before the int8 round trip
(``compression.compress_sharded``) that the update takes, of both steps
(the second's as ``grad2``).
``compression_case`` cuts one fixed tree (``compression_tree``) on each
of ``COMPRESSION_LAYOUTS``, compresses the shards and writes the
gathered result.
``RESTORES``: per arch a ``TrainLoop`` saves at step 1 on one layout, and
loops on other layouts restore from it and run to step 3.  Last, the launcher's
``main`` trains over the same group (``LAUNCHER``, its log on
standard output), then again at (4, 1) with ``--grad-compression``
(its losses in ``launcher-compressed.npz``).
"""
import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs.base import ShapeCfg  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM, device_batch  # noqa: E402
from repro_torch.distributed import parallel as par  # noqa: E402
from repro_torch.distributed.compression import compress_sharded  # noqa: E402
from repro_torch.distributed.rules import make_plan  # noqa: E402
from repro_torch.launch.mesh import make_process_mesh  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.train import TrainLoop, init_distributed  # noqa: E402
from repro_torch.models.zoo import get_model  # noqa: E402
from repro_torch.training import optimizers as opt  # noqa: E402
from repro_torch.training.train_step import (make_eval_step,  # noqa: E402
                                             make_grad_fn, make_train_step)
from repro_torch.utils.params import PartitionSpec as P  # noqa: E402
from repro_torch.utils.params import tree_from_flat, tree_leaves  # noqa: E402

AXES2, AXES3 = ("data", "model"), ("pod", "data", "model")
LAYOUTS = ((4, 1), (1, 4), (2, 2), (2, 1, 2))
BATCH_SEED = 1

# name -> (arch, layout, global batch, seq, config overrides, optimizer
# config overrides)
CASES = {}
for _shape in LAYOUTS:
    CASES[f"qwen3-{'x'.join(map(str, _shape))}"] = (
        "qwen3-0.6b", _shape, 4, 32, {}, {})
for _shape in ((4, 1), (2, 2)):
    CASES[f"granite-micro4-{'x'.join(map(str, _shape))}"] = (
        "granite-3-8b", _shape, 16, 32, {"grad_accum_microbatches": 4}, {})
for _shape in ((2, 2), (2, 1, 2)):
    # min_dim_factored 16: the smoke widths (64, 128, 256) factor
    CASES[f"llama3-adafactor-{'x'.join(map(str, _shape))}"] = (
        "llama3-405b", _shape, 4, 32, {}, {"min_dim_factored": 16})
CASES["mamba2-4x1"] = ("mamba2-780m", (4, 1), 4, 32, {}, {})
CASES["moe-4x1"] = ("qwen3-moe-30b-a3b", (4, 1), 4, 32, {}, {})
# the split over "model" of the other families: mamba2's 8 SSM heads
# (2 or 4 a rank), qwen3-moe's 4 experts (1 or 2 a rank), zamba2's
# mamba layers and shared block, seamless's encoder, decoder and
# cross-attention (64 frames under 32 tokens)
for _shape in ((1, 4), (2, 2)):
    _t = "x".join(map(str, _shape))
    CASES[f"mamba2-{_t}"] = ("mamba2-780m", _shape, 4, 32, {}, {})
    CASES[f"moe-{_t}"] = ("qwen3-moe-30b-a3b", _shape, 4, 32, {}, {})
CASES["zamba2-1x4"] = ("zamba2-1.2b", (1, 4), 4, 32, {}, {})
CASES["seamless-1x4"] = ("seamless-m4t-medium", (1, 4), 4, 32, {}, {})
# FSDP over "data" beside the split over "model": zamba2's grouped
# layers, a tail layer and the shared block; seamless's two stacks
CASES["zamba2-2x2"] = ("zamba2-1.2b", (2, 2), 4, 32, {"n_layers": 5}, {})
CASES["seamless-2x2"] = ("seamless-m4t-medium", (2, 2), 4, 32, {}, {})
# the per-unit gathers under the other remat settings: "dots", and the
# two-level remat (two groups of two units)
CASES["qwen3-dots-4x1"] = ("qwen3-0.6b", (4, 1), 4, 32, {"remat": "dots"},
                           {})
CASES["qwen3-scan-4x1"] = ("qwen3-0.6b", (4, 1), 4, 32,
                           {"n_layers": 4, "remat": "full",
                            "scan_block": 2}, {})
# sequence parallelism: 6 query heads do not divide 4, so each rank
# takes 8 of the 32 query rows; Megatron-SP: the residual stream cut on S
CASES["qwen3-sp-1x4"] = ("qwen3-0.6b", (1, 4), 4, 32,
                         {"n_heads": 6, "n_kv_heads": 2}, {})
CASES["qwen3-resid-seq-1x4"] = ("qwen3-0.6b", (1, 4), 4, 32,
                                {"seq_shard_activations": True}, {})
# 30 query rows, which 4 do not divide: blocks of 8, the last 2 padding
CASES["qwen3-sp-S30-1x4"] = ("qwen3-0.6b", (1, 4), 4, 30,
                             {"n_heads": 6, "n_kv_heads": 2}, {})
# the plans whose "model" axis divides neither the experts nor the SSM
# heads: 6 experts on 4 ranks (each rank all 6, 16 of the 64 d_ff_expert
# columns), 3 experts (top-2) on 2 beside FSDP over "data"; mamba2 at
# head_dim 64 (d_in 128 divides 4, its 2 heads do not: the layer runs
# whole, its d_in leaves gathered), and zamba2 so with its residual
# stream cut on S (Megatron-SP through the whole mamba layers)
CASES["moe-ffcut-1x4"] = ("qwen3-moe-30b-a3b", (1, 4), 4, 32,
                          {"moe.n_experts": 6}, {})
CASES["moe-ffcut-2x2"] = ("qwen3-moe-30b-a3b", (2, 2), 4, 32,
                          {"moe.n_experts": 3, "moe.top_k": 2}, {})
CASES["mamba2-inner-1x4"] = ("mamba2-780m", (1, 4), 4, 32,
                             {"ssm.head_dim": 64}, {})
CASES["zamba2-inner-seq-1x4"] = ("zamba2-1.2b", (1, 4), 4, 32,
                                 {"ssm.head_dim": 64,
                                  "seq_shard_activations": True}, {})
# int8 gradient compression of the sharded gradients
for _shape in ((4, 1), (2, 2)):
    CASES[f"qwen3-compress-{'x'.join(map(str, _shape))}"] = (
        "qwen3-0.6b", _shape, 4, 32, {}, {})
# masked batches over several batch shards (``masked_batch``): JAX's
# masked mean per global microbatch; name -> the unmasked case of the
# same config and layout (None: none).  B 12 in 3 microbatches at
# (4, 1): a rank's 3 rows fall in two global microbatches
for _shape in ((4, 1), (2, 2), (2, 1, 2)):
    CASES[f"qwen3-mask-{'x'.join(map(str, _shape))}"] = (
        "qwen3-0.6b", _shape, 4, 32, {}, {})
for _shape in ((4, 1), (2, 2)):
    CASES[f"granite-micro4-mask-{'x'.join(map(str, _shape))}"] = (
        "granite-3-8b", _shape, 16, 32, {"grad_accum_microbatches": 4}, {})
CASES["moe-mask-4x1"] = ("qwen3-moe-30b-a3b", (4, 1), 4, 32, {}, {})
CASES["seamless-mask-2x2"] = ("seamless-m4t-medium", (2, 2), 4, 32, {}, {})
CASES["qwen3-compress-mask-2x2"] = ("qwen3-0.6b", (2, 2), 4, 32, {}, {})
CASES["qwen3-mask-b12-micro3-4x1"] = ("qwen3-0.6b", (4, 1), 12, 32,
                                     {"grad_accum_microbatches": 3}, {})
MASKED = {"qwen3-mask-4x1": "qwen3-4x1", "qwen3-mask-2x2": "qwen3-2x2",
          "qwen3-mask-2x1x2": "qwen3-2x1x2",
          "granite-micro4-mask-4x1": "granite-micro4-4x1",
          "granite-micro4-mask-2x2": "granite-micro4-2x2",
          "moe-mask-4x1": "moe-4x1", "seamless-mask-2x2": "seamless-2x2",
          "qwen3-compress-mask-2x2": "qwen3-compress-2x2",
          "qwen3-mask-b12-micro3-4x1": None}
COMPRESSED = ("qwen3-compress-4x1", "qwen3-compress-2x2",
              "qwen3-compress-mask-2x2")
ENC_FRAMES = 64
# the cases that split the other families or attention's query rows over
# "model"
SPLIT_CASES = ("mamba2-1x4", "mamba2-2x2", "moe-1x4", "moe-2x2",
               "zamba2-1x4", "zamba2-2x2", "seamless-1x4", "seamless-2x2",
               "seamless-mask-2x2",
               "qwen3-sp-1x4", "qwen3-resid-seq-1x4", "moe-ffcut-1x4",
               "moe-ffcut-2x2", "mamba2-inner-1x4", "zamba2-inner-seq-1x4")
# overrides that change the parameters' shapes: a case with one of them
# has inputs of its own ("moe.n_experts": the field of the config's moe)
SHAPE_FIELDS = ("n_heads", "n_kv_heads", "n_layers", "moe.n_experts",
                "ssm.head_dim")
# compression_case: the layouts, and the tree's leaves (name -> global
# shape, dtype, spec over ("data", "model")): shards that straddle
# 256-element blocks, a leaf of 288 whose shards hold 72, a 1-D leaf cut
# over both axes, a replicated leaf, bf16, and leaves that stay as they
# are (200 elements; integers)
COMPRESSION_LAYOUTS = ((4, 1), (2, 2), (1, 4))
COMPRESSION_LEAVES = {
    "straddle": ((24, 40), "float32", P("data", "model")),
    "few": ((8, 36), "float32", P(None, ("data", "model"))),
    "deep": ((4, 6, 32), "float32", P("model", None, "data")),
    "flat": ((1024,), "float32", P(("data", "model"))),
    "whole": ((300,), "float32", P()),
    "half": ((16, 48), "bfloat16", P("data", None)),
    "small": ((8, 25), "float32", P("data", None)),
    "ints": ((16, 32), "int32", P("data", "model")),
}
# the FSDP counts each rank records, in this order
FSDP_KEYS = ("all_gather", "reduce_scatter", "all_gather_max_numel")

# arch -> (save layout, restore layouts): a TrainLoop on the save layout
# saves at step 1; loops on each restore layout restore it and run to
# step 3.  Beside qwen3's head cut: the experts' cut (EP), the SSM
# heads', the encdec's
RESTORES = {"qwen3-0.6b": ((2, 2), ((4, 1), (1, 4))),
            "mamba2-780m": ((1, 4), ((2, 2),)),
            "qwen3-moe-30b-a3b": ((1, 4), ((2, 2),)),
            "seamless-m4t-medium": ((1, 4), ((2, 2),))}
RESTORE_B, RESTORE_S = 4, 32
# the launcher's run over the 4 ranks at (2, 2), the smoke config; rank
# 0 alone logs
LAUNCHER = {"arch": "qwen3-0.6b", "steps": 2, "global_batch": 4, "seq": 32}


def with_overrides(cfg, overrides):
    """``cfg.replace(**overrides)``, a dotted key ("moe.n_experts") a
    field of the sub-config it names (the JAX package's configs too)."""
    top = {k: v for k, v in overrides.items() if "." not in k}
    for k, v in overrides.items():
        if "." in k:
            sub, field = k.split(".")
            top[sub] = dataclasses.replace(top.get(sub, getattr(cfg, sub)),
                                           **{field: v})
    return cfg.replace(**top)


def case_config(arch, overrides):
    return with_overrides(smoke_config(get_config(arch)), overrides)


def compression_tree():
    """``COMPRESSION_LEAVES`` drawn from seeded numpy (standard normal
    scaled by 10^U(-3, 3) per row, one row of zeros; integers in
    [-1000, 1000)): {name: float32 or int32 array}, bf16 leaves' values
    rounded to bf16 and held in f32."""
    rng = np.random.default_rng(31)
    out = {}
    for name, (shape, dtype, _) in COMPRESSION_LEAVES.items():
        if dtype == "int32":
            out[name] = rng.integers(-1000, 1000, shape, dtype=np.int32)
            continue
        x = rng.standard_normal(shape) * 10.0 ** rng.uniform(
            -3, 3, shape[:1] + (1,) * (len(shape) - 1))
        x[0] = 0.0
        x = torch.tensor(x, dtype=getattr(torch, dtype))
        out[name] = x.float().numpy()
    return out


def input_key(name):
    """The name of a case's parameter file: its arch, and the overrides
    that change the parameters' shapes."""
    arch, over = CASES[name][0], CASES[name][4]
    return arch + "".join(f"-{k}{over[k]}" for k in SHAPE_FIELDS
                          if k in over)


def host_batch(name, i):
    """Batch ``i`` of a case on the host (``lm_batch``), with
    ``masked_batch``'s mask for the cases of ``MASKED``."""
    arch, _, B, S, over, _ = CASES[name]
    cfg = case_config(arch, over)
    hb = lm_batch(cfg, B, S, BATCH_SEED, i)
    if name in MASKED:
        hb["mask"] = masked_batch(B, S, cfg.grad_accum_microbatches, i)
    return hb


def masked_batch(B, S, n_micro, i):
    """A loss mask (B, S) f32 for batch ``i``, as instruction tuning
    gives: each row's first P tokens (P uniform in [S/10, 9S/10]) weigh
    0, the last 10-30 % of every fourth row too (padding), an eighth of
    what is left 0.5; a whole global microbatch weighs 0 (the second
    last of ``n_micro``; with one microbatch, row 1)."""
    rng = np.random.default_rng([BATCH_SEED, i, 32])
    mask = np.ones((B, S), np.float32)
    for r in range(B):
        mask[r, :rng.integers(S // 10, 9 * S // 10 + 1)] = 0.0
        if r % 4 == 3:
            mask[r, S - rng.integers(-(-S // 10), 3 * S // 10 + 1):] = 0.0
    mask[(rng.random((B, S)) < 0.125) & (mask > 0)] = 0.5
    if n_micro > 1:
        size = B // n_micro
        mask[(n_micro - 2) * size:(n_micro - 1) * size] = 0.0
    else:
        mask[1] = 0.0
    return mask


def lm_batch(cfg, B, S, seed, i):
    """Batch ``i`` of SyntheticLM's stream from ``seed``, and for encdec
    standard normal frame embeddings (B, ENC_FRAMES, D) from seed i."""
    hb = dict(SyntheticLM(cfg.vocab_size, S, B, seed=seed).batch_at(i))
    if cfg.family == "encdec":
        hb["enc_emb"] = np.random.default_rng(i).standard_normal(
            (B, ENC_FRAMES, cfg.d_model)).astype(np.float32)
    return hb


def restore_loop(arch, mesh=None, **kw):
    """A ``TrainLoop`` of ``RESTORES``' runs: the smoke config of
    ``arch``, the stream from seed 0 (``lm_batch``), on ``mesh`` or one
    CPU process."""
    cfg = smoke_config(get_config(arch))
    return TrainLoop(cfg, global_batch=RESTORE_B, seq=RESTORE_S, mesh=mesh,
                     device="cpu", batches=lambda i: lm_batch(
                         cfg, RESTORE_B, RESTORE_S, 0, i), **kw)


def restore_name(arch, shape):
    """The output file of a restore (no extension); qwen3's carry the
    layout alone."""
    t = "x".join(map(str, shape))
    return f"restore-{t}" if arch == "qwen3-0.6b" else f"restore-{arch}-{t}"


def mesh_of(shape):
    return make_process_mesh(shape, AXES2 if len(shape) == 2 else AXES3,
                             "cpu")


def _np(tree, prefix):
    return {f"{prefix}/{n}": x.detach().numpy().copy()
            for n, x in tree_leaves(tree)}


def run_case(name, in_dir, out_dir):
    arch, shape, B, S, over, opt_over = CASES[name]
    cfg = case_config(arch, over)
    mesh = mesh_of(shape)
    plan = make_plan(cfg, mesh, ShapeCfg("test", S, B, "train"))
    model = get_model(cfg, plan)
    specs = model.param_specs()
    with np.load(os.path.join(in_dir, f"{input_key(name)}.npz")) as f:
        full = tree_from_flat(model.param_defs(),
                              {k: torch.tensor(f[k]) for k in f.files})
    local = par.shard_tree(full, specs, mesh)
    back = par.gather_tree(local, specs, mesh)
    roundtrip = all(torch.equal(a, b) for (_, a), (_, b) in
                    zip(tree_leaves(full), tree_leaves(back)))
    params = model.load(local)
    ocfg = opt.OptConfig(name=cfg.optimizer, **opt_over)
    compressed = name in COMPRESSED
    step_fn, opt_init, _ = make_train_step(model, cfg, plan, opt_cfg=ocfg,
                                           grad_compression=compressed)

    def batch(i):
        return device_batch(host_batch(name, i), "cpu", mesh,
                            plan.batch_axes)

    # step 1 as the sharded step takes it, its gradients gathered before
    # the optimizer clips them in place; step 2 through make_train_step
    par.reset_fsdp_counts()
    par.reset_token_reduces()
    grads, loss = make_grad_fn(model, cfg, plan)(params, batch(0))
    counts = par.fsdp_counts()
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, [counts[k] for k in FSDP_KEYS]
                           + [par.token_reduces()])
    out = {"roundtrip": np.array(roundtrip), "grad_loss": loss.numpy(),
           "fsdp": np.array(ranks)[:, :len(FSDP_KEYS)],
           "token_reduces": np.array(ranks)[:, len(FSDP_KEYS)],
           **_np(par.gather_tree(grads, specs, mesh), "grad")}
    if name in MASKED:
        out["rank_means_loss"] = rank_means_loss(model, cfg, plan, params,
                                                 batch(0)).numpy()
        ev = make_eval_step(model, plan)(params, batch(0))
        out.update({f"eval/{k}": v.numpy() for k, v in ev.items()})
    state = opt_init(params)
    update = opt.make_optimizer(ocfg.name, ocfg, mesh, specs)[2]
    if compressed:
        grads = compress_sharded(grads, specs, mesh)
    params, state, met = update(grads, state, params)
    met["loss"] = loss
    for i in range(2):
        if i and compressed:
            # the mean gradient the step compresses, gathered: the test
            # tells where its int8 code turned against one device's
            g2, _ = make_grad_fn(model, cfg, plan)(params, batch(i))
            out.update(_np(par.gather_tree(g2, specs, mesh), "grad2"))
            del g2
        if i:
            params, state, met = step_fn(params, state, batch(i), i)
        out[f"loss{i + 1}"] = met["loss"].numpy()
        out[f"grad_norm{i + 1}"] = met["grad_norm"].numpy()
        out.update(_np(par.gather_tree(params, specs, mesh), f"p{i + 1}"))
    ss = opt.state_specs(ocfg.name, ocfg, specs, model.param_defs())
    out.update(_np(par.gather_tree(state, ss, mesh), "opt"))
    if mesh.rank == 0:
        np.savez(os.path.join(out_dir, f"{name}.npz"), **out)


def rank_means_loss(model, cfg, plan, params, batch):
    """What the sharded step's loss was before it took JAX's masked mean
    per global microbatch: each rank's mean over its own microbatches of
    their mean losses, averaged over the batch shards."""
    rows = batch["tokens"].shape[0]
    k = min(cfg.grad_accum_microbatches, rows)
    with torch.no_grad():
        mean = sum(model.loss(params, {n: v[j * rows // k:(j + 1) * rows // k]
                                       for n, v in batch.items()})[0]
                   for j in range(k)) / k
    axes = par.entry_axes(plan.batch_axes)
    n = int(np.prod([plan.mesh.shape[a] for a in axes]))
    return par.all_reduce_(mean.clone(), plan.mesh, axes) / n


def compression_case(out_dir):
    """``compress_sharded`` of ``compression_tree`` cut on each of
    ``COMPRESSION_LAYOUTS``, gathered (bf16 held in f32):
    ``compression.npz``, ``<layout>/<leaf>``."""
    tree = compression_tree()
    out = {}
    for shape in COMPRESSION_LAYOUTS:
        mesh = mesh_of(shape)
        specs = {n: sp for n, (_, _, sp) in COMPRESSION_LEAVES.items()}
        full = {n: torch.tensor(x).to(getattr(torch, COMPRESSION_LEAVES[n][1]))
                for n, x in tree.items()}
        local = par.shard_tree(full, specs, mesh)
        got = par.gather_tree(compress_sharded(local, specs, mesh), specs,
                              mesh)
        t = "x".join(map(str, shape))
        for n, x in got.items():
            assert x.dtype == full[n].dtype, (n, x.dtype)
            out[f"{t}/{n}"] = (x.float() if x.is_floating_point()
                               else x).numpy()
    if dist.get_rank() == 0:
        np.savez(os.path.join(out_dir, "compression.npz"), **out)


def run_restores(out_dir):
    quiet = lambda _: None      # noqa: E731
    for arch, (save, shapes) in RESTORES.items():
        ckpt_dir = os.path.join(out_dir, f"ckpt-{arch}")
        restore_loop(arch, mesh_of(save), ckpt_dir=ckpt_dir).run(
            1, save_every=1, log=quiet)
        for shape in shapes:
            lp = restore_loop(arch, mesh_of(shape), ckpt_dir=ckpt_dir)
            params, _, _ = lp.run(3, log=quiet)
            full = par.gather_tree(params, lp.model.param_specs(), lp.mesh)
            if lp.mesh.rank == 0:
                np.savez(os.path.join(out_dir,
                                      restore_name(arch, shape) + ".npz"),
                         steps=np.array([h["step"] for h in lp.history]),
                         losses=np.array([h["loss"] for h in lp.history]),
                         **_np(full, "p"))


def main(argv):
    in_dir, out_dir = argv
    init_distributed("cpu")
    try:
        compression_case(out_dir)
        for name in CASES:
            run_case(name, in_dir, out_dir)
        run_restores(out_dir)
        dist.barrier()
        # the launcher itself, in the group this process already joined
        args = ["--distributed", "--mesh", "2,2", "--smoke", "--device",
                "cpu"] + [a for k, v in LAUNCHER.items()
                          for a in (f"--{k.replace('_', '-')}", str(v))]
        train.main(args)
        # and with --grad-compression at (4, 1), quiet: its losses saved
        loop = train.main(args[:1] + ["--mesh", "4,1"] + args[3:]
                          + ["--grad-compression", "--quiet"])
        if dist.get_rank() == 0:
            np.savez(os.path.join(out_dir, "launcher-compressed.npz"),
                     losses=np.array([h["loss"] for h in loop.history]))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
