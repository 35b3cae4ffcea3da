"""One rank of the port's sharded serving on the CPU, for
``tests/test_torch_serve_mesh.py``.

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        tests/_torch_serve_worker.py INPUT_DIR OUTPUT_DIR

Joins the gloo process group torchrun describes, then runs every entry
of ``CASES`` over the one world of 4 ranks, each on its own process mesh
(a mesh of fewer ranks takes ranks 0.. and the others wait): the full
parameters come from ``INPUT_DIR/<input_key(case)>.npz``, are cut with
``shard_tree`` to the training layout and held through
``load_serving`` (the FSDP cut gathered once); the case's inputs
(``case_inputs``) are cut to this rank's rows, and the model takes a
prefill and ``DECODE_STEPS`` decode steps on the given tokens.  Rank 0
writes ``OUTPUT_DIR/<case>.npz``: the logits of each call (rows
gathered) and the final cache gathered whole (``launch/programs.py``
``cache_specs``).  ``ENGINE_CASES`` serve ``ENGINE_PROMPTS`` through the
engine on every rank (the finished requests' tokens, and whether every
rank got the same); ``decode_attention_case`` holds the partial-softmax
decode over a cache cut on S against the whole one.
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs.base import ShapeCfg  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.data.pipeline import device_batch  # noqa: E402
from repro_torch.distributed import parallel as par  # noqa: E402
from repro_torch.distributed.rules import make_plan  # noqa: E402
from repro_torch.launch.mesh import make_process_submesh  # noqa: E402
from repro_torch.launch.programs import cache_specs  # noqa: E402
from repro_torch.launch.train import init_distributed  # noqa: E402
from repro_torch.models import attention as att  # noqa: E402
from repro_torch.models.zoo import get_model  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from repro_torch.utils.params import PartitionSpec, tree_from_flat  # noqa: E402

from _torch_mesh_worker import with_overrides  # noqa: E402

AXES = ("data", "model")
DECODE_STEPS = 3
SP = {"n_heads": 6, "n_kv_heads": 2}
RESID_SEQ = {"seq_shard_activations": True}

# name -> (arch, layout, batch, prompt length (frames for encdec), max_len,
# config overrides, the plan's shape kind).  qwen3's smoke config has 4
# query heads over 2 kv heads: at (1, 2) the kv heads are cut, at (1, 4)
# the query heads are and the cache is cut on S over "model"; at (2, 2)
# the batch is cut over "data"; at (4, 1) with a batch of 1 the cache is
# cut on S over "data" (JAX's long_500k rule).  "short": a prompt of 2
# in a cache of 16 over 4 ranks, so the decode at positions 2 and 3
# finds every rank but 0 wholly masked.  SP: 6 query heads do not divide
# 4, prompts of 13 (ceil(13/4) = 4 rows a rank, the last rank's one) and
# 8.  Megatron-SP: the plan of a prefill shape (resid_seq "model").
CASES = {
    "qwen3-1x2": ("qwen3-0.6b", (1, 2), 1, 12, 16, {}, "decode"),
    "qwen3-1x4": ("qwen3-0.6b", (1, 4), 2, 12, 16, {}, "decode"),
    "qwen3-1x4-short": ("qwen3-0.6b", (1, 4), 1, 2, 16, {}, "decode"),
    "qwen3-2x2": ("qwen3-0.6b", (2, 2), 2, 12, 16, {}, "decode"),
    "qwen3-4x1": ("qwen3-0.6b", (4, 1), 1, 12, 16, {}, "decode"),
    "qwen3-sp-1x4-s13": ("qwen3-0.6b", (1, 4), 1, 13, 16, SP, "decode"),
    "qwen3-sp-1x4-s8": ("qwen3-0.6b", (1, 4), 2, 8, 16, SP, "decode"),
    "qwen3-resid-seq-1x4": ("qwen3-0.6b", (1, 4), 2, 12, 16, RESID_SEQ,
                            "prefill"),
    "moe-1x4": ("qwen3-moe-30b-a3b", (1, 4), 2, 12, 16, {}, "decode"),
    "mamba2-1x4": ("mamba2-780m", (1, 4), 2, 12, 16, {}, "decode"),
    "zamba2-1x4": ("zamba2-1.2b", (1, 4), 2, 12, 16, {}, "decode"),
    "zamba2-4x1": ("zamba2-1.2b", (4, 1), 1, 12, 16, {}, "decode"),
    "seamless-1x4": ("seamless-m4t-medium", (1, 4), 2, 16, 8, {}, "decode"),
    # the plans whose "model" axis divides neither the experts nor the
    # SSM heads: 6 experts (each rank all 6, 16 of 64 d_ff_expert
    # columns); mamba2 and zamba2 at head_dim 64 (d_in 128 divides 4,
    # 2 heads do not: the layers run whole, the cache's conv_x columns
    # cut), zamba2's prefill with its residual stream cut on S
    "moe-ffcut-1x4": ("qwen3-moe-30b-a3b", (1, 4), 2, 12, 16,
                      {"moe.n_experts": 6}, "decode"),
    "mamba2-inner-1x4": ("mamba2-780m", (1, 4), 2, 12, 16,
                         {"ssm.head_dim": 64}, "decode"),
    "zamba2-inner-seq-1x4": ("zamba2-1.2b", (1, 4), 2, 12, 16,
                             {"ssm.head_dim": 64, **RESID_SEQ}, "prefill"),
}
# overrides that change the parameters' shapes: a case with one of them
# has inputs of its own
SHAPE_FIELDS = ("n_heads", "n_kv_heads", "moe.n_experts", "ssm.head_dim")

# the engine over (1, 4): 5 requests over 2 slots, as
# tests/test_torch_serving.py drives one card
ENGINE_CASES = {"engine-qwen3-1x4": "qwen3-0.6b",
                "engine-zamba2-1x4": "zamba2-1.2b"}
ENGINE_PROMPTS = (6, 9, 6, 12, 7)
ENGINE_SLOTS, ENGINE_MAX_LEN, ENGINE_NEW = 2, 48, 4


def case_config(arch, overrides=None):
    return with_overrides(smoke_config(get_config(arch)), overrides or {})


def input_key(name):
    """The parameter file of a case: its arch, and the overrides that
    change the parameters' shapes."""
    arch = CASES[name][0] if name in CASES else ENGINE_CASES[name]
    over = CASES[name][5] if name in CASES else {}
    return arch + "".join(f"-{k}{over[k]}" for k in SHAPE_FIELDS
                          if k in over)


def case_inputs(name):
    """(prefill input: tokens (B, S), or frames (B, S, D) f32 for encdec;
    the decode steps' tokens (DECODE_STEPS, B)), from seeded numpy."""
    arch, _, B, S, _, over, _ = CASES[name]
    cfg = case_config(arch, over)
    rng = np.random.default_rng(100 + list(CASES).index(name))
    if cfg.family == "encdec":
        inp = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    else:
        inp = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    return inp, rng.integers(0, cfg.vocab_size, (DECODE_STEPS, B),
                             dtype=np.int32)


def engine_prompts(cfg):
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
            for n in ENGINE_PROMPTS]


def first_decode_pos(name):
    """The first decode position: after the prompt, or 1 after encdec's
    BOS."""
    arch, _, _, S, _, over, _ = CASES[name]
    return 1 if case_config(arch, over).family == "encdec" else S


def mesh_of(shape):
    """A ("data", "model") process mesh over ranks 0 .. prod(shape) - 1 of
    the world; None on the ranks outside it."""
    return make_process_submesh(shape, AXES, "cpu")


def serving_model(cfg, mesh, plan, in_dir, key):
    """The model under ``plan``, its parameters from ``key``'s file cut
    to this rank's training shards and held through ``load_serving``."""
    model = get_model(cfg, plan)
    with np.load(os.path.join(in_dir, f"{key}.npz")) as f:
        full = tree_from_flat(model.param_defs(),
                              {k: torch.tensor(f[k]) for k in f.files})
    model.load_serving(par.shard_tree(full, model.param_specs(), mesh))
    return model


def run_case(name, in_dir, out_dir):
    arch, shape, B, S, max_len, over, kind = CASES[name]
    mesh = mesh_of(shape)
    if mesh is None:
        return
    cfg = case_config(arch, over)
    plan = make_plan(cfg, mesh, ShapeCfg("serve", max_len, B, kind))
    model = serving_model(cfg, mesh, plan, in_dir, input_key(name))
    inp, toks = case_inputs(name)

    def rows(x):
        return device_batch({"x": x}, "cpu", mesh, plan.batch_axes)["x"]

    def whole(logits):
        return par.gather_leaf(logits, PartitionSpec(plan.batch_axes), mesh)

    out = {}
    first = first_decode_pos(name)
    with torch.no_grad():
        cache, logits = model.prefill(model.params, rows(inp), max_len)
        out["logits0"] = whole(logits).numpy()
        for i in range(DECODE_STEPS):
            logits, cache = model.decode_step(model.params, cache,
                                              rows(toks[i]), first + i)
            out[f"logits{i + 1}"] = whole(logits).numpy()
        full = par.gather_tree(cache, cache_specs(model, cfg, plan), mesh)
    out.update({f"cache/{k}": v.numpy() for k, v in full.items()})
    if mesh.rank == 0:
        np.savez(os.path.join(out_dir, f"{name}.npz"), **out)


def run_engine(name, in_dir, out_dir):
    arch = ENGINE_CASES[name]
    mesh = mesh_of((1, 4))
    cfg = case_config(arch)
    plan = make_plan(cfg, mesh, ShapeCfg("serve", ENGINE_MAX_LEN,
                                         ENGINE_SLOTS, "decode"))
    model = serving_model(cfg, mesh, plan, in_dir, input_key(name))
    eng = Engine(model, model.params, slots=ENGINE_SLOTS,
                 max_len=ENGINE_MAX_LEN)
    for i, p in enumerate(engine_prompts(cfg)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=ENGINE_NEW))
    got = {r.rid: list(r.tokens) for r in eng.run_until_drained()}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, got)
    if mesh.rank == 0:
        rids = sorted(got)
        np.savez(os.path.join(out_dir, f"{name}.npz"),
                 rids=np.array(rids),
                 tokens=np.array([got[r] for r in rids]),
                 ranks_agree=np.array(all(e == got for e in every)))


def decode_attention_case(out_dir):
    """``decode_attention`` over a cache of 16 positions cut on S over 4
    ranks against the whole cache on rank 0, at positions 2 (ranks 1-3
    wholly masked), 5 and 15."""
    mesh = mesh_of((1, 4))
    g = torch.Generator().manual_seed(7)
    B, S, K, G, h = 2, 16, 2, 2, 16
    q = torch.randn(B, 1, K, G, h, generator=g)
    k = torch.randn(B, S, K, h, generator=g)
    v = torch.randn(B, S, K, h, generator=g)
    cut = par.seq_cut(mesh, "model")
    sl = slice(cut.index * (S // 4), (cut.index + 1) * (S // 4))
    out = {}
    for pos in (2, 5, 15):
        out[f"cut{pos}"] = att.decode_attention(q, k[:, sl], v[:, sl], pos,
                                                cut).numpy()
        out[f"whole{pos}"] = att.decode_attention(q, k, v, pos).numpy()
    if mesh.rank == 0:
        np.savez(os.path.join(out_dir, "decode_attention.npz"), **out)


def main(argv):
    in_dir, out_dir = argv
    init_distributed("cpu")
    torch.set_num_threads(1)
    try:
        decode_attention_case(out_dir)
        for name in CASES:
            run_case(name, in_dir, out_dir)
            dist.barrier()
        for name in ENGINE_CASES:
            run_engine(name, in_dir, out_dir)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
