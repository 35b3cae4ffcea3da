#!/usr/bin/env python3
"""One rank of ``chip_smoke.py``'s serve_mesh phase: the port's models
served over the cards of one host, one process per card.

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        tools/serve_mesh.py --out DIR [--runs NAME ...] [--cpu]

Joins the NCCL process group (``launch.train`` ``init_distributed``:
this rank on ``cuda:LOCAL_RANK``; gloo with ``--cpu``), then takes each
run of ``RUNS`` made for a world of N processes (or those named), in
order:

1. unless the run has none, rank 0 alone serves the run's traffic on
   one card (no plan): the reference;
2. every layout of the run (a ("data", "model") process mesh over ranks
   0 .. d*m - 1; the other ranks wait) serves the same traffic from the
   same parameters: the plan of ``ShapeCfg("custom", max_len, slots,
   "decode")``, ``get_model(cfg, plan)``, the parameters drawn leaf by
   leaf on the card with each rank keeping its block
   (``train_mesh.draw_params``).  ``engine`` runs:
   ``serving.engine.Engine`` over requests drawn as ``launch.serve.serve``
   draws them; ``encdec``: a
   prefill of frame embeddings and greedy decode steps, as
   ``chip_smoke.phase_serve_encdec``; ``cell``: JAX's ``long_500k``
   decode cell, a batch of 1 over a cache of ``LONG_LEN`` positions
   drawn from the seed, decode steps near its end and inside rank 0's
   block.  A run with ``repeat`` serves its layout twice.

A layout of a run with a reference serves on the reference's tokens
(``Recorder``'s teacher forcing) and its MoE routes.  Per layout each
rank records its tokens, launches, prefill ms by prompt length, decode
tick ms, TTFT and tokens/s, peak memory and cache bytes, and a profiled
decode step (device busy, NCCL ms); rank 0 holds the logits of every
call against the reference's (``compare``).  A bf16 run over more
than one card has a shadow: rank 0 also serves the reference's tokens
on one card in f32, and the split is held within ``SHADOW_FACTOR``
times that one card's own bf16 error.  Each bf16 run also has a twin
with f32 activations (``over``), which holds the split to the one
card's logits without bf16's roundings.  After
every run each rank checks its gates (``gate_run``), records what
missed under ``gates_missed`` and writes ``DIR/rank<r>.json``; it exits
non-zero after the last run if any gate missed.  ``--cpu`` rehearses
every run at its smoke config on the CPU (gloo; no launches, no
profile).
"""
import argparse
import dataclasses
import json
import math
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke as cs  # noqa: E402
import train_mesh as tm  # noqa: E402

AXES = ("data", "model")
# the engine's traffic: (requests, slots, new tokens, prompt lengths), as
# the serve phase's qwen3-0.6b run (chip_smoke.SERVE_RUNS)
ENGINE = cs.SERVE_MESH_TRAFFIC
MAMBA2 = (2, 2, 16, (1024, 2048))
MAX_LEN = cs.SERVE_MAX_LEN
# the long_500k cell: positions, the cache drawn in chunks of this many
# positions (a rank draws its own), decode steps at these positions
LONG_LEN = 524288
LONG_CHUNK = 8192
CPU_LONG_CHUNK = 8
LONG_EARLY = 4096
# a layout against the reference, on the reference's tokens: one card
# bit-equal; more cards every token the reference's but at a near tie
# (its margin within twice the logits' error), and with f32 activations
# the logits within F32_LOGIT_TOL of the reference's largest |logit| over
# the real vocabulary (sums in another order).  With bf16 activations a
# split's logits differ from one card's by about as much as one card's
# bf16 logits differ from its f32 ones (a rounding that flips in one
# layer is carried through the rest; PERF.md §6), so the split is held
# within SHADOW_FACTOR times that reading of the run's own shadow.
F32_LOGIT_TOL = 1e-4
SHADOW_FACTOR = 3.0
# the rehearsal on the CPU: smoke configs and this traffic
CPU_ENGINE = (3, 2, 4, (6, 9, 12))
CPU_MAX_LEN = 48
CPU_LONG_LEN = 64
F32 = {"dtype": "float32"}


@dataclasses.dataclass(frozen=True)
class Run:
    """A model served on a world of ``cards`` processes: its layouts
    ((data, model) shapes, each over the world's first ranks), against
    rank 0's one-card run of the same config (``reference``).
    ``kind``: engine, encdec or cell; ``layers``: the depth kept (None:
    published); ``draw``: "init" (``model.init`` from the seed, as
    ``launch.serve.serve`` draws) or "sliced" (each stacked leaf a layer
    at a time, for models no card holds); ``routes``: the reference's
    MoE routes handed to the layouts (top-k is not promised equal on
    ties); ``repeat``: each layout served twice (equal tokens);
    ``alone``: a torchrun launch of its own; ``over``: config overrides
    (f32 activations, to hold the split against one card without bf16's
    roundings); ``long_len``: the cell's cached positions; ``cpu_over``:
    config overrides of the CPU rehearsal ("moe.d_ff_expert": a field of
    the config's moe)."""
    name: str
    arch: str
    cards: int
    layouts: tuple
    kind: str = "engine"
    traffic: tuple = ENGINE
    layers: int = None
    reference: bool = True
    draw: str = "init"
    routes: bool = False
    repeat: bool = False
    alone: bool = False
    over: dict = dataclasses.field(default_factory=dict)
    long_len: int = LONG_LEN
    cpu_over: dict = dataclasses.field(default_factory=dict)


RUNS = (
    Run("qwen3-0.6b", cs.TRAIN_ARCH, 1, ((1, 1),)),
    Run("qwen3-0.6b", cs.TRAIN_ARCH, 4, ((1, 1), (1, 2), (1, 4))),
    # the SSM heads and conv_x cut; the cross cache
    Run("mamba2-780m", "mamba2-780m", 4, ((1, 4),), traffic=MAMBA2),
    Run("seamless-m4t-medium", cs.ENCDEC_ARCH, 4, ((1, 4),), kind="encdec"),
    # the cache cut on S over "data" at a batch of 1, FSDP gathered at
    # load; one card holds the whole cache for the reference
    Run("zamba2-1.2b:long_500k", "zamba2-1.2b", 4, ((4, 1),), kind="cell"),
    # expert parallelism (32 experts, 8 of 32 heads, 1 of 4 kv heads a
    # rank): 16 layers against one card, then all 48 (no card holds them)
    Run("qwen3-moe-30b-a3b:16", cs.MOE_TRAIN[0], 4, ((1, 4),), layers=16,
        draw="sliced", routes=True),
    Run("qwen3-moe-30b-a3b:48", cs.MOE_TRAIN[0], 4, ((1, 4),),
        draw="sliced", reference=False, repeat=True, alone=True),
    # 128 experts do not divide 3 cards: each rank all 128, 256 of each
    # expert's 768 d_ff_expert columns; attention sequence-parallel (32
    # heads), the cache cut on S (4 kv heads); 16 layers against one card
    Run("qwen3-moe-30b-a3b:16:1x3", cs.MOE_TRAIN[0], cs.SP_RANKS,
        ((1, cs.SP_RANKS),), layers=16, draw="sliced", routes=True,
        cpu_over={"vocab_size": 768, "moe.d_ff_expert": 48}),
    # the SP fallback (40 heads over 3 cards): prompts of every length
    Run("qwen2.5-14b:8", "qwen2.5-14b", cs.SP_RANKS, ((1, cs.SP_RANKS),),
        layers=8, draw="sliced", cpu_over={"vocab_size": 768}),
    Run("qwen2.5-14b:48", "qwen2.5-14b", cs.SP_RANKS, ((1, cs.SP_RANKS),),
        draw="sliced", reference=False, repeat=True,
        cpu_over={"vocab_size": 768}),
    # the same splits with f32 activations against one card: the port's
    # error without bf16's roundings (the zamba2 cell at 131,072
    # positions, whose f32 cache one card holds)
    Run("qwen3-0.6b:f32", cs.TRAIN_ARCH, 4, ((1, 4),), over=F32),
    Run("mamba2-780m:f32", "mamba2-780m", 4, ((1, 4),), traffic=MAMBA2,
        over=F32),
    Run("seamless-m4t-medium:f32", cs.ENCDEC_ARCH, 4, ((1, 4),),
        kind="encdec", over=F32),
    Run("zamba2-1.2b:long_131k:f32", "zamba2-1.2b", 4, ((4, 1),),
        kind="cell", over=F32, long_len=131072),
    Run("qwen3-moe-30b-a3b:16:f32", cs.MOE_TRAIN[0], 4, ((1, 4),),
        layers=16, draw="sliced", routes=True, over=F32),
    Run("qwen2.5-14b:8:f32", "qwen2.5-14b", cs.SP_RANKS, ((1, cs.SP_RANKS),),
        layers=8, draw="sliced", over=F32, cpu_over={"vocab_size": 768}),
)


def runs_for(world, names=None):
    return [r for r in RUNS if r.cards == world
            and (not names or r.name in names)]


def run_config(run, cpu):
    from repro_torch.configs.registry import get_config, smoke_config
    cfg = get_config(run.arch).replace(**run.over)
    if cpu:
        cfg = smoke_config(cfg)
        top = {k: v for k, v in run.cpu_over.items() if "." not in k}
        for k, v in run.cpu_over.items():
            if "." in k:
                sub, field = k.split(".")
                top[sub] = dataclasses.replace(getattr(cfg, sub), **{field: v})
        cfg = cfg.replace(**top)
    if run.layers is not None and not cpu:
        cfg = cfg.replace(n_layers=run.layers)
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--runs", nargs="*", help="names of RUNS (default: "
                    "every run made for this world size)")
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse at the smoke configs on the CPU")
    args = ap.parse_args(argv)
    import torch
    import torch.distributed as dist
    from repro_torch.launch.train import init_distributed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = init_distributed("cpu" if args.cpu else "cuda")
    if args.cpu:
        torch.set_num_threads(1)
    rank, world = dist.get_rank(), dist.get_world_size()
    runs = runs_for(world, args.runs)
    if not runs:
        raise ValueError(f"serve_mesh: no run for {world} cards "
                         f"(names {args.runs})")
    out = {"rank": rank, "world": world, "device": str(dev),
           "card": "cpu" if args.cpu else torch.cuda.get_device_name(dev),
           "runs": []}
    try:
        for run in runs:
            t0 = time.perf_counter()
            res = Server(run, rank, dev, args.cpu).serve()
            res.update(name=run.name, arch=run.arch, cards=run.cards,
                       kind=run.kind, seconds=time.perf_counter() - t0)
            res["gates_missed"] = gate_run(res, rank, world)
            out["runs"].append(res)
            free(torch, dev)
            dist.barrier()
            with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
                json.dump(out, f)
        missed = {r["name"]: r["gates_missed"] for r in out["runs"]
                  if r["gates_missed"]}
        cs.check(not missed, f"serve_mesh rank {rank}: gates missed "
                 f"{missed}")
    finally:
        dist.destroy_process_group()


def free(torch, dev):
    if dev.type == "cuda":
        tm.free_device(torch)


def mesh_group(mesh):
    """The process group over every rank of ``mesh``: the default group
    for a mesh of the whole world, else its one axis of size > 1 (the
    runs' sub-meshes are lines)."""
    import torch.distributed as dist
    if mesh.devices.size == dist.get_world_size():
        return None
    live = [a for a in AXES if mesh.shape[a] > 1]
    assert len(live) == 1, mesh.shape
    return mesh.groups[live[0]]


def moe_depths(cfg):
    """The depths of a transformer's MoE layers (the last of each unit
    of ``moe.every``)."""
    if cfg.moe is None:
        return []
    e = cfg.moe.every
    return [d for d in range(cfg.n_layers) if d % e == e - 1]


class Recorder:
    """Wraps a model's ``prefill`` / ``decode_step`` (instance
    attributes, so the engine calls them): each call's logits' finite
    flag and bit checksum, the logits themselves (``keep``), the MoE
    routes it took (``record_routes``) or, with ``hand``, those of the
    reference (``routes``: one dict a call on rank 0, broadcast over
    ``mesh``).  With ``force`` each call returns the reference's logits
    (``forced``, rank 0's, broadcast) in place of its own, which it
    records: the engine then chooses the reference's tokens, so every
    call of a layout sees the reference's inputs (teacher forcing).
    Each call's own argmax over the real vocabulary (``own``) is kept
    before any forcing, for the ranks to compare."""

    def __init__(self, torch, model, keep=False, record_routes=False,
                 hand=False, routes=None, mesh=None, force=False,
                 forced=None):
        self.torch, self.model, self.keep = torch, model, keep
        self.flags, self.sums, self.logits, self.seen = [], [], [], []
        self.own = []
        self.hand, self.routes, self.mesh = hand, routes, mesh
        self.force, self.forced = force, forced
        self.record = record_routes
        for name in ("prefill", "decode_step"):
            setattr(model, name, self._wrap(getattr(type(model), name),
                                            name == "prefill"))

    def _wrap(self, fn, prefill):
        torch = self.torch

        def call(params, *a):
            i = len(self.flags)
            if self.hand:
                self.model.routes = self._routes_for(
                    i, a[0] if prefill else a[1], prefill)
            if self.record:
                self.model.seen_routes = {}
            if prefill:
                cache, logits = fn(self.model, params, *a)
            else:
                logits, cache = fn(self.model, params, *a)
            self.flags.append(torch.isfinite(logits).all())
            self.sums.append(cs.logits_sum(torch, logits))
            self.own.append(
                logits[:, :self.model.cfg.vocab_size].argmax(-1))
            if self.keep:
                self.logits.append(logits.clone())
            if self.record:
                self.seen.append(self.model.seen_routes)
                self.model.seen_routes = None
            if self.force:
                logits = self._forced(i, logits)
            return (cache, logits) if prefill else (logits, cache)
        return call

    def _forced(self, i, like):
        """Call i's reference logits: rank 0's, broadcast over the
        mesh."""
        import torch.distributed as dist
        t = (self.forced[i] if self.forced is not None
             else self.torch.empty_like(like))
        if self.mesh is not None and self.mesh.devices.size > 1:
            dist.broadcast(t, src=0, group=mesh_group(self.mesh))
        return t

    def _routes_for(self, i, tokens, prefill):
        """Call i's routes {depth: (B, S, k)}: rank 0's recorded ones,
        broadcast over the mesh (every rank knows the shape from its
        tokens)."""
        import torch.distributed as dist
        torch, cfg = self.torch, self.model.cfg
        B, S = tokens.shape[0], tokens.shape[1] if prefill else 1
        mine = self.routes[i] if self.routes is not None else None
        out = {}
        for depth in moe_depths(cfg):
            t = (mine[depth].contiguous() if mine is not None else
                 torch.empty((B, S, cfg.moe.top_k), dtype=torch.long,
                             device=tokens.device))
            if self.mesh is not None and self.mesh.devices.size > 1:
                dist.broadcast(t, src=0, group=mesh_group(self.mesh))
            out[depth] = t
        return out

    def detach(self):
        """The model's own methods back (a profiled step is not a call of
        the traffic)."""
        for name in ("prefill", "decode_step"):
            delattr(self.model, name)

    def finite(self):
        return bool(self.torch.stack(self.flags).all().item())

    def own_tokens(self):
        """Every call's own argmax, in call order, on the host."""
        return self.torch.cat(self.own).tolist()

    def digest(self):
        return cs.logits_digest(self.torch, self.sums)


class Server:
    """One run on this rank: the reference (rank 0) and each layout."""

    def __init__(self, run, rank, dev, cpu):
        import torch
        self.torch, self.run, self.rank, self.dev, self.cpu = (
            torch, run, rank, dev, cpu)
        self.cfg = run_config(run, cpu)
        self.traffic = CPU_ENGINE if cpu else run.traffic
        self.max_len = CPU_MAX_LEN if cpu else MAX_LEN
        self.long_len = CPU_LONG_LEN if cpu else run.long_len

    # ------------------------------------------------------------ driving
    def serve(self):
        import torch.distributed as dist
        from repro_torch import device as rdev
        run, torch = self.run, self.torch
        res = {"launches_want": self.launches_want(),
               "dtype": self.cfg.dtype, "layouts": []}
        ref = None
        if run.reference and self.rank == 0:
            t0 = time.perf_counter()
            ref = self.one(None, keep=True)
            res["reference"] = {k: ref[k] for k in ref if not k.startswith(
                "_")}
            res["reference"]["seconds"] = time.perf_counter() - t0
            if self.shadow():
                bf16 = self.cfg
                self.cfg = bf16.replace(dtype="float32")
                f32 = self.one(None, keep=True, ref=ref, force=True)
                self.cfg = bf16
                res["reference"]["against_f32"] = compare(
                    torch, ref["_logits"], f32.pop("_logits"),
                    bf16.vocab_size)
        dist.barrier()
        for shape in run.layouts:
            from repro_torch.launch.mesh import make_process_submesh
            mesh = make_process_submesh(shape, AXES, self.dev)
            rows = []
            for _ in range(2 if run.repeat else 1):
                if mesh is None:
                    rows.append(None)
                    continue
                row = self.one(mesh, keep=ref is not None, ref=ref,
                               force=run.reference)
                if ref is not None:
                    row.update(compare(torch, row.pop("_logits"),
                                       ref["_logits"], self.cfg.vocab_size))
                    row["tokens_equal_to_reference"] = (
                        row["generated"] == ref["generated"])
                    row["bit_equal_to_reference"] = (
                        row["tokens_equal_to_reference"]
                        and row["logits_digest"] == ref["logits_digest"])
                row.pop("_logits", None)
                row.pop("_routes", None)
                rows.append(row)
            free(torch, self.dev)
            dist.barrier()
            if rows[0] is None:
                continue
            row = rows[0]
            if run.repeat:
                row["repeat_tokens_equal"] = (rows[1]["generated"]
                                              == row["generated"])
                row["repeat_launches"] = rows[1]["launches"]
            res["layouts"].append(row)
        rdev.reset_launch_counts()
        return res

    def shadow(self):
        """Whether rank 0 serves the reference's tokens again in f32: a
        bf16 run with a layout over more than one card."""
        return self.cfg.dtype != "float32" and any(
            math.prod(shape) > 1 for shape in self.run.layouts)

    def launches_want(self):
        """Kernel launches a run of the traffic makes on every rank: E
        once a prefill per attention layer (on the rank's heads or
        rows), A once a prefill per mamba layer, none a decode step;
        none on the CPU."""
        cfg, run = self.cfg, self.run
        if self.cpu or run.kind == "cell":
            return {}
        n = 1 if run.kind == "encdec" else self.traffic[0]
        if cfg.family == "encdec":
            attn, ssd = cfg.enc_layers, 0
        elif cfg.family == "ssm":
            attn, ssd = 0, cfg.n_layers
        elif cfg.family == "hybrid":
            attn, ssd = cfg.n_layers // cfg.shared_attn_every, cfg.n_layers
        else:
            attn, ssd = cfg.n_layers, 0
        tc = cfg.dtype == "bfloat16"     # the tensor-core route
        want = {"flash_attention": n * attn,
                "flash_attention_tc": n * attn * tc, "ssd_scan": n * ssd}
        return {k: v for k, v in want.items() if v}

    def model_on(self, mesh):
        """(model, parameters) of this run on ``mesh`` (None: one card):
        the plan of the run's shape, the parameters drawn and cut to the
        rank's model-local leaves (the cell: drawn whole, cut to the
        training layout and gathered at load, ``load_serving``)."""
        from repro_torch.configs.base import ShapeCfg
        from repro_torch.distributed import parallel as par
        from repro_torch.distributed.rules import make_plan
        from repro_torch.models.zoo import get_model
        torch, cfg, run = self.torch, self.cfg, self.run
        if run.kind == "cell":
            shape = ShapeCfg("long_500k", self.long_len, 1, "decode")
        else:
            slots = (cs.ENCDEC_BATCH if run.kind == "encdec"
                     else self.traffic[1])
            shape = ShapeCfg("custom", self.max_len, slots, "decode")
        plan = None if mesh is None else make_plan(cfg, mesh, shape)
        model = get_model(cfg, plan)
        if run.draw == "init":
            full = model.init(torch.Generator(self.dev).manual_seed(0))
            if plan is None:
                return model, full
            if run.kind == "cell":
                sh = par.shard_tree(full, model.param_specs(), mesh)
                del full
                return model, model.load_serving(sh)
            sh = par.shard_tree(full, model.serve_specs(), mesh)
            del full
            return model, model.load_local(sh)
        specs = None if plan is None else model.serve_specs()
        return model, model.load_local(tm.draw_params(
            torch, model, 0, self.dev, specs, mesh))

    def one(self, mesh, keep=False, ref=None, force=False):
        """Serve the run's traffic once on ``mesh`` (None: one card,
        without a plan): this rank's record; rank 0's also carries the
        logits (``_logits``) and, for a reference of a routes run, the
        routes (``_routes``).  ``force``: on the reference's tokens (rank
        0's ``ref``), its routes handed across for a routes run."""
        import torch.distributed as dist
        from repro_torch import device as rdev
        torch, run = self.torch, self.run
        free(torch, self.dev)
        cuda = self.dev.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model, params = self.model_on(mesh)
        load_s = time.perf_counter() - t0
        ref = ref or {}
        rec = Recorder(torch, model, keep=keep and self.rank == 0,
                       record_routes=run.routes and mesh is None,
                       hand=run.routes and force, routes=ref.get("_routes"),
                       mesh=mesh, force=force, forced=ref.get("_logits"))
        rdev.reset_launch_counts()
        drive = {"engine": self.engine, "encdec": self.encdec,
                 "cell": self.cell}[run.kind]
        with torch.no_grad():
            row, cache, step = drive(model, params)
            if cuda:
                torch.cuda.synchronize()
            counts = {k: v for k, v in rdev.launch_counts().items() if v}
            rec.detach()
            # the reference runs on rank 0 alone: no profile
            row["profile"] = (profile_call(torch, step, mesh)
                              if cuda and mesh is not None
                              else "not measured")
        row.update(
            layout="one-card" if mesh is None else
            "x".join(str(mesh.shape[a]) for a in AXES),
            launches=counts, logits_finite=rec.finite(),
            logits_digest=rec.digest(), load_s=load_s,
            param_bytes=sum(p.numel() * p.element_size()
                            for p in model.parameters()),
            cache_bytes=sum(c.numel() * c.element_size()
                            for c in cache.values()),
            peak_memory_bytes=(torch.cuda.max_memory_allocated(self.dev)
                               if cuda else None))
        if mesh is not None and mesh.devices.size > 1:
            # the tokens each rank chose from its own logits (forced
            # logits make the engine's tokens equal by construction)
            mine = (row["generated"], rec.own_tokens())
            every = [None] * mesh.devices.size
            dist.all_gather_object(every, mine, group=mesh_group(mesh))
            row["ranks_agree"] = all(t == mine for t in every)
        if rec.logits:
            row["_logits"] = rec.logits
        if rec.record:
            row["_routes"] = rec.seen
        del model, params, cache, rec
        return row

    def engine(self, model, params):
        """The traffic through ``Engine``, requests drawn as
        ``launch.serve.serve`` draws them (seed 0)."""
        import numpy as np
        from repro_torch.serving.engine import Engine, Request
        torch = self.torch
        requests, slots, new, lens = self.traffic
        eng = Engine(model, params, slots=slots, max_len=self.max_len)
        rng = np.random.default_rng(0)
        for i in range(requests):
            prompt = rng.integers(0, self.cfg.vocab_size,
                                  size=lens[i % len(lens)], dtype=np.int32)
            eng.submit(Request(rid=i, prompt=prompt, max_new_tokens=new))
        done = eng.run_until_drained()
        by_len = {}
        for n, sec in eng.prefill_s:
            by_len.setdefault(n, []).append(sec * 1e3)
        ticks = [t * 1e3 for t in eng.tick_s]
        row = {"generated": {str(r.rid): r.tokens for r in done},
               "requests": len(done), "slots": slots,
               "prefill_ms_by_prompt_len": by_len,
               "decode_ticks": len(ticks),
               "decode_tick_ms_median": statistics.median(ticks),
               "decode_tick_ms_mean": statistics.fmean(ticks),
               **eng.stats()}
        tok = torch.zeros(slots, dtype=torch.long, device=self.dev)

        def step():
            model.decode_step(params, eng.cache, tok, self.max_len - 2)
        return row, eng.cache, step

    def encdec(self, model, params):
        """A prefill of ``ENCDEC_BATCH`` frame sequences, then greedy
        decode steps (``chip_smoke.phase_serve_encdec``'s run)."""
        torch, cfg = self.torch, self.cfg
        B, F, n = ((2, 16, 4) if self.cpu else
                   (cs.ENCDEC_BATCH, cs.ENCDEC_FRAMES, cs.ENCDEC_STEPS))
        frames = torch.randn((B, F, cfg.d_model), device=self.dev,
                             generator=torch.Generator(self.dev).manual_seed(
                                 0))
        sync = self.sync
        t0 = time.perf_counter()
        cache, logits = model.prefill(params, frames, n + 8)
        tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)
        sync()
        pre_ms = (time.perf_counter() - t0) * 1e3
        toks, step_ms = [tok], []
        for i in range(n):
            t0 = time.perf_counter()
            logits, cache = model.decode_step(params, cache, tok, i + 1)
            tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            toks.append(tok)
        tokens = torch.stack(toks, 1).cpu().tolist()
        row = {"generated": {str(b): t for b, t in enumerate(tokens)},
               "batch": B, "frames": F, "decode_steps": n,
               "prefill_ms": pre_ms, "decode_step_ms_median":
               statistics.median(step_ms),
               "decode_tokens_per_s": B * n / (sum(step_ms) / 1e3)}

        def step():
            model.decode_step(params, cache, tok, n + 1)
        return row, cache, step

    def cell(self, model, params):
        """JAX's long_500k decode cell: a batch of 1 over a cache of
        ``long_len`` positions drawn from the seed (``fill_cache``), four
        decode steps near its end, then four from ``LONG_EARLY`` (inside
        rank 0's block) on tokens from seeded numpy."""
        import numpy as np
        torch, cfg = self.torch, self.cfg
        cache = model.init_cache(1, self.long_len)
        self.fill_cache(model, cache)
        steps = ((self.long_len - 4, 4), (2, 2) if self.cpu else
                 (LONG_EARLY, 4))
        rng = np.random.default_rng(0)
        toks, step_ms = [], []
        for first, n in steps:
            for pos in range(first, first + n):
                tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, 1),
                                      device=self.dev)
                t0 = time.perf_counter()
                logits, cache = model.decode_step(params, cache, tok, pos)
                toks.append(int(torch.argmax(logits[0, :cfg.vocab_size])))
                step_ms.append((time.perf_counter() - t0) * 1e3)
        row = {"generated": {"0": toks}, "cache_positions": self.long_len,
               "positions": [list(range(a, a + n)) for a, n in steps],
               "decode_step_ms": step_ms,
               "decode_step_ms_median": statistics.median(step_ms)}
        tok = torch.zeros(1, dtype=torch.long, device=self.dev)

        def step():
            model.decode_step(params, cache, tok, self.long_len - 1)
        return row, cache, step

    def fill_cache(self, model, cache):
        """Each cache leaf from the seed: the attention caches in chunks
        of ``LONG_CHUNK`` positions, each from a generator of its own
        (``train_mesh.seed_of(leaf, group, chunk)``), this rank drawing
        the chunks of its block; the SSM leaves whole."""
        torch = self.torch
        cut = model.cache_cut
        chunk = CPU_LONG_CHUNK if self.cpu else LONG_CHUNK
        for name, c in cache.items():
            if not name.startswith("attn_"):
                g = torch.Generator(self.dev).manual_seed(tm.seed_of(name))
                c.copy_(torch.randn(c.shape, generator=g, device=self.dev))
                continue
            first = 0 if cut is None else cut.index * c.shape[2]
            for grp in range(c.shape[0]):
                for s in range(0, c.shape[2], chunk):
                    g = torch.Generator(self.dev).manual_seed(
                        tm.seed_of(name, grp, (first + s) // chunk))
                    blk = c[grp, :, s:s + chunk]
                    blk.copy_(torch.randn(blk.shape, generator=g,
                                          device=self.dev))

    def sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize()


def compare(torch, logits, ref, vocab):
    """Every call's logits (on the reference's tokens) against the
    reference's, over the real vocabulary: the largest |difference| over
    the reference's largest |logit|, the first call that differs in a
    bit, and the rows whose argmax differs from the reference's (each
    with the reference's margin between its choice and that argmax,
    over the same largest |logit|: a near tie where it is below the
    error)."""
    if len(logits) != len(ref):
        return {"max_rel_logit_err": None, "calls": len(logits),
                "reference_calls": len(ref)}
    err = scale = 0.0
    first, margins, rows = None, [], 0
    for i, (a, b) in enumerate(zip(logits, ref)):
        if a.shape != b.shape:
            return {"max_rel_logit_err": None, "calls_differ": True}
        if first is None and not torch.equal(a, b):
            first = i
        a, b = a[:, :vocab], b[:, :vocab]
        err = max(err, float((a - b).abs().max()))
        scale = max(scale, float(b.abs().max()))
        mine, theirs = a.argmax(-1), b.argmax(-1)
        rows += mine.numel()
        for r in (mine != theirs).nonzero().flatten().tolist():
            margins.append(float(b[r, theirs[r]] - b[r, mine[r]]))
    scale = max(scale, 1e-30)
    return {"max_rel_logit_err": err / scale, "calls": len(logits),
            "first_call_not_bit_equal": first, "argmax_rows": rows,
            "argmax_differs": len(margins),
            "argmax_differs_max_margin": max(margins, default=0.0) / scale}


def profile_call(torch, fn, mesh):
    """One more decode step under the profiler, every rank of ``mesh`` at
    once (``train_mesh.device_profile``): wall ms, device busy ms and
    idle share, NCCL ms.  The step and the profiler are warmed first, so
    a rank's first profiler start (seconds) is not another rank's wait
    in a collective."""
    import torch.distributed as dist
    fn()                                    # warm: the same shapes
    with cs.padded_profile(0.0):
        pass
    torch.cuda.synchronize()
    if mesh.devices.size > 1:
        dist.barrier(group=mesh_group(mesh))
    prof = tm.device_profile(torch, fn)
    return {k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                 "device_idle_share", "nccl_ms",
                                 "gemm_ms", "top_kernels")}


def tolerance(res):
    """A split's largest logit error over the reference's largest: f32
    ``F32_LOGIT_TOL``; bf16 ``SHADOW_FACTOR`` times the one card's own
    bf16 error (its shadow's), None without a shadow."""
    if res["dtype"] == "float32":
        return F32_LOGIT_TOL
    shadow = res["reference"].get("against_f32") or {}
    err = shadow.get("max_rel_logit_err")
    return None if err is None else SHADOW_FACTOR * err


def gate_run(res, rank, world):
    """One run's gates on this rank, what missed: exact launches; every
    logit finite; every rank of a layout the same tokens; a repeat the
    same tokens and launches; on rank 0 against the reference, one card
    (a (1, 1) layout) bit-equal, more cards the logits within
    ``tolerance`` of the reference's largest and every token the
    reference's but at a near tie.  Every rank of a layout the same
    tokens: those the engine emitted and each call's own argmax."""
    missed = []

    def check(ok, msg):
        if not ok:
            missed.append(msg)
    name = f"serve_mesh {res['name']}"
    want = res["launches_want"]
    ref = res.get("reference")
    rows = res["layouts"] + ([dict(ref, layout="reference")] if ref else [])
    for row in rows:
        what = f"{name} {row['layout']} rank {rank}"
        check(row["launches"] == want, f"{what}: launches "
              f"{row['launches']}, want {want}")
        check(row["logits_finite"], f"{what}: non-finite logits")
        check(row.get("ranks_agree", True), f"{what}: ranks disagree on "
              f"the tokens")
        if "repeat_tokens_equal" in row:
            check(row["repeat_tokens_equal"]
                  and row["repeat_launches"] == want,
                  f"{what}: a second run gave other tokens or launches")
        if ref is None or row is rows[-1] or rank != 0:
            continue
        if row["layout"] == "1x1":
            check(row["bit_equal_to_reference"], f"{what}: not bit-equal "
                  f"to the one-card run (tokens equal: "
                  f"{row['tokens_equal_to_reference']}, first call that "
                  f"differs: {row.get('first_call_not_bit_equal')}, logits "
                  f"{row.get('max_rel_logit_err')} of the largest)")
            continue
        err = row.get("max_rel_logit_err")
        tol = tolerance(res)
        check(err is not None and tol is not None and err <= tol,
              f"{what}: logits {err} of "
              f"the reference's largest (at most {tol})")
        check(err is not None and row["argmax_differs_max_margin"]
              <= 2 * err, f"{what}: {row.get('argmax_differs')} tokens "
              f"differ from the reference's at a margin of "
              f"{row.get('argmax_differs_max_margin')}, beyond a near tie")
    return missed


if __name__ == "__main__":
    main()
