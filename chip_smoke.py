#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    PYTHONPATH=src python3 chip_smoke.py

Phases, each printing JSON lines:

1. device   -- the card's name and power limit (nvidia-smi);
2. build    -- the three CUDA kernels compiled from
               ``src/repro_torch/csrc``, one ``nvcc`` each, in parallel;
3. gat      -- the GAT forward kernel against its plain PyTorch version,
               at the main path's shapes and at edge-case graph sizes;
               gat_path: the 4 launches of one BERT population forward;
4. gat_bwd  -- the GAT backward kernel against its plain version at the
               critic's and the actor's shapes and the edge cases, and
               launched twice for bit-equal (deterministic) gradients;
               gat_path_bwd: the 8 launches of one BERT SAC step;
5. memsim   -- the simulator kernel against its plain version on all 7
               zoo graphs (tiers and eps bit-equal);
6. slice    -- the EA-mode search on BERT and ResNet-50 (400 steps),
               the "egrl"-mode search on BERT and ResNet-50 (400 steps)
               and a "pg"-mode run on ResNet-50 (60 steps); the launch
               counters are reset just before each run and read just
               after it, and must match the counts the path implies;
7. profile  -- device time by kernel over 3 EA-mode and 1 "egrl"-mode
               BERT generations;
8. kernels  -- per kernel: launches in the BERT "egrl" run (and the EA
               run), error, time on the card, plain time, bound and
               library time.

Then the nvidia-smi line and, last, ``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero before the last line.  It needs
CUDA and the repository's sources: alone, or without a card, it fails.
"""
import json
import os
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, fp32
# non-tensor-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# fp32 operations per (edge, head) of GAT attention with head dim 32:
# add, leaky-relu multiply, max, subtract, exp, denominator add, and a
# multiply-add per feature
GAT_OPS_PER_EDGE_HEAD = 6 + 2 * 32
# ... and of its gradient: alpha recomputed (add, compare, multiply,
# subtract, exp, divide), a multiply-add per feature for dz and for the
# dot product g_i . z_j, then dpre and its two sums
GAT_BWD_OPS_PER_EDGE_HEAD = 6 + 2 * 2 * 32 + 4
# per (row, head): the dot product g_i . out_i
GAT_BWD_OPS_PER_ROW_HEAD = 2 * 32


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, reps, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, ops):
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    check(out, "nvidia-smi printed nothing")
    return out.splitlines()[0]


# ------------------------------------------------------------- GAT kernel
def gat_inputs(torch, gen, B, N, adj):
    dev = "cuda"
    z = torch.randn((B, N, 128), generator=gen, device=dev)
    es = torch.randn((B, N, 4), generator=gen, device=dev)
    ed = torch.randn((B, N, 4), generator=gen, device=dev)
    return z, es, ed, adj.contiguous()


def gat_compare(torch, ops, z, es, ed, adj):
    out, m, l = ops.gat_mp(z, es, ed, adj)
    po, pm, pl = ops.gat_mp_plain(z, es, ed, adj)
    torch.cuda.synchronize()
    err = (out - po).abs().max().item()
    l_rel = ((l - pl).abs() / pl.abs()).max().item()
    m_eq = bool(torch.equal(m, pm))
    check(err <= 2e-5, f"gat out error {err} > 2e-5")
    check(m_eq, "gat m differs from the plain version")
    check(l_rel <= 1e-5, f"gat l relative error {l_rel} > 1e-5")
    return err, l_rel


def sdpa_call(torch, z, es, ed, adj):
    """One scaled_dot_product_attention call computing the same function
    (zero q/k, the dense masked score tensor as additive mask), timed as
    a yardstick only."""
    import torch.nn.functional as F
    B, N, D = z.shape
    H = es.shape[-1]
    pre = es[:, :, None, :] + ed[:, None, :, :]
    s = torch.where(pre >= 0, pre, 0.2 * pre)
    s = torch.where(adj.bool()[..., None], s, -1e30).permute(0, 3, 1, 2)
    mask = s.contiguous()                                  # (B, H, N, N)
    q = torch.zeros((B, H, N, D // H), device=z.device)
    v = z.view(B, N, H, D // H).transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(q, q, v, attn_mask=mask)


def sdpa_bwd_call(torch, z, es, ed, adj, g):
    """The backward of ``sdpa_call`` with the dense masked score tensor
    as a differentiable additive mask: gradients for v (= dz) and for the
    mask (the pre-softmax scores).  Timed as a yardstick only."""
    import torch.nn.functional as F
    B, N, D = z.shape
    H = es.shape[-1]
    pre = es[:, :, None, :] + ed[:, None, :, :]
    s = torch.where(pre >= 0, pre, 0.2 * pre)
    mask = torch.where(adj.bool()[..., None], s, -1e30).permute(
        0, 3, 1, 2).contiguous().requires_grad_()
    q = torch.zeros((B, H, N, D // H), device=z.device)
    v = z.detach().view(B, N, H, D // H).transpose(1, 2).requires_grad_()
    out = F.scaled_dot_product_attention(q, q, v, attn_mask=mask)
    go = g.view(B, N, H, D // H).transpose(1, 2)
    return lambda: torch.autograd.grad(out, (v, mask), go,
                                       retain_graph=True)


def gat_bwd_compare(torch, ops, args):
    """The backward kernel against ``gat_mp_bwd_plain`` on the same
    inputs: each gradient within 1e-5 of its largest element (f32 sums
    in another order; the plain version also adds the exact zeros of the
    dense (N, N) products), and a second launch bit-equal to the first."""
    got = ops.gat_mp_bwd(*args)
    again = ops.gat_mp_bwd(*args)
    want = ops.gat_mp_bwd_plain(*args)
    torch.cuda.synchronize()
    errs = {}
    for name, a, b in zip(("dz", "de_src", "de_dst"), got, want):
        scale = max(b.abs().max().item(), 1e-30)
        errs[name] = (a - b).abs().max().item()
        check(errs[name] <= 1e-5 * scale,
              f"gat_mp_bwd {name} error {errs[name]} > 1e-5 x {scale}")
        check(bool(torch.isfinite(a).all()), f"gat_mp_bwd {name} not finite")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "gat_mp_bwd: two launches differ")
    return errs


def gat_bwd_work(z, es, adj, m):
    """Bytes (every input read once, every output written once) and
    fp32 operations this call's data needs: per edge and head, per row
    and head, and for a row with no edge, a multiply-add per feature on
    every column."""
    B, N, D = z.shape
    H = es.shape[-1]
    nbytes = (3 * z.numel() + 4 * es.numel()) * 4 + adj.numel() \
        + (z.numel() + 2 * es.numel()) * 4
    edges = int(adj.sum().item()) * (B if adj.shape[0] == 1 else 1)
    masked = int((m <= -1e30).sum().item())        # (row, head) pairs
    ops = edges * H * GAT_BWD_OPS_PER_EDGE_HEAD \
        + B * N * H * GAT_BWD_OPS_PER_ROW_HEAD + masked * N * 2 * 32
    return nbytes, ops


def gat_work(z, es, adj):
    B, N, D = z.shape
    H = es.shape[-1]
    nbytes = (z.numel() + 2 * es.numel()) * 4 + adj.numel() \
        + (z.numel() + 2 * es.numel()) * 4
    edges = int(adj.sum().item()) * (B if adj.shape[0] == 1 else 1)
    ops = edges * H * GAT_OPS_PER_EDGE_HEAD
    dense_ops = B * N * N * H * GAT_OPS_PER_EDGE_HEAD
    return nbytes, ops, dense_ops


def phase_gat(torch, gen, ops, masks):
    bert_adj = masks["bert"]
    cases = []
    for n in (388, 194, 97):     # per-genome pooled adjacency, B = 16
        adj = torch.stack([
            bert_adj[idx][:, idx] for idx in
            (torch.randperm(388, generator=gen, device="cuda")[:n]
             for _ in range(16))])
        cases.append(("per-batch", 16, n, adj))
    cases.append(("shared", 16, 388, bert_adj[None]))
    for name in ("resnet50", "moe_transformer", "dense_cnn"):
        adj = masks[name][None].clone()
        if name == "moe_transformer":
            adj[0, 5] = False    # a row with every column masked
        cases.append((f"shared:{name}", 1, adj.shape[-1], adj))
    for kind, B, N, adj in cases:
        z, es, ed, adj = gat_inputs(torch, gen, B, N, adj)
        err, l_rel = gat_compare(torch, ops, z, es, ed, adj)
        row = {"phase": "gat", "adj": kind, "B": B, "N": N,
               "max_abs_err_out": err, "m_bit_equal": True,
               "max_rel_err_l": l_rel,
               "kernel_ms": time_ms(lambda: ops.gat_mp(z, es, ed, adj), 100),
               "plain_ms": time_ms(
                   lambda: ops.gat_mp_plain(z, es, ed, adj), 10),
               "library_ms": time_ms(sdpa_call(torch, z, es, ed, adj), 20)}
        emit(row)


def phase_gat_path(torch, gnn, ops, params, feats, adj, gen):
    """The four launches of one BERT population forward (P = 16), on the
    inputs the path itself gives the kernel."""
    pop = torch.stack([params.init_gnn(gen, feats.shape[1])
                       for _ in range(16)])
    captured = []

    def capture(z, es, ed, a):
        captured.append((z, es, ed, a))
        return ops.gat_mp(z, es, ed, a)

    gnn.gat_ops = types.SimpleNamespace(gat_mp=capture)
    try:
        gnn.population_logits(pop, feats, adj)
    finally:
        gnn.gat_ops = ops
    check([c[0].shape[1] for c in captured] == [388, 194, 97, 194],
          f"unexpected level sizes {[c[0].shape for c in captured]}")
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0,
           "ops": 0, "dense_ops": 0, "err": 0.0}
    for z, es, ed, a in captured:
        err, _ = gat_compare(torch, ops, z, es, ed, a)
        tot["err"] = max(tot["err"], err)
        tot["ms"] += time_ms(lambda: ops.gat_mp(z, es, ed, a), 200)
        tot["plain_ms"] += time_ms(lambda: ops.gat_mp_plain(z, es, ed, a), 10)
        tot["library_ms"] += time_ms(sdpa_call(torch, z, es, ed, a), 20)
        nbytes, nops, dense = gat_work(z, es, a)
        tot["bytes"] += nbytes
        tot["ops"] += nops
        tot["dense_ops"] += dense
    tot["bound_ms"], tot["bound_by"] = bound(tot["bytes"], tot["ops"])
    emit({"phase": "gat_path", "graph": "bert", "P": 16,
          "levels": [list(c[0].shape) for c in captured],
          "adj_batch": [c[3].shape[0] for c in captured], **tot})
    return tot


def gat_bwd_inputs(torch, ops, gen, B, adj):
    N = adj.shape[-1]
    z, es, ed, adj = gat_inputs(torch, gen, B, N, adj)
    out, m, l = ops.gat_mp(z, es, ed, adj)
    g = torch.randn((B, N, 128), generator=gen, device="cuda")
    return z, es, ed, adj, m, l, out, g


def phase_gat_bwd(torch, gen, ops, masks):
    """The backward kernel at the critic's shape (B = 24, one shared
    BERT mask), the actor's four level shapes (B = 1: the BERT mask, then
    pooled masks of 194, 97 and 194 nodes), and edge cases: a row with
    every column masked (moe_transformer, N = 1043), the densest graph
    (dense_cnn, N = 1010) and a mask that is not symmetric."""
    bert_adj = masks["bert"]

    def pooled(n):
        idx = torch.randperm(388, generator=gen, device="cuda")[:n]
        return bert_adj[idx][:, idx][None].contiguous()

    moe = masks["moe_transformer"][None].clone()
    moe[0, 5] = False            # a row with every column masked
    asym = torch.rand((2, 300, 300), generator=gen, device="cuda") < 0.02
    check(not torch.equal(asym, asym.transpose(1, 2)), "mask is symmetric")
    cases = [("critic:bert", 24, bert_adj[None]),
             ("actor:level0", 1, bert_adj[None]),
             ("actor:level1", 1, pooled(194)), ("actor:level2", 1, pooled(97)),
             ("actor:level3", 1, pooled(194)),
             ("all-masked-row:moe_transformer", 1, moe),
             ("dense_cnn", 1, masks["dense_cnn"][None]),
             ("asymmetric", 2, asym)]
    for kind, B, adj in cases:
        args = gat_bwd_inputs(torch, ops, gen, B, adj)
        errs = gat_bwd_compare(torch, ops, args)
        if kind.startswith("all-masked"):
            check(bool((args[4][0, 5] <= -1e30).all()),
                  "the masked row has a finite max")
        z, es, ed, a, m, l, out, g = args
        emit({"phase": "gat_bwd", "case": kind, "B": B, "N": a.shape[-1],
              "mask_batch": a.shape[0], "max_abs_err": errs,
              "deterministic": True,
              "kernel_ms": time_ms(lambda: ops.gat_mp_bwd(*args), 50),
              "plain_ms": time_ms(lambda: ops.gat_mp_bwd_plain(*args), 5),
              "library_ms": time_ms(sdpa_bwd_call(torch, z, es, ed, a, g),
                                    10)})


def phase_gat_path_bwd(torch, np, ops, sac, replay, feats, adj, gen):
    """The 8 backward launches of one SAC step on BERT, on the inputs
    the step itself gives the kernel: 2 from the critic loss (B = 24),
    2 from the critic on the actor's soft action and 4 from the actor's
    levels (B = 1)."""
    learner = sac.SACLearner(feats, adj, generator=gen)
    buf = replay.ReplayBuffer(feats.shape[0], seed=0)
    buf.add_batch(np.random.default_rng(0).integers(
        0, 3, (48, feats.shape[0], 2)), np.full(48, 5.0, np.float32))
    captured = []
    launch = ops._launch_bwd    # behind the wrapper: its counter still counts

    def capture(*args):
        captured.append(args)
        return launch(*args)

    ops._launch_bwd = capture
    try:
        learner.update(buf, 1)
    finally:
        ops._launch_bwd = launch
    shapes = sorted((c[0].shape[0], c[0].shape[1]) for c in captured)
    check(shapes == sorted([(24, 388)] * 2 + [(1, 388)] * 3
                           + [(1, 194)] * 2 + [(1, 97)]),
          f"unexpected backward shapes {shapes}")
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0,
           "ops": 0, "err": 0.0}
    for args in captured:
        errs = gat_bwd_compare(torch, ops, args)
        tot["err"] = max(tot["err"], *errs.values())
        z, es, ed, a, m, l, out, g = args
        tot["ms"] += time_ms(lambda: ops.gat_mp_bwd(*args), 100)
        tot["plain_ms"] += time_ms(lambda: ops.gat_mp_bwd_plain(*args), 5)
        tot["library_ms"] += time_ms(sdpa_bwd_call(torch, z, es, ed, a, g),
                                     10)
        nbytes, nops = gat_bwd_work(z, es, a, m)
        tot["bytes"] += nbytes
        tot["ops"] += nops
    tot["bound_ms"], tot["bound_by"] = bound(tot["bytes"], tot["ops"])
    emit({"phase": "gat_path_bwd", "graph": "bert", "launches": len(captured),
          "shapes": [[c[0].shape[0], c[0].shape[1], c[3].shape[0]]
                     for c in captured], **tot})
    return tot


# ------------------------------------------------------- simulator kernel
def memsim_mappings(torch, g, heuristic_mapping, gen):
    n = g.n
    rand = torch.randint(0, 3, (16, n, 2), generator=gen, device="cuda")
    fixed = [torch.as_tensor(heuristic_mapping(g), device="cuda").int()] + [
        torch.full((n, 2), t, dtype=torch.int32, device="cuda")
        for t in (0, 1, 2)]
    return torch.cat([rand.int(), torch.stack(fixed)]).contiguous()


def phase_memsim(torch, zoo, sim, compiler, gen):
    path = None
    for name, make in zoo.WORKLOADS.items():
        g = make()
        sg = sim.build_sim_graph(g, "cuda")
        _, ref = compiler.compiler_reference(g)
        maps = memsim_mappings(torch, g, compiler.heuristic_mapping, gen)
        res = sim.evaluate_population(sg, maps, ref)
        plain = sim.evaluate_population_plain(sg, maps, ref)
        torch.cuda.synchronize()
        check(torch.equal(res["rectified"], plain["rectified"]),
              f"{name}: rectified tiers differ")
        check(torch.equal(res["eps"], plain["eps"]), f"{name}: eps differs")
        check(torch.equal(res["valid"], plain["valid"]),
              f"{name}: valid differs")
        rel = {k: ((res[k] - plain[k]).abs()
                   / plain[k].abs().clamp_min(1e-30)).max().item()
               for k in ("latency", "reward")}
        check(max(rel.values()) <= 1e-6, f"{name}: {rel} > 1e-6 rel")
        err = max((res[k] - plain[k]).abs().max().item()
                  for k in ("latency", "reward", "speedup"))
        row = {"phase": "memsim", "graph": name, "N": g.n, "P": 20,
               "W": sg.ring_init.shape[0], "tiers_eps_bit_equal": True,
               "latency_reward_bit_equal": all(
                   torch.equal(res[k], plain[k])
                   for k in ("latency", "reward")),
               "max_rel_err": rel, "max_abs_err": err,
               "spills": int((~res["valid"]).sum().item()),
               "kernel_ms": time_ms(
                   lambda: sim.evaluate_population(sg, maps, ref), 50),
               "plain_ms": time_ms(
                   lambda: sim.evaluate_population_plain(sg, maps, ref), 2,
                   warmup=1)}
        emit(row)
        if name == "bert":
            edges = int((sg.in_acts >= 0).sum().item())
            n, P = g.n, maps.shape[0]
            nbytes = sum(x.numel() * x.element_size() for x in (
                sg.weight_bytes, sg.weight_frac, sg.act_bytes, sg.flops,
                sg.ring_t, sg.ring_lc, sg.self_release, sg.in_acts,
                sg.total_bytes, maps)) + P * 5 * 4 + maps.numel() * 4
            # per (mapping, node): rectify 2 compares, 2 subtracts, 1
            # ring add, 3 release adds; latency 1 multiply, 3 divides,
            # 2 adds, max, overhead add, running sum; per fan-in edge a
            # divide and an add
            nops = P * (17 * n + 2 * edges)
            b_ms, b_by = bound(nbytes, nops)
            path = {"ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                    "bound_ms": b_ms, "bound_by": b_by, "err": err}
    return path


# ------------------------------------------------------------- the slice
def run_slice(torch, np, name, make, egrl, sim, compiler, rdev, mode="ea",
              steps=400):
    """EGRL(..., mode=mode).train() at ``steps`` steps; the launch
    counters are set to 0 just before it and read just after it, and
    must match what the path launches: per generation 4 forward GAT
    launches for the population and, outside "ea" mode, 4 for the PG
    rollout; per SAC step 8 forward and 8 backward GAT launches; one
    simulator launch per population and one for the PG rollouts per
    generation, plus the compiler reference's."""
    cfg = egrl.EGRLConfig(total_steps=steps, seed=0)
    graph = make()
    sac_s = [0.0]
    rdev.reset_launch_counts()
    t0 = time.perf_counter()
    algo = egrl.EGRL(graph, cfg, mode=mode, device="cuda")
    update = algo.learner.update

    def timed_update(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = update(*args, **kwargs)
        torch.cuda.synchronize()
        sac_s[0] += time.perf_counter() - t
        return out

    algo.learner.update = timed_update
    per_gen = algo.n_g + algo.n_b + (cfg.pg_rollouts if mode != "ea" else 0)
    algo.train(total_steps=per_gen)            # first generation
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    algo.train()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = rdev.launch_counts()
    gens = len(algo.history)
    sac_steps = algo.learner.opt_a["t"]
    pop = 1 if algo.n_g + algo.n_b else 0
    want = {"gat_mp": 4 * gens * (1 if algo.n_g else 0) + 8 * sac_steps
            + (4 * gens if mode != "ea" else 0),
            "gat_mp_bwd": 8 * sac_steps,
            "memsim": 1 + gens * (pop + (mode != "ea"))}
    check(counts == want, f"{name} {mode}: launches {counts}, the path "
          f"implies {want}")
    if mode != "ea":
        check(sac_steps == per_gen * sum("critic_loss" in h
                                         for h in algo.history),
              f"{name} {mode}: {sac_steps} SAC steps")
        check(len(algo.buffer) == algo.steps, "a rollout missed the buffer")
    # outcome check by the repo's own means: re-evaluate the best mapping
    # with the plain simulator on the host
    g = algo.g
    sg = sim.build_sim_graph(g, "cpu")
    _, ref = compiler.compiler_reference(g, "cpu")
    res = sim.evaluate_population_plain(
        sg, torch.as_tensor(algo.best_mapping)[None], ref)
    check(abs(res["reward"].item() - algo.best_reward)
          <= 1e-6 * abs(algo.best_reward),
          f"{name}: best reward {algo.best_reward} != re-evaluated "
          f"{res['reward'].item()}")
    logits = algo.best_policy_logits()
    check(tuple(logits.shape) == (g.n, 2, 3), f"{name}: logits shape")
    check(bool(torch.isfinite(logits).all()), f"{name}: non-finite logits")
    check(np.isfinite(algo.best_reward), f"{name}: non-finite best reward")
    last = algo.history[-1]
    if mode != "ea":
        check(all(np.isfinite(last[k]) for k in
                  ("critic_loss", "actor_loss", "entropy")),
              f"{name} {mode}: non-finite SAC losses {last}")
    return {"graph": name, "mode": mode, "nodes": g.n, "steps": algo.steps,
            "generations": gens,
            "split": {"n_g": algo.n_g, "n_b": algo.n_b, "e_g": algo.e_g,
                      "e_b": algo.e_b},
            "best_speedup": last["best_speedup"],
            "valid_frac_last": last["valid_frac"],
            "valid_frac_mean": float(np.mean(
                [h["valid_frac"] for h in algo.history])),
            "sac": {k: last[k] for k in ("critic_loss", "actor_loss",
                                         "entropy") if k in last},
            "launches": counts, "sac_steps": sac_steps,
            "bwd_launches_per_sac_step": (counts["gat_mp_bwd"] / sac_steps
                                          if sac_steps else None),
            "first_generation_ms": (t1 - t0) * 1e3,
            "mean_generation_ms_after_first": (t2 - t1) * 1e3
            / max(gens - 1, 1),
            "sac_update_ms_total": sac_s[0] * 1e3,
            "sac_step_ms": (sac_s[0] * 1e3 / sac_steps if sac_steps
                            else None)}


def phase_profile(torch, egrl, zoo, mode="ea", generations=3):
    """Device time by kernel over steady BERT generations
    (torch.profiler), against the host clock of the same window.  Two
    generations run first, so in "egrl" mode the buffer holds a batch
    and the profiled generations train."""
    from torch.profiler import ProfilerActivity, profile
    algo = egrl.EGRL(zoo.bert(), egrl.EGRLConfig(seed=1), mode=mode,
                     device="cuda")
    for _ in range(2):
        algo.generation()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(generations):
            algo.generation()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType
    kernels = []
    for evt in prof.key_averages():
        # device-side events only: a CPU op's device time repeats the
        # time of the kernels it launched
        if evt.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            kernels.append({"name": evt.key[:80], "calls": evt.count,
                            "device_ms": dev_us / 1e3})
    kernels.sort(key=lambda k: -k["device_ms"])
    busy = sum(k["device_ms"] for k in kernels)
    check(mode == "ea" or "critic_loss" in algo.history[-1],
          "the profiled generation did not train")
    emit({"phase": "profile", "graph": "bert", "mode": mode,
          "generations": generations, "wall_ms": wall_ms, "device_busy_ms": busy,
          "device_idle_share": (1.0 - busy / wall_ms) if kernels
          else "not measured", "top_kernels": kernels[:12]})


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        sys.exit("chip_smoke: src/repro_torch not found next to the script")
    sys.path.insert(0, SRC)
    from repro_torch import device as rdev
    from repro_torch.core import egrl, gnn, params, replay, sac
    from repro_torch.graphs import zoo
    from repro_torch.kernels import build
    from repro_torch.kernels.gat_mp import ops
    from repro_torch.memsim import compiler, simulator as sim

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(),
          "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # 2. build, every source in parallel
    t0 = time.perf_counter()
    rep = build.build(["gat_mp", "gat_mp_bwd", "memsim"])
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source": {k: {"seconds": v["seconds"], "cached": v["cached"],
                             "ptxas": [ln.strip() for ln in
                                       v["log"].splitlines()
                                       if "registers" in ln or "spill" in ln
                                       or "smem" in ln]}
                         for k, v in rep.items()}})

    gen = torch.Generator("cuda").manual_seed(0)
    masks = {name: torch.as_tensor(make().adjacency() > 0, device="cuda")
             for name, make in zoo.WORKLOADS.items()}

    # 3. GAT forward kernel against its plain version
    phase_gat(torch, gen, ops, masks)
    bert = zoo.bert()
    feats = torch.as_tensor(bert.features(), device="cuda")
    gat_path = phase_gat_path(torch, gnn, ops, params, feats, masks["bert"],
                              gen)

    # 4. GAT backward kernel against its plain version
    phase_gat_bwd(torch, gen, ops, masks)
    bwd_path = phase_gat_path_bwd(torch, np, ops, sac, replay, feats,
                                  masks["bert"], gen)

    # 5. simulator kernel against its plain version
    mem_path = phase_memsim(torch, zoo, sim, compiler, gen)

    # 6. the slice: each run between a reset and a read of the counters
    runs = {}
    for name, mode, steps in (("bert", "ea", 400), ("resnet50", "ea", 400),
                              ("bert", "egrl", 400),
                              ("resnet50", "egrl", 400),
                              ("resnet50", "pg", 60)):
        run = run_slice(torch, np, name, zoo.WORKLOADS[name], egrl, sim,
                        compiler, rdev, mode, steps)
        emit({"phase": "slice", **run})
        runs[name, mode] = run
    counts = runs["bert", "egrl"]["launches"]
    check(counts["gat_mp_bwd"] > 0, "the GAT backward never launched")
    check(counts["gat_mp"] > 0, "the GAT kernel never launched in the run")
    check(counts["memsim"] > 0, "the simulator kernel never launched")
    check(runs["bert", "egrl"]["bwd_launches_per_sac_step"] == 8,
          "not 8 backward launches per SAC step")
    for mode in ("ea", "egrl"):
        best = runs["resnet50", mode]["best_speedup"]
        check(best > 1.0, f"resnet50 {mode} best speedup {best} <= 1.0")
    check(runs["resnet50", "pg"]["sac_steps"] > 0, "pg mode never trained")

    # 7. profile
    phase_profile(torch, egrl, zoo)
    phase_profile(torch, egrl, zoo, mode="egrl", generations=1)

    # 8. kernels
    ea = runs["bert", "ea"]["launches"]
    emit({"kernels": [
        {"name": "gat_mp_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/gat_mp.cu",
         "replaces": "src/repro/kernels/gat_mp/gat_mp.py:35",
         "launches": counts["gat_mp"], "launches_ea": ea["gat_mp"],
         "max_abs_err": gat_path["err"],
         "ms": gat_path["ms"], "plain_ms": gat_path["plain_ms"],
         "bound_ms": gat_path["bound_ms"], "bound_by": gat_path["bound_by"],
         "library_ms": gat_path["library_ms"],
         "per": "one population forward: 4 launches, BERT, P=16"},
        {"name": "gat_mp_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/gat_mp_bwd.cu",
         "replaces": "src/repro/kernels/gat_mp/gat_mp.py:98",
         "launches": counts["gat_mp_bwd"], "launches_ea": ea["gat_mp_bwd"],
         "max_abs_err": bwd_path["err"],
         "ms": bwd_path["ms"], "plain_ms": bwd_path["plain_ms"],
         "bound_ms": bwd_path["bound_ms"], "bound_by": bwd_path["bound_by"],
         "library_ms": bwd_path["library_ms"],
         "per": "one SAC step: 8 launches, BERT, B=24 and B=1"},
        {"name": "memsim_evaluate", "route": "cuda",
         "source": "src/repro_torch/csrc/memsim.cu",
         "replaces": "src/repro/memsim/simulator.py:163",
         "launches": counts["memsim"], "launches_ea": ea["memsim"],
         "max_abs_err": mem_path["err"],
         "ms": mem_path["ms"], "plain_ms": mem_path["plain_ms"],
         "bound_ms": mem_path["bound_ms"], "bound_by": mem_path["bound_by"],
         "library_ms": None,
         "per": "one population: 1 launch, BERT, P=20"}],
        "launches_from": "the BERT egrl run (launches_ea: the BERT EA run)",
        "device": kind, "nvidia_smi": smi})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
