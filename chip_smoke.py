#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    PYTHONPATH=src python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  -- the card's name and power limit (nvidia-smi);
2. build   -- both CUDA kernels compiled from ``src/repro_torch/csrc``;
3. gat     -- the GAT kernel against its plain PyTorch version, at the
              main path's shapes and at edge-case graph sizes;
4. memsim  -- the simulator kernel against its plain version on all 7
              zoo graphs (tiers and eps bit-equal);
5. slice   -- the EA-mode EGRL search on BERT (400 steps), then on
              ResNet-50; launch counters are reset just before the BERT
              run and read just after it;
6. kernels -- per kernel: launches in the BERT run, error, time on the
              card, plain time, bound and library time.

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
def run_slice(torch, np, name, make, egrl, sim, compiler, rdev):
    """EGRL(..., mode="ea").train() at 400 steps; the launch counters
    are set to 0 just before it and read just after it."""
    cfg = egrl.EGRLConfig(total_steps=400, seed=0)
    graph = make()
    rdev.reset_launch_counts()
    t0 = time.perf_counter()
    algo = egrl.EGRL(graph, cfg, mode="ea", device="cuda")
    first_total = algo.n_g + algo.n_b
    algo.train(total_steps=first_total)        # first generation
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    algo.train()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = rdev.launch_counts()
    gens = len(algo.history)
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
    return {"graph": name, "nodes": g.n, "steps": algo.steps,
            "generations": gens,
            "split": {"n_g": algo.n_g, "n_b": algo.n_b, "e_g": algo.e_g,
                      "e_b": algo.e_b},
            "best_speedup": algo.history[-1]["best_speedup"],
            "valid_frac_last": algo.history[-1]["valid_frac"],
            "valid_frac_mean": float(np.mean(
                [h["valid_frac"] for h in algo.history])),
            "launches": counts,
            "first_generation_ms": (t1 - t0) * 1e3,
            "mean_generation_ms_after_first": (t2 - t1) * 1e3
            / max(gens - 1, 1)}


def phase_profile(torch, egrl, zoo):
    """Device time by kernel over 3 steady BERT generations
    (torch.profiler), against the host clock of the same window."""
    from torch.profiler import ProfilerActivity, profile
    algo = egrl.EGRL(zoo.bert(), egrl.EGRLConfig(seed=1), mode="ea",
                     device="cuda")
    for _ in range(2):
        algo.generation()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
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
    emit({"phase": "profile", "graph": "bert", "generations": 3,
          "wall_ms": wall_ms, "device_busy_ms": busy,
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
    from repro_torch.core import egrl, gnn, params
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

    # 2. build, both sources in parallel
    t0 = time.perf_counter()
    rep = build.build(["gat_mp", "memsim"])
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

    # 3. GAT kernel against its plain version
    phase_gat(torch, gen, ops, masks)
    bert = zoo.bert()
    feats = torch.as_tensor(bert.features(), device="cuda")
    gat_path = phase_gat_path(torch, gnn, ops, params, feats, masks["bert"],
                              gen)

    # 4. simulator kernel against its plain version
    mem_path = phase_memsim(torch, zoo, sim, compiler, gen)

    # 5. the slice
    bert_run = run_slice(torch, np, "bert", zoo.bert, egrl, sim, compiler,
                         rdev)
    counts = bert_run["launches"]
    check(counts["gat_mp"] > 0, "the GAT kernel never launched in the run")
    check(counts["memsim"] > 0, "the simulator kernel never launched")
    emit({"phase": "slice", **bert_run})
    rn = run_slice(torch, np, "resnet50", zoo.resnet50, egrl, sim, compiler,
                   rdev)
    emit({"phase": "slice", **rn})
    check(rn["best_speedup"] > 1.0,
          f"resnet50 best speedup {rn['best_speedup']} <= 1.0")

    phase_profile(torch, egrl, zoo)

    # 6. kernels
    emit({"kernels": [
        {"name": "gat_mp_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/gat_mp.cu",
         "replaces": "src/repro/kernels/gat_mp/gat_mp.py:35",
         "launches": counts["gat_mp"], "max_abs_err": gat_path["err"],
         "ms": gat_path["ms"], "plain_ms": gat_path["plain_ms"],
         "bound_ms": gat_path["bound_ms"], "bound_by": gat_path["bound_by"],
         "library_ms": gat_path["library_ms"],
         "per": "one generation: 4 launches, BERT, P=16"},
        {"name": "memsim_evaluate", "route": "cuda",
         "source": "src/repro_torch/csrc/memsim.cu",
         "replaces": "src/repro/memsim/simulator.py:163",
         "launches": counts["memsim"], "max_abs_err": mem_path["err"],
         "ms": mem_path["ms"], "plain_ms": mem_path["plain_ms"],
         "bound_ms": mem_path["bound_ms"], "bound_by": mem_path["bound_by"],
         "library_ms": None,
         "per": "one generation: 1 launch, BERT, P=20"}],
        "device": kind, "nvidia_smi": smi})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
