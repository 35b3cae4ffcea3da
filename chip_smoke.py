#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. device   -- the card's name and power limit (nvidia-smi);
2. build    -- the seven CUDA sources of ``src/repro_torch/csrc``
               compiled, one ``nvcc`` each, in parallel; each kernel's
               registers and spills printed (the SSD kernels, forward
               and backward, the simulator kernel and the attention
               backward's tensor-core kernels must not spill);
3. gat      -- the GAT forward kernel against its plain PyTorch version,
               at the main path's shapes and on edge-case masks (a
               column no row reaches, a row with every column set or
               masked, asymmetric per-batch masks, N = 1, a mask at an
               odd byte offset, uint8 values) and head counts (H = 1, 3,
               8); every block shape of ``ops.FWD_WARPS`` bit-equal to
               the default's out, m and l on each case, with its
               profiler device ms at the critic's and the population's
               level-0 shapes; gat_path:
               the 4 launches of one BERT population forward, per
               launch and in total; gat_zoo_mask: both GAT kernels on a
               zoo bucket's (G, N, N) masks shared by 16 genomes or by
               24 critic transitions, against their plain versions,
               every block shape bit-equal;
4. gat_bwd  -- the GAT backward kernel against its plain version at the
               critic's and the actor's shapes and the same edge cases,
               and launched twice for bit-equal (deterministic)
               gradients; every block shape of ``ops.BWD_SHAPES``
               bit-equal to the default's dz, de_src and de_dst, timed
               at the critic's and the actor's level-0 shapes;
               gat_path_bwd: the 8
               calls of one BERT SAC step;
5. memsim   -- the simulator kernel against its plain version on all 7
               zoo graphs at P = 1, 9, 20, 33 and at more blocks of 32
               mappings than the card has SMs (tiers, eps and valid
               bit-equal; latency and reward within 1e-6 rel); ``ms``,
               ``device_ms``, the roofline and latency bounds;
               memsim_zoo: the kernel's zoo entry (one launch a bucket)
               on the 7-graph zoo, "auto" (4 buckets) and "off" (1), at
               P = 1, 20, 21, 33, against its plain version, against
               the single-graph kernel graph by graph and with its
               padded slots zeroed, every output bit-equal;
6. slice    -- (the GAT kernels' block shapes tuned by ``core/gat_tune.py``
               on each launch key's first call; its timing launches
               counted apart, ``tuning_launches``, never as ``gat_mp``
               or ``gat_mp_bwd``) the EA-mode search on BERT and
               ResNet-50 (400 steps),
               the "egrl"-mode search on BERT and ResNet-50 (400 steps)
               and a "pg"-mode run on ResNet-50 (60 steps); the launch
               counters are reset just before each run and read just
               after it, and must match the counts the path implies;
               gat_tune: the block shapes chosen at the BERT and
               ResNet-50 levels' N, with each candidate's time;
               zoo: ``ZooEGRL`` on the 7-graph zoo at full width, 3 "ea"
               and 3 "egrl" generations with exact launch counts, then
               ``evaluate_gnn_zoo`` of the trained genome on BERT;
               shard: the search across several devices, its shards on
               distinct cards where there are enough, else side by side
               on cuda:0 (printed): ``EGRL`` on BERT in "egrl" mode at
               pop_shards 1, 2 and 3 from one seed, 3 generations, gated
               on identical mappings and replay contents, equal rewards
               and fitness, populations bit-equal or within 1e-6
               relative (the largest logit difference of the forward at
               P / S rows against P rows printed) and exact launches (4 S
               + 4 GAT and S + 1 simulator launches a generation, 8 + 8
               a SAC step); ``ZooEGRL`` on the 7 graphs, "egrl", with
               dispatch "async" against "off": bit-equal rewards,
               fitness and populations, ``run_zoo``'s launch counts,
               ``device_map()`` and ``measure()``'s per-bucket ms;
               ``autotune_bucket_k`` on the 7 graphs (K, c0, c1, probe
               ms) and one generation of a zoo built with "autotune";
               generation ms per S and async / off, 2 more generations
               each taken in turns.  Every other phase measures the
               one-device path on cuda:0: its drivers are built with
               pop_shards and dispatch "off" (the placement service's
               through ``REPRO_POP_SHARDS`` / ``REPRO_BUCKET_DISPATCH``),
               so its launch counts hold however many cards there are;
7. greedy   -- Greedy-DP at Figure 4's budget on BERT and ResNet-50:
               exact simulator launches, the final reward re-evaluated
               on the CPU, wall time and the simulator's device time;
8. profile  -- device time by kernel over 3 EA-mode and 1 "egrl"-mode
               BERT generations, and 1 "egrl"-mode generation of the
               7-graph zoo;
9. flash    -- the attention kernels against their plain version at
               every attention prefill shape of the serve phase
               (zamba2, qwen3-0.6b, qwen3-moe: G = 8, chameleon: G = 8;
               bf16) and serve_encdec's (seamless's encoder, B = 4,
               non-causal), in f32, without the causal mask, at S = 100
               (both heads), with a causal offset (Sq = 512, Sk =
               1024), cross-attention (non-causal, Sq = 4096 over Sk =
               2048 and Sq = 300 over Sk = 1024) and llama4's heads (G
               = 5); every bf16 case through both the tensor-core route
               and the fp32-core route, timed beside SDPA as a
               yardstick;
10. ssd     -- the SSD scan kernels against their plain version at every
               Mamba2 prefill shape of the serve phase (zamba2,
               mamba2-780m), at B = 2, at S < chunk, from an initial
               state (2 and 16 chunks) and at head dims 32 and 128,
               with dt and A drawn as Mamba2 initialises them (slow
               decay: the state passed between chunks shows in y), and
               once with fast decay (|cum| > 88 inside a chunk);
               ``ms`` (CUDA events), ``device_ms`` (profiler), the f32
               bound and the 3xTF32 tensor-core bound;
11. serve_check -- at full width in f32: zamba2 cut to 7 layers and
               qwen3-moe-30b-a3b cut to 2, a 512-token prefill and one
               decode step; seamless-m4t-medium cut to 2 + 2 layers, a
               prefill on 512 frames and 8 greedy decode steps; on the
               card (kernels) against the same on the CPU (plain
               versions), the MoE's CPU runs on the card's routes
               (``moe_block``'s routes seam; how many tokens' top-k
               sets the CPU picks differently on its own is printed);
12. serve   -- ``launch.serve.serve`` of zamba2-1.2b at its published
               config: 8 requests of 256 to 2048 tokens, 32 new tokens
               each, exact launch counts, run twice for equal tokens; then
               mamba2-780m (2 requests), qwen3-0.6b (zamba2's traffic:
               ``SERVE_MESH_TRAFFIC``), and, at full width cut in depth
               to fit f32 parameters, qwen3-moe-30b-a3b (16 of 48
               layers) and chameleon-34b (8 of 48), 2 requests each;
               serve_profile: device time by kernel over one 2048-token
               zamba2 prefill and 10 decode ticks; serve_encdec:
               seamless-m4t-medium at its published config, a prefill
               of 4 sequences of 2048 frames and 32 greedy decode
               steps, twice: exactly 6 attention launches a prefill and
               none a step, equal tokens, prefill and step ms;
12b. serve_mesh -- the port's models served over the visible cards,
               one process per card (``torch.distributed.run`` on
               ``tools/serve_mesh.py``, NCCL, the loopback): one card
               serves qwen3-0.6b's serve traffic at (1, 1) under a plan,
               bit-equal (tokens and every call's logits) to its
               one-card reference and to the serve phase's qwen3-0.6b
               run; on more cards the runs of ``RUNS`` (qwen3-0.6b at
               (1, 2) and (1, 4), mamba2-780m, seamless-m4t-medium, the
               zamba2-1.2b long_500k cell at (4, 1), qwen3-moe-30b-a3b at
               16 and 48 layers, qwen2.5-14b at 8 and 48 over three,
               each bf16 run beside an f32 twin) on the reference's
               tokens: exact launches per rank, finite logits, the ranks'
               tokens equal, a repeat equal, logits against the one-card
               run; the rest printed as not run;
14. placement -- ``launch.serve_placements.serve`` at the service's
               defaults (pop 8, batch 4, budget "auto", neighbour cache
               on, GNN 128 x 4 levels x 4 heads): every supported (arch,
               shape) of the ten registry ids over the serving shapes
               (classes 128, 256, 512 and 1024 all miss), then a Zipf
               tail of 48 requests; every result ok, each served mapping
               re-evaluated by the plain simulator on the CPU (latency
               within 1e-6 rel, speedup >= 1.0), the GAT and simulator
               launches exactly what the service's counters imply, a
               second fresh service and a "thread:2" one giving the same
               placements, the REPRO_OBS=jsonl trace passing
               ``tools/trace_report.py``'s gate, and a service restarted
               from the persisted directory answering the stream with 0
               evaluator calls and no launch, then re-scoring a one-node
               variant through the neighbour cache; placement_profile: device
               busy time and idle share of one class-1024 miss batch;
15. flash_bwd -- the attention backward kernels against their plain
               version at the train phase's shape (qwen3-0.6b, B 4, S
               4096, bf16, causal) and at f32 (h 16/32/64/128), bf16 h
               64, non-causal, S = 100, Sq < Sk with an offset, G = 1,
               B = 1, zamba2's heads at S = 4096, a ragged Sq = 300
               over Sk = 1000, the MoE and encdec train phases'
               attentions (qwen3-moe's row at S = 4096; seamless's
               encoder, decoder and cross-attention, Sq = 4096 over Sk
               = 2048), Sq = 300 over Sk = 1024 non-causal,
               llama4's and chameleon's heads, and qwen2.5-14b's
               sequence-parallel attention (Sq = S/3 over Sk = S = 3072
               at causal offsets S/3 and 2S/3), each launched twice for
               bit-equal
               gradients; bf16 on the tensor-core route, checked and
               timed on the fp32-core route too (``ms_fp32_cores``);
               the forward's lse against the plain lse, and the forward
               with lse bit-equal to the forward without; ``ms``,
               ``device_ms`` (at S = 4096 from windows of one call),
               ``plain_ms``, the bound and SDPA's backward
               (``library_ms``); ssd_bwd: the SSD scan's backward
               kernels (kernel F) against their plain version on every
               ssd case and at the train phase's two shapes (zamba2 and
               mamba2-780m, B 4, S 4096), with and without a final-state
               cotangent, within 1e-4 of each output's largest element,
               two launches bit-equal, ``ms``, ``device_ms`` (also by
               CUDA kernel), the 3xTF32 bound and ``plain_ms``;
               ssd_bwd_autograd: ``autograd.grad``
               through ``ssd_scan`` on CUDA inputs that require grad, one
               forward and one backward launch, against the plain
               version;
16. train_check -- qwen3-0.6b (2 layers), mamba2-780m (2 layers),
               zamba2-1.2b (7: a group and a tail layer),
               qwen3-moe-30b-a3b (2, the CPU on the card's routes) and
               seamless-m4t-medium (2 + 2, 512 frames) at full width
               in f32: the loss of a 512-token batch and every
               parameter's gradient on the card against the CPU (plain
               versions), exact launch counts;
17. train   -- ``launch.train.TrainLoop`` at the published configs of
               qwen3-0.6b, mamba2-780m and zamba2-1.2b (bf16
               activations, f32 parameters, remat "full", AdamW; the
               two SSMs cut in depth to 24 and 20 layers,
               ``TRAIN_SSM_LAYERS``) at S = 4096, global batch 4: 10
               steps straight, and 5 + a checkpoint + 5 in a restored
               loop, equal; exact launch counts a step
               (``step_launches``: qwen3 2 x 28 attention forward and 28
               backward; mamba2 48 SSD forward and 24 backward; zamba2
               38 and 20, and 6 attention forward and 3 backward; every
               attention launch on the tensor cores),
               step ms, tokens/s, the model-FLOPs share of the bf16 peak,
               peak memory; train_profile: device time by kernel and the
               idle share over 2 steps; then qwen3-moe-30b-a3b at full
               width cut to 4 layers (``TrainLoop``, 4 microbatches of
               one row: 8 + 4 attention launches each) and
               seamless-m4t-medium at its published config
               (``make_train_step`` on tokens (4, 4096) and frames (4,
               2048, 1024): 36 + 18), 10 steps each, and a second run
               of 5 steps from the same seed bit-equal to the first
               (losses and parameter checksums) in place of the
               restart;
18. train_mesh -- (after qwen3-0.6b's train phase) the port's models
               trained over the visible cards, one process per card
               (``torch.distributed.run`` on ``tools/train_mesh.py``,
               NCCL, the loopback; one launch per world size, and one
               of its own for the MoE's deepest cut): per run
               its one-card reference, then each (data, model) layout at
               published widths, B 4, 3 steps from seed 0 -- qwen3-0.6b
               (one card (1, 1); two (2, 1), (1, 2); four (4, 1), (1,
               4), (2, 2), and (1, 4) with its residual stream cut on S,
               Megatron-SP, also against (1, 4) without it); on four cards
               also mamba2-780m ((1, 4), (2, 2)), zamba2-1.2b,
               qwen3-moe-30b-a3b (expert parallel, 32 experts a rank, at
               4 layers and at 16 with no reference) and
               seamless-m4t-medium at (1, 4), and on three of them
               qwen2.5-14b's sequence-parallel attention at (1, 3), 4
               layers, S 3072 -- exact launches a step per rank, finite
               losses, and qwen3's checkpoint saved on one layout
               restored onto another (one card: a one-card loop); one card
               bit-equal to the one-card run (losses, parameter
               checksums, and qwen3's reference bit-equal to the train
               phase's run A), more within stated tolerances; a run that
               needs more cards than the host has is printed as not
               run; each run's gates checked as it ends, and what
               missed printed; per layout the median step ms,
               tokens/s, each rank's
               peak memory, shard bytes and NCCL ms, each rank's profile
               of a 4th step (device busy, NCCL, GEMM, attention and SSD
               ms), and the card count;
13. kernels -- (printed last) per kernel: launches in its slice's main
               path (the BERT "egrl" run, the zamba2 serve run, the zoo
               "egrl" run, the attention backward's the qwen3 train run,
               the SSD backward's the zamba2 train run; the simulator's
               also in Greedy-DP; every
               kernel's in the placement stream, ``launches_placement``;
               the GAT and simulator kernels' in the shard phase's run at
               3 pop shards, the zoo simulator's in its async dispatch
               run, ``launches_shard``),
               error, time on the card, plain time, bound and
               library time; for the GAT kernels both per launch (a
               launch is one call of the wrapper) and over their group (4
               forward launches, 8 backward calls); for attention also
               the qwen3 train run's launches (``launches_train``) and
               for attention and the SSD scan, forward and backward,
               those a step of each rank of each train_mesh layout
               (``launches_train_mesh``); for
               attention and the SSD scan, forward and backward, the SSM
               train runs' (``launches_train_ssm``); for attention the
               serve runs of qwen3-moe and chameleon, one serve_encdec
               prefill and the MoE and encdec train runs'
               (``launches_new_paths``); for attention and the SSD
               scan, each serve_mesh layout's per rank
               (``launches_serve_mesh``).

Each phase's seconds are printed as it ends (``phase_done``) and
together before the kernels line (``phase_seconds``, ``total_s``).
Device times come from ``tools/timing.py``: up to 3 padded profiles
(``*_tries`` on each row) are taken for one that recorded every launch;
failing that, the last one's mean per recorded launch is printed, with
its records (``*_records``).
Then the nvidia-smi line and, last, ``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero before the last line.  It needs
CUDA and the repository's sources: alone, or without a card, it fails.
"""
import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
sys.path.insert(0, os.path.join(ROOT, "tools"))

from timing import (PROFILE_TRIES, event_ms, kernel_ms,  # noqa: E402
                    padded_profile, profile_kernels, sm_clock_mhz)

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, fp32
# non-tensor-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# H100 SXM dense bf16 tensor-core FLOP/s (NVIDIA H100 data sheet, SXM
# part: 989 TFLOP/s dense, 1,979 with sparsity)
PEAK_BF16 = 989e12
# ... and dense TF32 tensor-core FLOP/s (the same data sheet: 494.7)
PEAK_TF32 = 494.7e12
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


def profiled(torch, fn, key="device_ms", reps=20):
    """{key: the profiler's device ms per call of ``fn`` over ``reps``
    calls (or "not measured"), key_by_kernel: that of each CUDA kernel,
    key_tries: the profiles it took; where no profile recorded every
    launch, key_records: the launches per kernel the last one recorded,
    of ``reps`` calls}."""
    per, tries, counts = kernel_ms(torch, fn, reps)
    ms = sum(per.values()) if per else "not measured"
    out = {key: ms, f"{key}_by_kernel": per, f"{key}_tries": tries}
    if isinstance(ms, str) or any(n % reps for n in counts.values()):
        out[f"{key}_records"] = counts
    return out


# host idle time on each side of a one-call window: late in this
# process, windows of one 2 ms call padded by tools/timing.py's 0.05 s
# recorded no kernel at all (PERF.md §7), while the train phase's 2 s
# window recorded every launch
ONE_CALL_PAD_S = 0.5


def one_call_windows(torch, fn, n_kernels, windows=PROFILE_TRIES + 2,
                     pad=ONE_CALL_PAD_S):
    """Device ms of one call of ``fn`` (after a warm-up call), from
    ``windows`` profiler windows of one call each, padded by ``pad``
    seconds.  A window counts only if it recorded each of the call's
    ``n_kernels`` CUDA kernels exactly once; the mean over those, or
    "not measured" if none did.  Also which windows counted and what
    each recorded."""
    fn()
    torch.cuda.synchronize()
    kept, records, by_kernel = [], [], {}
    for _ in range(windows):
        rec = profile_kernels(torch, fn, 1, pad)
        records.append({name: n for name, (_, n) in rec.items()})
        if len(rec) == n_kernels and all(n == 1 for _, n in rec.values()):
            kept.append(sum(ms for ms, _ in rec.values()))
            for name, (ms, _) in rec.items():
                by_kernel[name] = by_kernel.get(name, 0.0) + ms
    return {"device_ms": sum(kept) / len(kept) if kept else "not measured",
            "device_ms_from": f"profiler, one call a window: {len(kept)} of "
                              f"{windows} windows recorded all {n_kernels} "
                              f"kernels once",
            "device_ms_windows": kept, "device_ms_records": records,
            "device_ms_by_kernel": {name: ms / len(kept)
                                    for name, ms in by_kernel.items()}}


def plus(a, b):
    """a + b, or "not measured" where either is."""
    return "not measured" if isinstance(a, str) or isinstance(b, str) \
        else a + b


def bound(nbytes, ops, peak=PEAK_F32):
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / peak
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
def gat_inputs(torch, gen, B, N, adj, H=4):
    dev = "cuda"
    z = torch.randn((B, N, 32 * H), generator=gen, device=dev)
    es = torch.randn((B, N, H), generator=gen, device=dev)
    ed = torch.randn((B, N, H), generator=gen, device=dev)
    return z, es, ed, adj.contiguous()


def gat_edge_cases(torch, gen):
    """(name, B, H, adj) masks whose edge lists the kernels must get
    right: N = 1 with its one column set and masked; a column that no
    row reaches; a row with every column set; a row with every column
    masked; asymmetric per-batch masks (odd N, so rows start at every
    byte offset); a mask that starts at an odd byte offset of its
    storage; uint8 values other than 1; and H = 1, 3 and 8."""
    def rand(B, N, p=0.05):
        adj = torch.rand((B, N, N), generator=gen, device="cuda") < p
        return adj | torch.eye(N, dtype=torch.bool, device="cuda")

    unreached = rand(1, 33)
    unreached[0, :, 7] = False
    unreached[0, 7, 8] = True
    full = rand(1, 130)
    full[0, 3] = True
    masked = rand(1, 33)
    masked[0, 5] = False
    asym = torch.rand((3, 97, 97), generator=gen, device="cuda") < 0.05
    check(not torch.equal(asym, asym.transpose(1, 2)), "mask is symmetric")
    flat = torch.zeros(5 + 130 * 130, dtype=torch.bool, device="cuda")
    offset = flat[5:].view(1, 130, 130)
    offset.copy_(rand(1, 130))
    return [("N=1", 2, 4, torch.ones((1, 1, 1), dtype=torch.bool,
                                     device="cuda")),
            ("N=1:masked", 2, 4, torch.zeros((1, 1, 1), dtype=torch.bool,
                                             device="cuda")),
            ("unreached-column", 2, 4, unreached),
            ("full-row", 2, 4, full), ("all-masked-row", 2, 4, masked),
            ("asymmetric", 3, 4, asym), ("offset-5-bytes", 2, 4, offset),
            ("uint8", 2, 4, rand(1, 130).to(torch.uint8) * 3),
            ("H=1", 2, 1, rand(1, 130)), ("H=3", 2, 3, rand(2, 97)),
            ("H=8", 2, 8, full)]


def gat_compare(torch, ops, z, es, ed, adj, rep=1):
    out, m, l = ops.gat_mp(z, es, ed, adj, rep)
    po, pm, pl = ops.gat_mp_plain(z, es, ed, adj, rep)
    torch.cuda.synchronize()
    err = (out - po).abs().max().item()
    l_rel = ((l - pl).abs() / pl.abs()).max().item()
    m_eq = bool(torch.equal(m, pm))
    check(err <= 2e-5, f"gat out error {err} > 2e-5")
    check(m_eq, "gat m differs from the plain version")
    check(l_rel <= 1e-5, f"gat l relative error {l_rel} > 1e-5")
    return err, l_rel


def gat_candidates(torch, ops, z, es, ed, adj, rep=1, timed=False):
    """Every forward block shape of ``ops.FWD_WARPS`` on the same inputs:
    bit-equal to ``gat_tune.DEFAULT_BLOCKS``' out, m and l (which
    ``gat_compare`` holds against the plain version).  Launches count
    as the tuner's.  With ``timed``, each shape's profiler device ms
    per call.  Returns {label: device ms or True}."""
    from repro_torch.core import gat_tune
    tune = gat_tune.autotune

    def run(w):
        return ops._launch(z, es, ed, adj, rep, warps=w, counter=tune)
    want = run(gat_tune.DEFAULT_BLOCKS["fwd"][0])
    out = {}
    for w in ops.FWD_WARPS:
        got = run(w)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"gat forward at {w} warps differs from the default shape")
        out[gat_tune.label("fwd", (w,))] = (
            profiled(torch, lambda: run(w))["device_ms"] if timed else True)
    return out


def gat_bwd_candidates(torch, ops, args, rep=1, timed=False):
    """Every backward block shape of ``ops.BWD_SHAPES`` on the same
    inputs: dz, de_src and de_dst bit-equal to the default shape's
    (which ``gat_bwd_compare`` holds against the plain version)."""
    from repro_torch.core import gat_tune
    tune = gat_tune.autotune

    def run(shape):
        return ops._launch_bwd(*args, rep, shape=shape, counter=tune)
    want = run(gat_tune.DEFAULT_BLOCKS["bwd"])
    out = {}
    for shape in ops.BWD_SHAPES:
        got = run(shape)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"gat backward at {shape} differs from the default shape")
        out[gat_tune.label("bwd", shape)] = (
            profiled(torch, lambda: run(shape))["device_ms"] if timed
            else True)
    return out


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


def gat_bwd_compare(torch, ops, args, floor=1e-30, rep=1):
    """The backward kernel against ``gat_mp_bwd_plain`` on the same
    inputs: each gradient within 1e-5 of its largest element (f32 sums
    in another order; the plain version also adds the exact zeros of the
    dense (N, N) products), and a second launch bit-equal to the first.
    ``floor`` is a least scale, for inputs whose gradient is rounding
    noise only (see ``cancel_scale``)."""
    got = ops.gat_mp_bwd(*args, rep)
    again = ops.gat_mp_bwd(*args, rep)
    want = ops.gat_mp_bwd_plain(*args, rep)
    torch.cuda.synchronize()
    errs = {}
    for name, a, b in zip(("dz", "de_src", "de_dst"), got, want):
        scale = max(b.abs().max().item(), floor)
        errs[name] = (a - b).abs().max().item()
        check(errs[name] <= 1e-5 * scale,
              f"gat_mp_bwd {name} error {errs[name]} > 1e-5 x {scale}")
        check(bool(torch.isfinite(a).all()), f"gat_mp_bwd {name} not finite")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "gat_mp_bwd: two launches differ")
    return errs


def cancel_scale(z, g, H):
    """The largest sum over a head's features of |g_i| |z_j|.  At N = 1
    with its one column set, out = z, so de_src and de_dst are g . z -
    g . out: two equal dot products whose difference is rounding noise of
    this size, in the kernel and the plain version alike."""
    B, N, D = z.shape
    gz = g.abs().reshape(B, N, H, D // H) * z.abs().reshape(B, N, H, D // H)
    return gz.sum(-1).max().item()


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
    cases = [("critic:bert", 24, 4, bert_adj[None])]
    for n in (388, 194, 97):     # per-genome pooled adjacency, B = 16
        adj = torch.stack([
            bert_adj[idx][:, idx] for idx in
            (torch.randperm(388, generator=gen, device="cuda")[:n]
             for _ in range(16))])
        cases.append(("per-batch", 16, 4, adj))
    cases.append(("shared", 16, 4, bert_adj[None]))
    for name in ("resnet50", "moe_transformer", "dense_cnn"):
        adj = masks[name][None].clone()
        if name == "moe_transformer":
            adj[0, 5] = False    # a row with every column masked
        cases.append((f"shared:{name}", 1, 4, adj))
    cases += gat_edge_cases(torch, gen)
    for kind, B, H, adj in cases:
        N = adj.shape[-1]
        z, es, ed, adj = gat_inputs(torch, gen, B, N, adj, H)
        err, l_rel = gat_compare(torch, ops, z, es, ed, adj)
        # the critic's and the population's level-0 shapes are timed at
        # every block shape
        blocks = gat_candidates(torch, ops, z, es, ed, adj,
                                timed=kind in ("critic:bert", "shared"))
        row = {"phase": "gat", "adj": kind, "B": B, "N": N, "H": H,
               "max_abs_err_out": err, "m_bit_equal": True,
               "max_rel_err_l": l_rel,
               "blocks_bit_equal_device_ms": blocks,
               "kernel_ms": event_ms(torch, lambda: ops.gat_mp(z, es, ed, adj),
                                     100),
               **profiled(torch, lambda: ops.gat_mp(z, es, ed, adj)),
               "plain_ms": event_ms(
                   torch, lambda: ops.gat_mp_plain(z, es, ed, adj), 10),
               "library_ms": event_ms(torch,
                                      sdpa_call(torch, z, es, ed, adj), 20)}
        emit(row)


def phase_gat_zoo(torch, gen, ops, zoo_masks):
    """Both GAT kernels on the zoo's shared-mask form against their plain
    versions: a bucket's G graph masks (G, N, N) shared by P genomes
    (b = p G + g, rep 1, the population forward's level 0) or by the T
    transitions of a critic batch (b = g T + t, rep T).  ``zoo_masks``:
    {bucket name: (G, N_max, N_max) bool, padded rows self-loop only}."""
    cases = [("genomes", "moe_transformer+dense_cnn", 16, 1),
             ("transitions", "resnet101+tiny_gpt", 1, 24),
             ("genomes", "bert", 16, 1)]
    for kind, name, P, rep in cases:
        adj = zoo_masks[name]
        G, N = adj.shape[:2]
        B = P * G * rep
        z, es, ed, adj = gat_inputs(torch, gen, B, N, adj)
        err, l_rel = gat_compare(torch, ops, z, es, ed, adj, rep)
        g = torch.randn(z.shape, generator=gen, device="cuda")
        out, m, l = ops.gat_mp(z, es, ed, adj, rep)
        errs = gat_bwd_compare(torch, ops, (z, es, ed, adj, m, l, out, g),
                               rep=rep)
        gat_candidates(torch, ops, z, es, ed, adj, rep)
        gat_bwd_candidates(torch, ops, (z, es, ed, adj, m, l, out, g), rep)
        emit({"phase": "gat_zoo_mask", "blocks_bit_equal": True,
              "shared_by": kind, "bucket": name,
              "B": B, "G": G, "rep": rep, "N": N, "max_abs_err_out": err,
              "m_bit_equal": True, "max_rel_err_l": l_rel,
              "bwd_max_abs_err": errs, "bwd_deterministic": True,
              "kernel_ms": event_ms(
                  torch, lambda: ops.gat_mp(z, es, ed, adj, rep), 50),
              "bwd_kernel_ms": event_ms(torch, lambda: ops.gat_mp_bwd(
                  z, es, ed, adj, m, l, out, g, rep), 20)})


def phase_gat_path(torch, gnn, ops, params, feats, adj, gen):
    """The four launches of one BERT population forward (P = 16), on the
    inputs the path itself gives the kernel."""
    pop = torch.stack([params.init_gnn(gen, feats.shape[1])
                       for _ in range(16)])
    captured = []

    def capture(z, es, ed, a, rep=1):
        check(rep == 1, "a single-graph forward shares no mask by rep")
        captured.append((z, es, ed, a))
        return ops.gat_mp(z, es, ed, a)

    gnn.gat_ops = types.SimpleNamespace(gat_mp=capture)
    try:
        gnn.population_logits(pop, feats, adj)
    finally:
        gnn.gat_ops = ops
    check([c[0].shape[1] for c in captured] == [388, 194, 97, 194],
          f"unexpected level sizes {[c[0].shape for c in captured]}")
    tot = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "bytes": 0, "ops": 0, "dense_ops": 0, "err": 0.0}
    per = []
    for z, es, ed, a in captured:
        err, _ = gat_compare(torch, ops, z, es, ed, a)
        nbytes, nops, dense = gat_work(z, es, a)
        one = {"ms": event_ms(torch, lambda: ops.gat_mp(z, es, ed, a), 200),
               **profiled(torch, lambda: ops.gat_mp(z, es, ed, a)),
               "plain_ms": event_ms(
                   torch, lambda: ops.gat_mp_plain(z, es, ed, a), 10),
               "library_ms": event_ms(torch, sdpa_call(torch, z, es, ed, a),
                                      20),
               "bound_ms": bound(nbytes, nops)[0]}
        per.append({"shape": list(z.shape), "adj_batch": a.shape[0], **one})
        tot["err"] = max(tot["err"], err)
        for k in ("ms", "device_ms", "plain_ms", "library_ms"):
            tot[k] = plus(tot[k], one[k])
        tot["bytes"] += nbytes
        tot["ops"] += nops
        tot["dense_ops"] += dense
    tot["bound_ms"], tot["bound_by"] = bound(tot["bytes"], tot["ops"])
    tot["launches"] = len(captured)
    emit({"phase": "gat_path", "graph": "bert", "P": 16, "per_launch": per,
          **tot})
    return tot


def gat_bwd_inputs(torch, ops, gen, B, adj, H=4):
    N = adj.shape[-1]
    z, es, ed, adj = gat_inputs(torch, gen, B, N, adj, H)
    out, m, l = ops.gat_mp(z, es, ed, adj)
    g = torch.randn(z.shape, generator=gen, device="cuda")
    return z, es, ed, adj, m, l, out, g


def phase_gat_bwd(torch, gen, ops, masks):
    """The backward kernel at the critic's shape (B = 24, one shared
    BERT mask), the actor's four level shapes (B = 1: the BERT mask, then
    pooled masks of 194, 97 and 194 nodes), and edge cases: a row with
    every column masked (moe_transformer, N = 1043), the densest graph
    (dense_cnn, N = 1010), a mask that is not symmetric, and the masks
    and head counts of ``gat_edge_cases``."""
    bert_adj = masks["bert"]

    def pooled(n):
        idx = torch.randperm(388, generator=gen, device="cuda")[:n]
        return bert_adj[idx][:, idx][None].contiguous()

    moe = masks["moe_transformer"][None].clone()
    moe[0, 5] = False            # a row with every column masked
    asym = torch.rand((2, 300, 300), generator=gen, device="cuda") < 0.02
    check(not torch.equal(asym, asym.transpose(1, 2)), "mask is symmetric")
    cases = [("critic:bert", 24, 4, bert_adj[None]),
             ("actor:level0", 1, 4, bert_adj[None]),
             ("actor:level1", 1, 4, pooled(194)),
             ("actor:level2", 1, 4, pooled(97)),
             ("actor:level3", 1, 4, pooled(194)),
             ("all-masked-row:moe_transformer", 1, 4, moe),
             ("dense_cnn", 1, 4, masks["dense_cnn"][None]),
             ("asymmetric:300", 2, 4, asym)] + gat_edge_cases(torch, gen)
    for kind, B, H, adj in cases:
        args = gat_bwd_inputs(torch, ops, gen, B, adj, H)
        floor = cancel_scale(args[0], args[7], H) if kind == "N=1" else 1e-30
        errs = gat_bwd_compare(torch, ops, args, floor)
        blocks = gat_bwd_candidates(torch, ops, args,
                                    timed=kind in ("critic:bert",
                                                   "actor:level0"))
        if kind.startswith("all-masked"):
            row = 5 if args[0].shape[1] > 5 else 0
            check(bool((args[4][:, row] <= -1e30).all()),
                  "the masked row has a finite max")
        z, es, ed, a, m, l, out, g = args
        emit({"phase": "gat_bwd", "case": kind, "B": B, "N": a.shape[-1],
              "H": H, "mask_batch": a.shape[0], "max_abs_err": errs,
              "deterministic": True, "blocks_bit_equal_device_ms": blocks,
              "kernel_ms": event_ms(torch, lambda: ops.gat_mp_bwd(*args), 50),
              **profiled(torch, lambda: ops.gat_mp_bwd(*args)),
              "plain_ms": event_ms(
                  torch, lambda: ops.gat_mp_bwd_plain(*args), 5),
              "library_ms": event_ms(
                  torch, sdpa_bwd_call(torch, z, es, ed, a, g), 10)})


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

    def capture(*args, **kw):
        if kw.get("counter") is None:   # not one of the tuner's launches
            check(args[8:] in ((), (1,)), "a single-graph SAC step shares "
                  "no mask by rep")
            captured.append(args[:8])
        return launch(*args, **kw)

    ops._launch_bwd = capture
    try:
        learner.update(buf, 1)
    finally:
        ops._launch_bwd = launch
    shapes = sorted((c[0].shape[0], c[0].shape[1]) for c in captured)
    check(shapes == sorted([(24, 388)] * 2 + [(1, 388)] * 3
                           + [(1, 194)] * 2 + [(1, 97)]),
          f"unexpected backward shapes {shapes}")
    tot = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "bytes": 0, "ops": 0, "err": 0.0}
    per = []
    for args in captured:
        errs = gat_bwd_compare(torch, ops, args)
        z, es, ed, a, m, l, out, g = args
        nbytes, nops = gat_bwd_work(z, es, a, m)
        one = {"ms": event_ms(torch, lambda: ops.gat_mp_bwd(*args), 100),
               **profiled(torch, lambda: ops.gat_mp_bwd(*args)),
               "plain_ms": event_ms(
                   torch, lambda: ops.gat_mp_bwd_plain(*args), 5),
               "library_ms": event_ms(
                   torch, sdpa_bwd_call(torch, z, es, ed, a, g), 10),
               "bound_ms": bound(nbytes, nops)[0]}
        per.append({"shape": [z.shape[0], z.shape[1], a.shape[0]], **one})
        tot["err"] = max(tot["err"], *errs.values())
        for k in ("ms", "device_ms", "plain_ms", "library_ms"):
            tot[k] = plus(tot[k], one[k])
        tot["bytes"] += nbytes
        tot["ops"] += nops
    tot["bound_ms"], tot["bound_by"] = bound(tot["bytes"], tot["ops"])
    tot["launches"] = len(captured)
    emit({"phase": "gat_path_bwd", "graph": "bert", "per_launch": per,
          **tot})
    return tot


# ------------------------------------------------------- simulator kernel
# Mappings per launch the memsim phase checks: a PG rollout, Greedy-DP's
# 9 candidates, the population, more than one warp of mappings; then one
# P that needs more blocks (32 mappings each) than the card has SMs.
MEMSIM_POPULATIONS = (1, 9, 20, 33)
# The simulator kernel's latency bound, from the SASS of its build
# (cuobjdump -sass; PERF.md §6).  A rectify step's dependency
# chain through a free counter is compare (writes a predicate) ->
# predicated subtract (the weight) -> compare -> predicated subtract (the
# activation) -> release add; ptxas schedules 13 cycles from a compare
# to the instruction its predicate guards and 5 from an FADD to its
# dependent, so a step is 13 + 5 + 13 + 5 + 5 cycles.
MEMSIM_CHAIN_CYCLES = 41
MEMSIM_FADD_CYCLES = 5     # a dependent FADD of the ordered latency sum
MEMSIM_DRAM_CYCLES = 1000  # one device-memory round trip, the first tile


def memsim_latency_bound_ms(n, sm_mhz):
    """N steps of the chain, N dependent FADDs of the ordered sum and one
    device-memory round trip, at the SM clock read during the run."""
    return (n * (MEMSIM_CHAIN_CYCLES + MEMSIM_FADD_CYCLES)
            + MEMSIM_DRAM_CYCLES) / (sm_mhz * 1e3)


def memsim_roofline(sg, maps):
    """(bytes, operations) of one launch: every input read once, every
    output written once; per (mapping, node) rectify 2 compares, 2
    subtracts, 1 ring add, 3 release adds, latency 1 multiply, 3 divides,
    2 adds, max, overhead add and the running sum; per fan-in edge a
    divide and an add."""
    P, n = maps.shape[:2]
    edges = int((sg.in_acts >= 0).sum().item())
    nbytes = sum(x.numel() * x.element_size() for x in (
        sg.weight_bytes, sg.weight_frac, sg.act_bytes, sg.flops, sg.ring_t,
        sg.ring_lc, sg.self_release, sg.in_acts, sg.total_bytes, maps)) \
        + P * 5 * 4 + maps.numel() * 4
    return nbytes, P * (17 * n + 2 * edges)


def memsim_mappings(torch, g, heuristic_mapping, P, gen):
    """(P, N, 2) int32 on the card: the compiler's heuristic, all-HBM,
    all-CMEM and all-VMEM (the first min(P, 4)), then random tiers."""
    fixed = [torch.as_tensor(heuristic_mapping(g), device="cuda").int()] + [
        torch.full((g.n, 2), t, dtype=torch.int32, device="cuda")
        for t in (0, 1, 2)]
    rand = torch.randint(0, 3, (max(P - 4, 0), g.n, 2), generator=gen,
                         device="cuda").int()
    return torch.cat([torch.stack(fixed[:P]), rand]).contiguous()


def phase_memsim(torch, zoo, sim, compiler, gen):
    """The simulator kernel against ``evaluate_population_plain`` on the
    card, on all 7 zoo graphs at every P of MEMSIM_POPULATIONS and at 32
    mappings for each SM and 8 more blocks: rectified tiers, eps and valid
    bit-equal, latency and reward within 1e-6 relative.  Each row: ``ms``
    (CUDA events), ``device_ms`` (profiler), the roofline bound, the
    latency bound and ``bound_share`` (the larger bound over device_ms).
    Returns BERT's row at P = 20 (the population) for the kernels line."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = None
    path = None
    for name, make in zoo.WORKLOADS.items():
        g = make()
        sg = sim.build_sim_graph(g, "cuda")
        _, ref = compiler.compiler_reference(g)
        for P in MEMSIM_POPULATIONS + (32 * (sms + 8),):
            maps = memsim_mappings(torch, g, compiler.heuristic_mapping, P,
                                   gen)
            res = sim.evaluate_population(sg, maps, ref)
            plain = sim.evaluate_population_plain(sg, maps, ref)
            torch.cuda.synchronize()
            case = f"{name} P={P}"
            for k in ("rectified", "eps", "valid"):
                check(torch.equal(res[k], plain[k]), f"{case}: {k} differs")
            rel = {k: ((res[k] - plain[k]).abs()
                       / plain[k].abs().clamp_min(1e-30)).max().item()
                   for k in ("latency", "reward")}
            check(max(rel.values()) <= 1e-6, f"{case}: {rel} > 1e-6 rel")
            err = max((res[k] - plain[k]).abs().max().item()
                      for k in ("latency", "reward", "speedup"))

            def call():
                sim.evaluate_population(sg, maps, ref)
            if clock is None:
                clock = sm_clock_mhz(torch, call)
            nbytes, nops = memsim_roofline(sg, maps)
            b_ms, b_by = bound(nbytes, nops)
            lat_ms = memsim_latency_bound_ms(g.n, clock[0])
            row = {"phase": "memsim", "graph": name, "N": g.n, "P": P,
                   "blocks": -(-P // 32), "W": sg.ring_init.shape[0],
                   "max_in": sg.in_acts.shape[1],
                   "tiers_eps_valid_bit_equal": True,
                   "latency_reward_bit_equal": all(
                       torch.equal(res[k], plain[k])
                       for k in ("latency", "reward")),
                   "max_rel_err": rel, "max_abs_err": err,
                   "spilled_mappings": int((~res["valid"]).sum().item()),
                   "ms": event_ms(torch, call, 50), **profiled(torch, call),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "latency_bound_ms": lat_ms, "sm_clock_mhz": clock[0],
                   "sm_clock_max_mhz": clock[1]}
            row["bound_share"] = (max(b_ms, lat_ms) / row["device_ms"]
                                  if not isinstance(row["device_ms"], str)
                                  else "not measured")
            if P == 20:
                row["plain_ms"] = event_ms(
                    torch, lambda: sim.evaluate_population_plain(
                        sg, maps, ref), 2, warmup=1)
            emit(row)
            if name == "bert" and P == 20:
                path = dict(row, err=err)
    return path


# Mappings per launch the memsim_zoo phase checks: a PG rollout, the
# population, the population and a PG rollout, two blocks a graph
MEMSIM_ZOO_POPULATIONS = (1, 20, 21, 33)


def memsim_zoo_roofline(gb, maps):
    """(bytes, operations) of one zoo launch: every input read once,
    every output written once; per (mapping, real node) and real fan-in
    edge the operations of ``memsim_roofline`` (padded nodes are not
    walked)."""
    sg = gb.sim
    P = maps.shape[0]
    real = int(sum(gb.sizes))
    edges = int((sg.in_acts >= 0).sum().item())
    nbytes = sum(x.numel() * x.element_size() for x in (
        sg.weight_bytes, sg.weight_frac, sg.act_bytes, sg.flops, sg.ring_t,
        sg.ring_lc, sg.self_release, sg.in_acts, sg.total_bytes,
        gb.n_nodes, gb.ref_latency, maps)) \
        + P * gb.n_graphs * 5 * 4 + maps.numel() * 4
    return nbytes, P * (17 * real + 2 * edges)


def phase_memsim_zoo(torch, zoo, sim, mb, bucketed, gen):
    """The zoo entry of the simulator kernel (one launch a bucket) on the
    7-graph zoo under the "auto" (4 buckets, up to N_max 1043 / W_max
    126) and "off" (one bucket of 7) policies, at every P of
    MEMSIM_ZOO_POPULATIONS, random tiers with other random tiers in the
    padded slots: against ``evaluate_population_zoo_plain``, against the
    same mappings with the padded slots zeroed, and graph by graph
    against the single-graph kernel; every output bit-equal.  Rows:
    ``ms`` (CUDA events), the roofline bound and the latency bound of the
    bucket's largest graph; at P = 20 (the population) also
    ``device_ms`` (profiler), ``bound_share`` and the single-graph
    kernel's device ms per graph beside it.
    Returns the row of the "auto" bucket of moe_transformer and
    dense_cnn at P = 20, for the kernels line."""
    graphs = [make() for make in zoo.WORKLOADS.values()]
    singles = {g.name: sim.build_sim_graph(g, "cuda") for g in graphs}
    single_ms = {}
    clock = None
    path = None
    for policy in ("auto", "off"):
        bz = bucketed.build_bucketed_zoo(graphs, policy, device="cuda")
        check(bz.n_buckets == (4 if policy == "auto" else 1),
              f"{policy}: {bz.n_buckets} buckets")
        for P in MEMSIM_ZOO_POPULATIONS:
            for k, gb in enumerate(bz.buckets):
                G, N = gb.n_graphs, gb.n_max
                maps = torch.randint(0, 3, (P, G, N, 2), generator=gen,
                                     device="cuda").int()
                clean = maps * gb.node_mask[None, :, :, None].int()
                res = mb.evaluate_population_zoo(gb, maps)
                res0 = mb.evaluate_population_zoo(gb, clean.contiguous())
                plain = mb.evaluate_population_zoo_plain(gb, maps)
                torch.cuda.synchronize()
                case = f"memsim_zoo {policy} bucket {k} P={P}"
                for key in res:
                    check(torch.equal(res[key], plain[key]),
                          f"{case}: {key} differs from the plain version")
                    check(torch.equal(res[key], res0[key]),
                          f"{case}: {key} moved with the padded slots")
                for j, name in enumerate(gb.names):
                    n = gb.sizes[j]
                    one = sim.evaluate_population(
                        singles[name], maps[:, j, :n].contiguous(),
                        float(gb.ref_latency[j].item()))
                    torch.cuda.synchronize()
                    for key in mb.SCALARS:
                        check(torch.equal(one[key], res[key][:, j]),
                              f"{case} {name}: {key} differs from the "
                              f"single-graph kernel")
                    check(torch.equal(one["rectified"],
                                      res["rectified"][:, j, :n]),
                          f"{case} {name}: rectified differs from the "
                          f"single-graph kernel")
                    check(not res["rectified"][:, j, n:].any(),
                          f"{case} {name}: a padded row is not 0")
                    if P == 20 and name not in single_ms:
                        single_ms[name] = profiled(
                            torch, lambda: sim.evaluate_population(
                                singles[name], maps[:, j, :n].contiguous(),
                                1.0))["device_ms"]

                def call():
                    mb.evaluate_population_zoo(gb, maps)
                if clock is None:
                    clock = sm_clock_mhz(torch, call)
                nbytes, nops = memsim_zoo_roofline(gb, maps)
                b_ms, b_by = bound(nbytes, nops)
                lat_ms = memsim_latency_bound_ms(max(gb.sizes), clock[0])
                row = {"phase": "memsim_zoo", "policy": policy, "bucket": k,
                       "graphs": list(gb.names), "sizes": list(gb.sizes),
                       "N_max": N, "W_max": gb.w_max,
                       "max_in": gb.sim.in_acts.shape[2], "P": P,
                       "blocks": [-(-P // 32), G], "bit_equal": True,
                       "spilled_mappings": int((~res["valid"]).sum().item()),
                       "ms": event_ms(torch, call, 50), "bound_ms": b_ms,
                       "bound_by": b_by, "latency_bound_ms": lat_ms,
                       "sm_clock_mhz": clock[0]}
                if P == 20:
                    row.update(profiled(torch, call))
                    row["bound_share"] = (
                        max(b_ms, lat_ms) / row["device_ms"]
                        if not isinstance(row["device_ms"], str)
                        else "not measured")
                    row["single_graph_device_ms"] = {
                        name: single_ms[name] for name in gb.names}
                    if policy == "auto" and k == bz.n_buckets - 1:
                        row["plain_ms"] = event_ms(
                            torch, lambda: mb.evaluate_population_zoo_plain(
                                gb, maps), 1, warmup=1)
                        path = dict(row, err=0.0)
                emit(row)
    return path


def greedy_launches(n, passes, budget):
    """Simulator launches ``greedy_dp`` makes: the compiler reference,
    one per node of a pass, one ``evaluate`` per finished pass or at the
    budget."""
    launches, iters = 1, 0
    for _ in range(passes):
        for _ in range(n):
            launches += 1
            iters += 9
            if budget is not None and iters >= budget:
                return launches + 1
        launches += 1
    return launches


def phase_greedy(torch, np, rdev, zoo, sim, compiler, budget=4000):
    """Greedy-DP at Figure 4's budget (benchmarks/fig4_speedup.py: 4000
    candidates, max(1, 4000 // (9 N)) passes) on BERT and ResNet-50: the
    counters reset just before the run and read just after must show the
    launches the code implies and no other kernel; the final mapping,
    re-evaluated on the CPU with the plain simulator, must give the
    reward the run recorded.  A second run under the profiler gives the
    simulator's device time and must find the same mapping.  Returns the
    launches per graph."""
    launches = {}
    for name in ("bert", "resnet50"):
        g = zoo.WORKLOADS[name]()
        passes = max(1, budget // (9 * g.n))
        want = greedy_launches(g.n, passes, budget)
        rdev.reset_launch_counts()
        t0 = time.perf_counter()
        mapping, hist = compiler.greedy_dp(g, passes=passes, budget=budget)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        counts = rdev.launch_counts()
        check(counts == {**{k: 0 for k in counts}, "memsim": want},
              f"greedy {name}: launches {counts}, the path implies {want}")
        sg = sim.build_sim_graph(g, "cpu")
        _, ref = compiler.compiler_reference(g, "cpu")
        res = sim.evaluate_population_plain(
            sg, torch.as_tensor(mapping)[None], ref)
        check(res["reward"].item() == hist[-1][1],
              f"greedy {name}: reward {hist[-1][1]} != {res['reward'].item()}"
              f" re-evaluated on the CPU")
        again = {}

        def run():
            again["out"] = compiler.greedy_dp(g, passes=passes, budget=budget)
        for tries in range(1, PROFILE_TRIES + 1):
            rec = profile_kernels(torch, run, 1)
            sim_rec = [v for k, v in rec.items() if "memsim_kernel" in k]
            if sim_rec and sim_rec[0][1] == want:
                break
        check(np.array_equal(again["out"][0], mapping)
              and again["out"][1] == hist, f"greedy {name}: a second run "
              f"found another mapping")
        emit({"phase": "greedy", "graph": name, "N": g.n, "budget": budget,
              "passes": passes, "launches": counts["memsim"],
              "history": hist, "speedup": float(res["speedup"].item()),
              "wall_ms": wall_ms,
              "sim_device_ms": (sim_rec[0][0] if sim_rec and sim_rec[0][1]
                                == want else "not measured"),
              "sim_device_ms_tries": tries,
              "device_busy_ms": sum(ms for ms, _ in rec.values()),
              "nvidia_smi": nvidia_smi()})
        launches[name] = counts["memsim"]
    return launches


# ------------------------------------------------------------- the slice
def run_slice(torch, np, name, make, egrl, sim, compiler, rdev, mode="ea",
              steps=400):
    """EGRL(..., mode=mode).train() at ``steps`` steps; the launch
    counters are set to 0 just before it and read just after it, and
    must match what the path launches: per generation 4 forward GAT
    launches for the population and, outside "ea" mode, 4 for the PG
    rollout; per SAC step 8 forward and 8 backward GAT launches; one
    simulator launch per population and one for the PG rollouts per
    generation, plus the compiler reference's; no LLM kernel."""
    from repro_torch.core import gat_tune
    cfg = egrl.EGRLConfig(total_steps=steps, seed=0)
    graph = make()
    sac_s = [0.0]
    rdev.reset_launch_counts()
    gat_tune.autotune.launches = 0
    t0 = time.perf_counter()
    algo = egrl.EGRL(graph, cfg, mode=mode, device="cuda", pop_shards="off")
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
            "memsim": 1 + gens * (pop + (mode != "ea")), "memsim_zoo": 0,
            "flash_attention": 0, "flash_attention_tc": 0,
            "flash_attention_bwd": 0, "flash_attention_bwd_tc": 0,
            "ssd_scan": 0, "ssd_scan_bwd": 0}
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
            "tuning_launches": gat_tune.autotune.launches,
            "bwd_launches_per_sac_step": (counts["gat_mp_bwd"] / sac_steps
                                          if sac_steps else None),
            "first_generation_ms": (t1 - t0) * 1e3,
            "mean_generation_ms_after_first": (t2 - t1) * 1e3
            / max(gens - 1, 1),
            "sac_update_ms_total": sac_s[0] * 1e3,
            "sac_step_ms": (sac_s[0] * 1e3 / sac_steps if sac_steps
                            else None)}


def phase_gat_tune(torch, zoo):
    """The block shapes ``core/gat_tune.py`` chose while the slice ran,
    for every launch key at the BERT and ResNet-50 levels' N (the
    graph, half and a quarter of it), with the timings behind each."""
    from repro_torch.core import gat_tune
    sizes = {}
    for name in ("bert", "resnet50"):
        n = zoo.WORKLOADS[name]().n
        sizes[name] = (n, max(2, n // 2), max(2, n // 4))
    rows = []
    for key, t in sorted(gat_tune._CACHE.items(), key=str):
        n, d, heads, dtype, batch, masks, card = key
        graphs = [g for g, ns in sizes.items() if n in ns]
        if graphs:
            rows.append({"graphs": graphs, "N": n, "D": d, "H": heads,
                         "dtype": dtype, "B": batch, "G": masks,
                         "device": card, "backend": t.backend,
                         "chosen": t.blocks, "timings_us": t.timings})
    check(rows, "gat_tune: the slice resolved no key at its graphs' sizes")
    check(all(r["backend"] == "cuda" for r in rows),
          "gat_tune: a key on the card resolved to the plain version")
    emit({"phase": "gat_tune", "sizes": sizes, "keys": rows,
          "default": gat_tune.DEFAULT_BLOCKS,
          "timing": f"CUDA events over a CUDA graph of "
                    f"{gat_tune.TIMING_LAUNCHES} launches, least of "
                    f"{gat_tune.TIMING_REPS} replays",
          "nvidia_smi": nvidia_smi()})


def zoo_launches(K, n_graphs, gens, sac_steps, pg=True):
    """What ``run_zoo`` checks: the compiler references, and per
    generation and bucket 4 + 4 GAT and 1 + 1 simulator launches (the
    population and the PG rollout), per SAC step and bucket 8 + 8."""
    return {"gat_mp": gens * K * 4 * (1 + pg) + sac_steps * K * 8,
            "gat_mp_bwd": sac_steps * K * 8, "memsim": n_graphs,
            "memsim_zoo": gens * K * (1 + pg), "flash_attention": 0,
            "flash_attention_tc": 0, "flash_attention_bwd": 0,
            "flash_attention_bwd_tc": 0, "ssd_scan": 0, "ssd_scan_bwd": 0}


def run_zoo(torch, np, zoo, egrl, sim, compiler, rdev, mode, gens):
    """``ZooEGRL`` on the 7-graph zoo ("auto": 4 buckets) at full width
    for ``gens`` generations, between a reset and a read of the launch
    counters, which must match what the path launches: the zoo's 7
    compiler references (single-graph simulator launches); per
    generation and bucket 4 forward GAT launches for the population, one
    simulator zoo launch for it and, outside "ea" mode, 4 and one more
    for the PG rollout; per SAC step and bucket 8 forward and 8 backward
    GAT launches.  Each graph's best mapping, re-evaluated on the CPU by
    the plain single-graph simulator, must give its recorded reward."""
    graphs = [make() for make in zoo.WORKLOADS.values()]
    cfg = egrl.EGRLConfig(seed=0)
    rdev.reset_launch_counts()
    t0 = time.perf_counter()
    algo = egrl.ZooEGRL(graphs, cfg, mode=mode, buckets="auto",
                        device="cuda", pop_shards="off", dispatch="off")
    K = algo.zoo.n_buckets
    gen_ms = []
    for _ in range(gens):
        torch.cuda.synchronize()
        t = time.perf_counter()
        algo.generation()
        torch.cuda.synchronize()
        gen_ms.append((time.perf_counter() - t) * 1e3)
    counts = rdev.launch_counts()
    sac_steps = algo.learner.opt_a["t"] if algo.learner else 0
    pg = mode != "ea"
    want = zoo_launches(K, len(graphs), gens, sac_steps, pg)
    check(counts == want, f"zoo {mode}: launches {counts}, the path "
          f"implies {want}")
    rows_per_gen = algo.n_g + algo.n_b + (cfg.pg_rollouts if pg else 0)
    check(algo.steps == gens * rows_per_gen * len(graphs),
          f"zoo {mode}: {algo.steps} steps")
    if pg:
        check(sac_steps == rows_per_gen * sum(
            "critic_loss" in h for h in algo.history) and sac_steps > 0,
            f"zoo {mode}: {sac_steps} SAC steps")
        last = algo.history[-1]
        check(all(np.isfinite(last[k]) for k in
                  ("critic_loss", "actor_loss", "entropy")),
              f"zoo {mode}: non-finite SAC losses {last}")
    for gi, g in enumerate(graphs):
        sg = sim.build_sim_graph(g, "cpu")
        _, ref = compiler.compiler_reference(g, "cpu")
        res = sim.evaluate_population_plain(
            sg, torch.as_tensor(algo.best_mapping[gi])[None], ref)
        want_r = algo.best_reward[gi]
        check(abs(res["reward"].item() - want_r) <= 1e-6 * abs(want_r),
              f"zoo {mode} {g.name}: best reward {want_r} != re-evaluated "
              f"{res['reward'].item()}")
    scale = cfg.reward_scale
    return {"mode": mode, "graphs": list(algo.zoo.names),
            "buckets": [{"graphs": list(b.names), "n_max": b.n_max,
                         "w_max": b.w_max} for b in algo.zoo.buckets],
            "pad_waste_frac": algo.zoo.pad_waste_frac(),
            "n_eff": algo.n_eff, "generations": gens, "steps": algo.steps,
            "sac_steps": sac_steps, "launches": counts,
            "best_fitness": algo.best_fitness,
            "best_speedup": {name: max(float(r), 0.0) / scale for name, r
                             in zip(algo.zoo.names, algo.best_reward)},
            "sac": {k: algo.history[-1][k] for k in
                    ("critic_loss", "actor_loss", "entropy")
                    if k in algo.history[-1]},
            "build_and_first_generation_ms": (
                (time.perf_counter() - t0) * 1e3 - sum(gen_ms[1:])),
            "generation_ms": gen_ms}, algo


def phase_zoo(torch, np, zoo, egrl, sim, compiler, rdev):
    """The multi-workload path: ``ZooEGRL`` in "ea" mode (3 generations)
    and "egrl" mode (3: the second and third train ZooSAC), then
    ``evaluate_gnn_zoo`` of the "egrl" run's best genome on BERT (8
    Gumbel rollouts and the greedy one), each between a reset and a read
    of the launch counters.  Returns the "egrl" run's counts."""
    out = {}
    for mode in ("ea", "egrl"):
        row, algo = run_zoo(torch, np, zoo, egrl, sim, compiler, rdev, mode, 3)
        emit({"phase": "zoo", **row})
        out[mode] = row
    vec = algo.best_gnn_vec()
    rdev.reset_launch_counts()
    t0 = time.perf_counter()
    speedup = egrl.evaluate_gnn_zoo([zoo.bert()], vec, device="cuda")
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    counts = rdev.launch_counts()
    want = {**{k: 0 for k in counts}, "memsim": 1, "gat_mp": 4,
            "memsim_zoo": 1}
    check(counts == want, f"evaluate_gnn_zoo: launches {counts}, want {want}")
    check(set(speedup) == {"bert"} and np.isfinite(speedup["bert"])
          and speedup["bert"] >= 0.0, f"evaluate_gnn_zoo: {speedup}")
    emit({"phase": "zoo_zero_shot", "holdout": "bert", "speedup": speedup,
          "launches": counts, "wall_ms": wall_ms})
    return out


# ------------------------------------------------------------ shard phase
SHARD_COUNTS = (1, 2, 3)
# generations checked, then 2 more timed in turns; the steady mean is
# over generations 3-5 (the first trains no SAC step, the second the first)
SHARD_GENERATIONS = 3


@contextlib.contextmanager
def one_device_env():
    """``REPRO_POP_SHARDS`` and ``REPRO_BUCKET_DISPATCH`` at "off" for a
    phase that builds its drivers through an entry point: its launch
    counts are those of the one-device path, however many cards the
    host has."""
    old = {k: os.environ.get(k) for k in ("REPRO_POP_SHARDS",
                                          "REPRO_BUCKET_DISPATCH")}
    os.environ.update(dict.fromkeys(old, "off"))
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def sync_all(torch):
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def shard_devices(torch, S):
    """S distinct cards where there are that many, else S times cuda:0;
    and which of the two it is."""
    if S == 1:
        return ["cuda:0"], "one card"
    if torch.cuda.device_count() >= S:
        return [f"cuda:{i}" for i in range(S)], "distinct cards"
    return ["cuda:0"] * S, "all on cuda:0"


def dispatch_devices(torch):
    """Every card where there are several, else cuda:0 twice (two bins
    of the LPT packing on one card); and which of the two it is."""
    n = torch.cuda.device_count()
    if n > 1:
        return [f"cuda:{i}" for i in range(n)], "distinct cards"
    return ["cuda:0"] * 2, "all on cuda:0"


def timed_generation(torch, algo):
    sync_all(torch)
    t = time.perf_counter()
    algo.generation()
    sync_all(torch)
    return (time.perf_counter() - t) * 1e3


def real_rows(pop, n, like):
    """The real rows of a population (sharded or not) on ``like``'s
    device."""
    return (pop.cat(like.device) if hasattr(pop, "cat") else pop)[:n]


def shard_launches(S, gens, sac_steps):
    """What a BERT "egrl" run at S pop shards launches: the compiler
    reference; per generation 4 GAT launches a shard for the population
    and 4 for the PG rollout, one simulator launch a shard and one for
    the PG rollout; per SAC step 8 forward and 8 backward GAT launches."""
    return {"gat_mp": gens * 4 * (S + 1) + 8 * sac_steps,
            "gat_mp_bwd": 8 * sac_steps, "memsim": 1 + gens * (S + 1),
            "memsim_zoo": 0, "flash_attention": 0, "flash_attention_tc": 0,
            "flash_attention_bwd": 0, "flash_attention_bwd_tc": 0,
            "ssd_scan": 0, "ssd_scan_bwd": 0}


def max_rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def phase_shard(torch, np, zoo, egrl, rdev):
    """The search across several devices.  (a) ``EGRL`` on BERT,
    "egrl", at pop_shards 1, 2 and 3 from the same seed (so the same
    draws): identical mappings and replay contents, equal rewards and
    fitness, populations bit-equal or within 1e-6 relative (the largest
    logit difference printed), exact launches.  (b) ``ZooEGRL`` on the
    7 graphs, "egrl", dispatch "async" against "off": bit-equal
    rewards, fitness and populations, the serial launch counts;
    ``device_map()`` and ``measure()``'s per-bucket ms.  (c)
    ``autotune_bucket_k`` on the 7 graphs, and one generation of a zoo
    built with "autotune".  (d) generation ms per S and async / off,
    A/B in turns in this process.  Returns the launch counts of the
    S = 3 run and of the async run."""
    from repro_torch.core import gnn
    from repro_torch.distributed import dispatch
    t_phase = time.perf_counter()
    smi = nvidia_smi()
    n_cards = torch.cuda.device_count()

    # (a) population sharding
    runs, counts = {}, {}
    for S in SHARD_COUNTS:
        devs, where = shard_devices(torch, S)
        rdev.reset_launch_counts()
        algo = egrl.EGRL(zoo.bert(), egrl.EGRLConfig(seed=0), mode="egrl",
                         device="cuda", pop_shards=S, devices=devs)
        ms = [timed_generation(torch, algo) for _ in range(SHARD_GENERATIONS)]
        counts[S] = rdev.launch_counts()
        sac = algo.learner.opt_a["t"]
        want = shard_launches(S, SHARD_GENERATIONS, sac)
        check(counts[S] == want, f"shard S={S}: launches {counts[S]}, the "
              f"path implies {want}")
        check(algo.pop_sharding.n_shards == S, f"shard S={S}: "
              f"{algo.pop_sharding.n_shards} shards")
        runs[S] = (algo, ms, devs, where)
    base = runs[1][0]
    rows = []
    for S in SHARD_COUNTS:
        algo, ms, devs, where = runs[S]
        check([h for h in algo.history] == [h for h in base.history],
              f"shard S={S}: rewards or fitness differ from S=1: "
              f"{algo.history[-1]} vs {base.history[-1]}")
        check(np.array_equal(algo.best_mapping, base.best_mapping),
              f"shard S={S}: best mapping differs")
        n = base.buffer.size
        check(algo.buffer.size == n and np.array_equal(
            algo.buffer.actions[:n], base.buffer.actions[:n]) and
            np.array_equal(algo.buffer.rewards[:n], base.buffer.rewards[:n]),
            f"shard S={S}: replay contents differ")
        g0, b0 = base.gnn_pop, base.bz_pop
        g = real_rows(algo.gnn_pop, algo.n_g, g0)
        b = real_rows(algo.bz_pop, algo.n_b, b0)
        bit_equal = bool(torch.equal(g, g0) and torch.equal(b, b0))
        rel = max(max_rel(g, g0), max_rel(b, b0))
        check(bit_equal or rel <= 1e-6, f"shard S={S}: populations differ "
              f"by {rel} relative")
        # the forward's rounding at P/S rows against P rows, on the same
        # population (S=1's)
        with torch.no_grad():
            full = gnn.population_logits(g0, base.feats, base.adj)
            blocks = torch.cat([gnn.population_logits(blk, base.feats,
                                                      base.adj)
                                for blk in torch.tensor_split(
                                    torch.nn.functional.pad(
                                        g0, (0, 0, 0, algo.n_g_pad - algo.n_g)),
                                    S)])[:algo.n_g]
        rows.append({"S": S, "devices": devs, "placement": where,
                     "padded_rows": [algo.n_g_pad, algo.n_b_pad],
                     "generation_ms": ms, "launches": counts[S],
                     "populations_bit_equal": bit_equal,
                     "population_max_rel_diff": rel,
                     "max_logit_diff_blocks_vs_full": float(
                         (blocks - full).abs().max()),
                     "mappings_identical": True})
    # generations 4 and 5, the runs in turns: the A/B of S
    for _ in range(2):
        for S in SHARD_COUNTS:
            runs[S][1].append(timed_generation(torch, runs[S][0]))
    for r, S in zip(rows, SHARD_COUNTS):
        check(runs[S][0].history == base.history,
              f"shard S={S}: the timed generations diverged")
        r["generation_ms"] = runs[S][1]
        r["steady_generation_ms"] = float(np.mean(runs[S][1][2:]))
        emit({"phase": "shard_population", "graph": "bert", "mode": "egrl",
              "cards": n_cards, **r, "nvidia_smi": smi})
    del runs

    # (b) per-bucket dispatch against the serial path
    graphs = [make() for make in zoo.WORKLOADS.values()]
    cfg = egrl.EGRLConfig(seed=0)
    devs, where = dispatch_devices(torch)
    zruns, zcounts = {}, {}
    for policy in ("async", "off"):
        rdev.reset_launch_counts()
        algo = egrl.ZooEGRL(graphs, cfg, mode="egrl", buckets="auto",
                            device="cuda", pop_shards="off",
                            dispatch=policy, devices=devs)
        ms = [timed_generation(torch, algo) for _ in range(SHARD_GENERATIONS)]
        zcounts[policy] = rdev.launch_counts()
        K = algo.zoo.n_buckets
        want = zoo_launches(K, len(graphs), SHARD_GENERATIONS,
                            algo.learner.opt_a["t"])
        check(zcounts[policy] == want, f"dispatch {policy}: launches "
              f"{zcounts[policy]}, the serial path implies {want}")
        zruns[policy] = (algo, ms)
    (a, a_ms), (o, o_ms) = zruns["async"], zruns["off"]
    check(a.dispatch is not None and o.dispatch is None,
          "dispatch: async built no dispatcher, or off built one")
    check(a.history == o.history and np.array_equal(a.best_reward,
                                                    o.best_reward),
          "dispatch: async rewards or fitness differ from off")
    check(all(np.array_equal(x, y) for x, y in
              zip(a.best_mapping, o.best_mapping)),
          "dispatch: best mappings differ")
    check(torch.equal(a.gnn_pop, o.gnn_pop) and torch.equal(a.bz_pop,
                                                            o.bz_pop),
          "dispatch: populations differ")
    for _ in range(2):
        for policy in ("async", "off"):
            zruns[policy][1].append(timed_generation(torch,
                                                     zruns[policy][0]))
    check(a.history == o.history, "dispatch: the timed generations diverged")
    dmap = a.dispatch.device_map()
    bucket_ms = a.dispatch.measure(a.gnn_pop)
    emit({"phase": "shard_dispatch", "graphs": list(a.zoo.names),
          "buckets": [list(b.names) for b in a.zoo.buckets],
          "devices": devs, "placement": where,
          "device_map": dmap, "device_map_measured": a.dispatch.device_map(),
          "measure_bucket_ms": bucket_ms,
          "launches_async": zcounts["async"], "launches_off": zcounts["off"],
          "bit_equal": True,
          "generation_ms_async": a_ms, "generation_ms_off": o_ms,
          "steady_generation_ms_async": float(np.mean(a_ms[2:])),
          "steady_generation_ms_off": float(np.mean(o_ms[2:])),
          "nvidia_smi": smi})
    del zruns, a, o

    # (c) the autotuned bucket count
    dispatch._AUTOTUNE_CACHE.clear()
    t0 = time.perf_counter()
    k = dispatch.autotune_bucket_k(graphs, device="cuda")
    tune_ms = (time.perf_counter() - t0) * 1e3
    report = dispatch.autotune_report(graphs, device="cuda")
    rdev.reset_launch_counts()
    algo = egrl.ZooEGRL(graphs, cfg, mode="egrl", buckets="autotune",
                        device="cuda", pop_shards="off", dispatch="off")
    gen_ms = timed_generation(torch, algo)
    got = rdev.launch_counts()
    from repro_torch.graphs.bucketed import assign_buckets
    assign = assign_buckets([g.n for g in graphs], k)
    check(algo.zoo.graph_bucket == tuple(assign), f"autotune: the zoo's "
          f"buckets {algo.zoo.graph_bucket} are not K={k}'s {assign}")
    want = zoo_launches(algo.zoo.n_buckets, len(graphs), 1, 0)
    check(got == want, f"autotune: launches {got}, want {want}")
    check(np.isfinite(algo.history[-1]["gen_best_fitness"]),
          "autotune: non-finite fitness")
    emit({"phase": "shard_autotune", "chosen_k": k,
          "buckets": [list(b.names) for b in algo.zoo.buckets],
          "c0": report["c0"], "c1": report["c1"],
          "predicted_ms": report["predicted_ms"], "n_dev": report["n_dev"],
          "probe_ms": report["probe_ms"],
          "probe_buckets": report["probe_buckets"], "autotune_ms": tune_ms,
          "generation_ms": gen_ms, "launches": got, "nvidia_smi": smi})
    emit({"phase_done": "shard", "seconds": time.perf_counter() - t_phase})
    return counts[SHARD_COUNTS[-1]], zcounts["async"]


def phase_profile(torch, egrl, zoo, mode="ea", generations=3, multi=False):
    """Device time by kernel over steady BERT generations (``multi``: of
    ``ZooEGRL`` on the 7-graph zoo, "auto" buckets) (torch.profiler),
    against the host clock of the same window.  Two generations run
    first, so in "egrl" mode the buffer holds a batch and the profiled
    generations train."""
    cfg = egrl.EGRLConfig(seed=1)
    algo = (egrl.ZooEGRL([make() for make in zoo.WORKLOADS.values()], cfg,
                         mode=mode, buckets="auto", device="cuda",
                         pop_shards="off", dispatch="off") if multi
            else egrl.EGRL(zoo.bert(), cfg, mode=mode, device="cuda",
                           pop_shards="off"))
    for _ in range(2):
        algo.generation()
    torch.cuda.synchronize()
    with padded_profile() as prof:
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
    mine = {tag: {"calls": sum(k["calls"] for k in kernels
                               if tag in k["name"]),
                  "device_ms": sum(k["device_ms"] for k in kernels
                                   if tag in k["name"])}
            for tag in ("gat_fwd_kernel", "gat_bwd_kernel", "memsim_kernel",
                        "memsim_zoo_kernel")}
    emit({"phase": "profile", "graph": "zoo7" if multi else "bert",
          "mode": mode,
          "generations": generations, "wall_ms": wall_ms, "device_busy_ms": busy,
          "device_idle_share": (1.0 - busy / wall_ms) if kernels
          else "not measured", "kernel_device": mine,
          "top_kernels": kernels[:12]})


# ------------------------------------------------------------ serve runs
# The serve phase's runs: (arch, requests, slots, new tokens, prompt
# lengths, kernel launches per request).  Each prefill runs at B = 1, and
# the flash and ssd phases check the kernels at every (arch, prompt
# length) pair here, so the shapes checked are the shapes served.
# (arch, requests, slots, new tokens, prompt lengths, launches per
# request, layers kept: None for the published depth).  qwen3-moe and
# chameleon keep their widths and are cut in depth to fit f32 parameters
# on the card: qwen3-moe 623 M a layer (its 128 experts' three (2048,
# 768) matrices) and 622 M of embeddings, 16 of 48 layers ~42 GB;
# chameleon 692 M a layer and 1.07 B of embeddings, 8 of 48 ~26.5 GB
# qwen3-0.6b's traffic (requests, slots, new tokens, prompt lengths):
# also the serve_mesh phase's (tools/serve_mesh.py), whose one-card
# layout is held bit-equal to this run
SERVE_MESH_TRAFFIC = (8, 4, 32, (256, 512, 1024, 2048))
SERVE_RUNS = (
    ("zamba2-1.2b", 8, 4, 32, (256, 512, 1024, 2048),
     {"flash_attention": 6, "flash_attention_tc": 6, "ssd_scan": 38}, None),
    ("mamba2-780m", 2, 2, 16, (1024, 2048), {"ssd_scan": 48}, None),
    ("qwen3-0.6b", *SERVE_MESH_TRAFFIC,
     {"flash_attention": 28, "flash_attention_tc": 28}, None),
    ("qwen3-moe-30b-a3b", 2, 2, 16, (1024, 2048),
     {"flash_attention": 16, "flash_attention_tc": 16}, 16),
    ("chameleon-34b", 2, 2, 16, (1024, 2048),
     {"flash_attention": 8, "flash_attention_tc": 8}, 8),
)
SERVE_MAX_LEN = 2112

# serve_encdec: seamless-m4t-medium at its published config (6 + 6
# layers), a batch of 4 frame sequences, greedy decode steps
ENCDEC_ARCH = "seamless-m4t-medium"
ENCDEC_BATCH = 4
ENCDEC_FRAMES = 2048
ENCDEC_STEPS = 32

# the train phase: qwen3-0.6b at its published config, train_4k's
# sequence length, a global batch of 4
TRAIN_ARCH = "qwen3-0.6b"
TRAIN_SEQ = 4096
TRAIN_BATCH = 4
TRAIN_STEPS = 10
# the MoE train phase: (arch, layers kept, microbatches).  qwen3-moe at
# full width, 4 of 48 layers (3.1 B parameters, f32, with AdamW's two
# moments and the f32 gradient accumulator ~50 GB); its config's 16
# microbatches of train_4k's batch 256 cut to 4 of one row each:
# routing and capacity are per row, so the rows' numbers do not change
MOE_TRAIN = ("qwen3-moe-30b-a3b", 4, 4)
# the repeat run of the MoE and encdec train phases: this many steps
# from the same seed, bit-equal to the first run's
REPEAT_STEPS = 5
# train_mesh: steps a layout runs (phase_train's run A gives the one-card
# reference's checksums after as many); the worker's time limit
MESH_STEPS = 3
MESH_TIMEOUT_S = 1800
# qwen2.5-14b's sequence-parallel run in train_mesh: its 40 query heads
# on a "model" axis of SP_RANKS cards (they do not divide it), so each
# rank attends with S / SP_RANKS query rows; S = SP_SEQ divides by it
SP_RANKS = 3
SP_SEQ = 3072


def served_prefills():
    """(config, prompt length) of every prefill shape the serve runs give."""
    from repro_torch.configs.registry import get_config
    return [(get_config(run[0]), S) for run in SERVE_RUNS for S in run[4]]


def encdec_attention(cfg, B, Se, St):
    """(name, B, Sq, Sk, K, G, h, causal) of the encdec model's three
    attentions: the encoder's self-attention over Se frames, the
    decoder's causal self-attention over St tokens and its
    cross-attention of St queries over the Se frames."""
    K, G, h = cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim
    return [(f"{cfg.name}:enc", B, Se, Se, K, G, h, False),
            (f"{cfg.name}:dec", B, St, St, K, G, h, True),
            (f"{cfg.name}:cross", B, St, Se, K, G, h, False)]


# ------------------------------------------------------ attention kernel
FLASH_TILE = 64            # BK of the fp32-core kernel: keys per tile
# the attention backward's CUDA kernels, by route
BWD_TC_KERNELS = ("flash_bwd_prep", "flash_bwd_dq_wgmma",
                  "flash_bwd_dkdv_wgmma")
BWD_FP32_KERNELS = ("flash_bwd_dq", "flash_bwd_dkdv")
ATTN_CHUNK = 1024          # ModelConfig.attn_chunk of the served configs


def flash_cases():
    """(name, B, S, Sk, K, G, h, dtype, causal, q_offset): every attention
    prefill of the serve runs of the dense and hybrid families (zamba2's
    shared block, 32 heads of 64; qwen3-0.6b, 8 KV heads of 128 with 2
    queries each), then zamba2's heads in f32, without the causal mask,
    at S = 100 (not a multiple of a tile) and 512 queries at positions
    512.. over 1024 keys, and qwen3's heads at S = 100."""
    cases = [(cfg.name, 1, S, S, cfg.n_kv_heads, cfg.q_per_kv,
              cfg.head_dim, cfg.dtype, True, 0)
             for cfg, S in served_prefills()
             if cfg.family in ("dense", "hybrid")]
    zamba = next(c for c in cases if c[0] == "zamba2-1.2b")
    qwen = next(c for c in cases if c[0] == "qwen3-0.6b")
    K, G, h, dtype = zamba[4:8]
    return cases + [
        ("zamba2-1.2b:f32", 1, 1024, 1024, K, G, h, "float32", True, 0),
        ("zamba2-1.2b:non-causal", 1, 1024, 1024, K, G, h, dtype, False, 0),
        ("zamba2-1.2b:S=100", 1, 100, 100, K, G, h, dtype, True, 0),
        ("zamba2-1.2b:offset", 1, 512, 1024, K, G, h, dtype, True, 512),
        ("qwen3-0.6b:S=100", 1, 100, 100, *qwen[4:8], True, 0)]


# the MoE, VLM and encdec families' attention cases draw their inputs
# from a generator of their own, so that the cases before them (and the
# phases after the flash phase) keep the inputs they had without them
FAMILY_SEED = 1


def flash_family_cases():
    """``flash_cases`` of the MoE, VLM and encdec families: the serve
    runs' prefills of qwen3-moe (4 KV heads with 8 queries each, h 128)
    and chameleon (8 with 8), seamless's encoder over serve_encdec's
    frames (16 heads of 64, non-causal), cross-attention (non-causal, Sq
    != Sk): seamless's heads at 4096 queries over 2048 frames and
    qwen3-0.6b's at 300 over 1024, and llama4's heads (8 KV heads with
    5 queries each, h 128), then qwen2.5-14b's sequence-parallel
    prefill over ``SP_RANKS`` cards (8 KV heads with 5 queries each, h
    128): each rank's ceil(S/3) query rows at their first position over
    every key, at prompts of 256 and 2048 (the last rank's block runs
    one row past the prompt, as serve_mesh pads it); last granite-3-8b's
    heads (8 KV heads with 4 queries each, h 128) at the train_mesh
    phase's S 4096, one microbatch's row (B 16 over 4 cards, 4
    microbatches)."""
    from repro_torch.configs.registry import get_config
    cases = [(cfg.name, 1, S, S, cfg.n_kv_heads, cfg.q_per_kv,
              cfg.head_dim, cfg.dtype, True, 0)
             for cfg, S in served_prefills()
             if cfg.family in ("moe", "vlm")]
    ed = get_config(ENCDEC_ARCH)
    enc = encdec_attention(ed, ENCDEC_BATCH, ENCDEC_FRAMES, 1)[0]
    qwen = get_config("qwen3-0.6b")
    ll4 = get_config("llama4-maverick-400b-a17b")
    q25 = get_config("qwen2.5-14b")
    heads = lambda c: (c.n_kv_heads, c.q_per_kv, c.head_dim)  # noqa: E731
    gr = get_config("granite-3-8b")
    return cases + [
        enc[:7] + (ed.dtype, False, 0),
        ("cross:Sq=4096,Sk=2048", 1, 4096, 2048, *heads(ed), ed.dtype,
         False, 0),
        ("cross:Sq=300,Sk=1024", 1, 300, 1024, *heads(qwen), qwen.dtype,
         False, 0),
        ("llama4-heads", 1, 2048, 2048, *heads(ll4), ll4.dtype, True, 0)
    ] + [(f"qwen2.5-14b:SP S={S} rank {r}", 1, c, S, *heads(q25),
          q25.dtype, True, r * c)
         for S in (256, 2048) for c in (-(-S // SP_RANKS),)
         for r in range(SP_RANKS)] + [
        ("granite-3-8b:train", 1, TRAIN_SEQ, TRAIN_SEQ, *heads(gr),
         gr.dtype, True, 0)]


def flash_error(torch, got, want, bf16):
    """The kernel's output against the plain version's.  f32: within 1e-5
    of the largest element.  bf16: both round f32 sums to bf16, and each
    rounds its bf16 probabilities against its own running max (64-key
    tiles here, attn_chunk keys there), which moves a short row's sum by
    up to about 1e-3.  So each element lies within one ulp of its own
    magnitude plus 2e-3, and on the rows past the first KV tile the RMS
    error lies within 2**-7 of the output's RMS: rounding alone gives
    about 2e-3 of it, while a key lost or added in every row moves row i
    by about 1/sqrt(i) of its value, 0.07 of the RMS at S = 2048."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    err = {"max_abs_err": d.max().item(), "scale": w.abs().max().item()}
    late_d, late_w = d[:, FLASH_TILE:], w[:, FLASH_TILE:]
    if late_d.numel():
        err["max_abs_err_past_first_tile"] = late_d.max().item()
        err["rel_rms_err_past_first_tile"] = (
            late_d.square().mean().sqrt() / late_w.square().mean().sqrt()
        ).item()
    if not bf16:
        err["tolerance"] = 1e-5 * err["scale"]
        err["within_tolerance"] = err["max_abs_err"] <= err["tolerance"]
        return err
    err["tolerance"] = "2**-7 |want| + 2e-3; past tile 1: rel RMS 2**-7"
    over = d - (2.0 ** -7 * w.abs() + 2e-3)
    err["worst_over_elementwise_limit"] = over.max().item()
    err["within_tolerance"] = (
        err["worst_over_elementwise_limit"] <= 0
        and err.get("rel_rms_err_past_first_tile", 0.0) <= 2 ** -7)
    return err


def sdpa_attention(torch, q, k, v, causal, q_offset=0):
    """One scaled_dot_product_attention call computing the same function
    on the same tensors (heads moved to dim 1 as strided views), timed as
    a yardstick only.  Queries at positions Sk - Sq.. take SDPA's
    lower-right causal mask, at any other offset a boolean mask."""
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right
    B, S, K, G, h = q.shape
    Sk = k.shape[1]
    qs = q.view(B, S, K * G, h).transpose(1, 2)
    ks, vs = k.transpose(1, 2), v.transpose(1, 2)
    if causal and (S != Sk or q_offset):
        if q_offset == Sk - S:
            mask = causal_lower_right(S, Sk)
        else:       # query i sees keys <= i + q_offset
            mask = (torch.arange(Sk, device=q.device)[None]
                    <= torch.arange(S, device=q.device)[:, None] + q_offset)
        return lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=G > 1)
    return lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=causal, enable_gqa=G > 1)


def attention_pairs(Sq, Sk, causal, q_offset):
    """(query, key) pairs the masks leave: query i sees keys <= i +
    q_offset when causal."""
    if not causal:
        return Sq * Sk
    return sum(min(Sk, i + q_offset + 1) for i in range(Sq))


def phase_flash(torch, fops, gen):
    """The attention kernels against ``flash_attention_plain`` (chunks of
    attn_chunk keys, as the models call it) on the same inputs, held as
    ``flash_error`` says.  The wrapper's route must be the tensor cores
    for every bf16 case (h = 64 and 128) and the fp32 cores for f32;
    each bf16 case also runs the fp32-core kernel on the same tensors
    (behind the wrapper: its counter still counts), checked and timed
    in the same way.  ``flash_family_cases`` draw from a generator of
    their own (``FAMILY_SEED``)."""
    rows = {}
    family_gen = torch.Generator("cuda").manual_seed(FAMILY_SEED)
    for (name, B, S, Sk, K, G, h, dtype, causal, off), case_gen in (
            [(c, gen) for c in flash_cases()]
            + [(c, family_gen) for c in flash_family_cases()]):
        dt = getattr(torch, dtype)
        bf16 = dt == torch.bfloat16
        def draw(*shape):
            return torch.randn(shape, generator=case_gen,
                               device="cuda").to(dt)
        q, k, v = draw(B, S, K, G, h), draw(B, Sk, K, h), draw(B, Sk, K, h)
        chunk = min(ATTN_CHUNK, Sk)
        route = fops.kernel_route(q, k, v)
        check(route == ("tensor_cores" if bf16 else "fp32_cores"),
              f"flash {name}: route {route}")
        tc0 = fops.flash_attention.tensor_core_launches
        got = fops.flash_attention(q, k, v, causal=causal, q_offset=off)
        check(fops.flash_attention.tensor_core_launches - tc0
              == (route == "tensor_cores"), f"flash {name}: route counter")
        want = fops.flash_attention_plain(q, k, v, chunk=chunk, causal=causal,
                                          q_offset=off)
        lib = sdpa_attention(torch, q, k, v, causal, off)
        lib_out = lib()
        torch.cuda.synchronize()
        check(got.dtype == dt and got.shape == q.shape, f"flash {name}: out")
        check(bool(torch.isfinite(got).all()), f"flash {name}: not finite")
        err = flash_error(torch, got, want, bf16)
        check(err["within_tolerance"], f"flash {name} S={S}: error {err}")
        H = K * G
        flops = 4 * B * H * h * attention_pairs(S, Sk, causal, off)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        b_ms, b_by = bound(nbytes, flops, PEAK_BF16 if bf16 else PEAK_F32)
        row = {"phase": "flash", "case": name, "B": B, "S": S, "Sk": Sk,
               "q_offset": off, "K": K, "G": G, "h": h, "dtype": dtype,
               "causal": causal, "route": route, **err,
               "sdpa_max_abs_err_vs_plain":
                   (lib_out.transpose(1, 2).reshape(want.shape).float()
                    - want.float()).abs().max().item(),
               "ms": event_ms(torch, lambda: fops.flash_attention(
                   q, k, v, causal=causal, q_offset=off), 20),
               "plain_ms": event_ms(torch, lambda: fops.flash_attention_plain(
                   q, k, v, chunk=chunk, causal=causal, q_offset=off), 3,
                   warmup=1),
               "library_ms": event_ms(torch, lib, 20),
               "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
               "bytes": nbytes}
        row.update(profiled(torch, lambda: fops.flash_attention(
            q, k, v, causal=causal, q_offset=off)))
        row.update(profiled(torch, lib, "library_device_ms"))
        if bf16:
            f32c = fops._launch_fp32cores(q, k, v, causal, off)
            torch.cuda.synchronize()
            err32 = flash_error(torch, f32c, want, True)
            check(err32["within_tolerance"],
                  f"flash {name} S={S}, fp32-core route: error {err32}")
            row["fp32_cores_err"] = err32
            row["ms_fp32_cores"] = event_ms(
                torch, lambda: fops._launch_fp32cores(q, k, v, causal, off),
                5)
        row["tflops"] = flops / row["ms"] / 1e9
        row["bound_share"] = b_ms / row["ms"]
        row["ms_over_library"] = row["ms"] / row["library_ms"]
        emit(row)
        rows[name, S] = row
    return rows


# ------------------------------------------------ attention backward kernel
def flash_bwd_cases():
    """(name, B, S, Sk, K, G, h, dtype, causal, q_offset): the train
    phase's attention (qwen3-0.6b at S = 4096, B = 4: 8 KV heads of 128
    with 2 queries each, bf16, causal), then f32 at every head dim the
    kernel takes, bf16 at h = 64 (zamba2's heads), without the causal
    mask, at S = 100 (not a multiple of a tile), 512 queries at
    positions 512.. over 1024 keys, G = 1 and B = 1; zamba2's heads at
    S = 4096; and 300 queries at positions 700.. over 1000 keys, so that
    the ragged last key tile and key tiles whose first visible query
    row is not a multiple of a tile are both crossed.  Every bf16 case
    takes the tensor-core route (h = 64 or 128)."""
    from repro_torch.configs.registry import get_config
    cfg = get_config("qwen3-0.6b")
    K, G, h = cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim
    bf = "bfloat16"
    return [("qwen3-0.6b:train", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, K, G, h,
             cfg.dtype, True, 0)] + [
        (f"f32:h={hd}", 2, 256, 256, 2, 2, hd, "float32", True, 0)
        for hd in (16, 32, 64, 128)] + [
        ("bf16:h=64", 1, 1024, 1024, 32, 1, 64, bf, True, 0),
        ("non-causal", 1, 1024, 1024, K, G, h, bf, False, 0),
        ("f32:non-causal", 1, 256, 256, K, G, 32, "float32", False, 0),
        ("S=100", 1, 100, 100, K, G, h, bf, True, 0),
        ("f32:S=100", 1, 100, 100, K, G, 64, "float32", True, 0),
        ("offset", 1, 512, 1024, K, G, h, bf, True, 512),
        ("G=1", 1, 1024, 1024, 2 * K, 1, h, bf, True, 0),
        ("B=1", 1, 2048, 2048, K, G, h, bf, True, 0),
        ("bf16:h=64:S=4096", 1, 4096, 4096, 32, 1, 64, bf, True, 0),
        ("ragged:Sq=300,Sk=1000", 1, 300, 1000, K, G, h, bf, True, 700)]


def flash_bwd_family_cases():
    """``flash_bwd_cases`` of the MoE and encdec train phases' attentions:
    qwen3-moe's (4 KV heads with 8 queries each, h 128) at one
    microbatch's row, S = 4096; seamless's encoder (2048 frames,
    non-causal), decoder (4096 tokens, causal) and cross-attention
    (4096 queries over 2048 frames, non-causal) at B = 4, 16 heads of
    64; then 300 queries over 1024 keys without the causal mask
    (qwen3-0.6b's heads), llama4's heads (8 KV heads with 5 queries
    each) and chameleon's (8 with 8); last the sequence-parallel
    attention of the train_mesh phase's qwen2.5-14b run (8 KV heads with
    5 queries each, h 128, one microbatch's row): rank r of m = 3 takes
    the S/m query rows at causal offset S r / m over all S = 3072 keys,
    r = 1 and 2; and granite-3-8b's train_mesh attention (8 KV heads
    with 4 queries each, h 128, S 4096, one microbatch's row); bf16, on
    the tensor cores."""
    from repro_torch.configs.registry import get_config
    bf = "bfloat16"
    heads = lambda c: (c.n_kv_heads, c.q_per_kv, c.head_dim)  # noqa: E731
    moe, ed = get_config(MOE_TRAIN[0]), get_config(ENCDEC_ARCH)
    cases = [(f"{MOE_TRAIN[0]}:train", TRAIN_BATCH // MOE_TRAIN[2],
              TRAIN_SEQ, TRAIN_SEQ, *heads(moe), bf, True, 0)]
    cases += [(f"{n}:train", B, Sq, Sk, Kc, Gc, hc, bf, causal, 0)
              for n, B, Sq, Sk, Kc, Gc, hc, causal in encdec_attention(
                  ed, TRAIN_BATCH, ENCDEC_FRAMES, TRAIN_SEQ)]
    return cases + [
        ("cross:Sq=300,Sk=1024", 1, 300, 1024,
         *heads(get_config("qwen3-0.6b")), bf, False, 0),
        ("llama4-heads", 1, 1024, 1024,
         *heads(get_config("llama4-maverick-400b-a17b")), bf, True, 0),
        ("chameleon-heads", 1, 1024, 1024,
         *heads(get_config("chameleon-34b")), bf, True, 0)] + [
        (f"qwen2.5-14b:sp:r={r}", 1, SP_SEQ // SP_RANKS, SP_SEQ,
         *heads(get_config("qwen2.5-14b")), bf, True,
         SP_SEQ * r // SP_RANKS) for r in (1, 2)] + [
        ("granite-3-8b:train", 1, TRAIN_SEQ, TRAIN_SEQ,
         *heads(get_config("granite-3-8b")), bf, True, 0)]


def flash_bwd_error(torch, got, want, bf16):
    """A gradient of the kernel against the plain version's.  f32: within
    1e-4 of the largest element (both sum up to S products in f32, in
    another order; a lost or added key moves a row by O(1) of it).
    bf16: both round p and ds to bf16 before their products, and a
    probability one f32 ulp apart may round the other way.  A gradient
    element sums terms that cancel (dq_i = sum_j ds_ij k_j, and the
    ds_ij of a row sum to 0), so one such flip moves even a small element
    by about one bf16 ulp of its largest terms, which are of the order
    of the gradient's largest element: each element lies within 2**-6
    of the largest element (two ulps), and the RMS error, which any
    lost, added or misplaced key raises in every row it touches, within
    2**-7 of the RMS."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    rms = w.square().mean().sqrt().item()
    err = {"max_abs_err": d.max().item(), "scale": w.abs().max().item(),
           "rel_rms_err": d.square().mean().sqrt().item() / max(rms, 1e-30)}
    if not bf16:
        err["within_tolerance"] = err["max_abs_err"] <= 1e-4 * err["scale"]
        return err
    err["within_tolerance"] = (err["max_abs_err"] <= 2 ** -6 * err["scale"]
                               and err["rel_rms_err"] <= 2 ** -7)
    return err


def sdpa_backward(torch, q, k, v, g, causal, q_offset=0):
    """SDPA's backward on the same inputs, KV expanded to every query
    head (the yardstick's layout): one ``autograd.grad`` call of a
    retained graph, timed as a yardstick only."""
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right
    B, S, K, G, h = q.shape
    Sk = k.shape[1]
    qs = q.reshape(B, S, K * G, h).transpose(1, 2).detach().requires_grad_()
    ks = k.repeat_interleave(G, dim=2).transpose(1, 2).detach() \
        .requires_grad_()
    vs = v.repeat_interleave(G, dim=2).transpose(1, 2).detach() \
        .requires_grad_()
    if causal and q_offset and q_offset == Sk - S:
        out = F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=causal_lower_right(S, Sk))
    elif causal and (S != Sk or q_offset):
        # SDPA's causal masks align at the top left or the bottom right:
        # any other offset (a middle rank's query rows) as a dense mask
        pos = torch.arange(S, device=q.device)[:, None] + q_offset
        out = F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=torch.arange(Sk, device=q.device) <= pos)
    else:
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
    gs = g.reshape(B, S, K * G, h).transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qs, ks, vs), gs,
                                       retain_graph=True)


def flash_bwd_autograd(torch, fops, q, k, v, g, causal, off, chunk,
                       plain_out, plain_lse, bf16):
    """The route training takes: ``flash_attention`` on q, k, v that
    require grad, then ``torch.autograd.grad`` of its output for g (the
    forward kernel with its lse buffer, ``_FlashAttention`` saving out
    and lse, the backward kernel).  Its output against
    ``flash_attention_plain`` and its three gradients against
    ``flash_attention_bwd_plain`` on the plain forward's out and lse,
    held as ``flash_error`` and ``flash_bwd_error`` say."""
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out = fops.flash_attention(*leaves, causal=causal, q_offset=off)
    grads = torch.autograd.grad(out, leaves, g)
    want = fops.flash_attention_bwd_plain(q, k, v, plain_out, plain_lse, g,
                                          chunk=chunk, causal=causal,
                                          q_offset=off)
    torch.cuda.synchronize()
    errs = {"out": flash_error(torch, out.detach(), plain_out, bf16)}
    for what, a, c in zip(("dq", "dk", "dv"), grads, want):
        check(a.dtype == c.dtype and a.shape == c.shape,
              f"flash_bwd autograd: {what} dtype/shape")
        errs[what] = flash_bwd_error(torch, a, c, bf16)
    for what, err in errs.items():
        check(err["within_tolerance"],
              f"flash_bwd autograd: {what} error {err}")
    return errs


def phase_flash_bwd(torch, fops, gen):
    """The backward kernel (``csrc/flash_attention_bwd.cu``) against
    ``flash_attention_bwd_plain`` (chunks of attn_chunk keys, as the
    models call it) on the same q, k, v, cotangent and the forward
    kernel's out and lse, held as ``flash_bwd_error`` says; launched
    twice for bit-equal gradients.  The forward kernel, called through
    ``flash_attention(..., return_lse=True)``, gives an output held
    against ``flash_attention_plain``'s as ``flash_error`` says, bit-equal
    to its output without lse, and an lse within 1e-5 (1 + |lse|) of the
    plain version's (both f32).  At the train shape the route training
    takes is also held end to end (``flash_bwd_autograd``).  The route
    (``bwd_route``) must be the tensor cores for every bf16 case and the
    fp32 cores for f32, and its counter must count it; each bf16 case
    also runs the fp32-core kernels on the same inputs, held and timed
    the same way (``fp32_cores_err``, ``ms_fp32_cores``).  Each row:
    ``ms`` (CUDA events), ``device_ms`` (profiler, every CUDA kernel of a
    call; at S = 4096 from windows of one call, ``one_call_windows``),
    ``plain_ms``, ``library_ms`` (SDPA's backward), and ``bound_ms``: the
    larger of the bytes (q, k, v, out, do, lse read; dq, dk, dv written)
    over 3.35 TB/s and the five products' operations on the unmasked
    pairs over the bf16 or f32 peak.  ``flash_bwd_family_cases`` draw
    from a generator of their own (``FAMILY_SEED``)."""
    rows = {}
    family_gen = torch.Generator("cuda").manual_seed(FAMILY_SEED)
    for (name, B, S, Sk, K, G, h, dtype, causal, off), case_gen in (
            [(c, gen) for c in flash_bwd_cases()]
            + [(c, family_gen) for c in flash_bwd_family_cases()]):
        dt = getattr(torch, dtype)
        bf16 = dt == torch.bfloat16
        def draw(*shape):
            return torch.randn(shape, generator=case_gen,
                               device="cuda").to(dt)
        q, k = draw(B, S, K, G, h), draw(B, Sk, K, h)
        v, g = draw(B, Sk, K, h), draw(B, S, K, G, h)
        chunk = min(ATTN_CHUNK, Sk)
        out, lse = fops.flash_attention(q, k, v, causal=causal, q_offset=off,
                                        return_lse=True)
        out_without_lse = fops.flash_attention(q, k, v, causal=causal,
                                               q_offset=off)
        plain_out, plain_lse = fops.flash_attention_plain(
            q, k, v, chunk=chunk, causal=causal, q_offset=off,
            return_lse=True)
        route = fops.bwd_route(q, k, v, out, g)
        check(route == ("tensor_cores" if bf16 else "fp32_cores"),
              f"flash_bwd {name}: route {route}")
        tc0 = fops.flash_attention_bwd.tensor_core_launches
        grads = fops.flash_attention_bwd(q, k, v, out, lse, g, causal=causal,
                                         q_offset=off)
        again = fops.flash_attention_bwd(q, k, v, out, lse, g,
                                         causal=causal, q_offset=off)
        check(fops.flash_attention_bwd.tensor_core_launches - tc0
              == 2 * (route == "tensor_cores"),
              f"flash_bwd {name}: route counter")
        want = fops.flash_attention_bwd_plain(q, k, v, out, lse, g,
                                               chunk=chunk, causal=causal,
                                               q_offset=off)
        torch.cuda.synchronize()
        check(torch.equal(out, out_without_lse),
              f"flash_bwd {name}: the forward with lse is not bit-equal to "
              f"the forward without")
        out_err = flash_error(torch, out, plain_out, bf16)
        check(out_err["within_tolerance"],
              f"flash_bwd {name}: forward error {out_err}")
        lse_err = (lse - plain_lse).abs()
        check(bool((lse_err <= 1e-5 * (1 + plain_lse.abs())).all()),
              f"flash_bwd {name}: lse error {lse_err.max().item()}")
        errs = {}
        for what, a, b, c in zip(("dq", "dk", "dv"), grads, again, want):
            check(a.dtype == dt and a.shape == c.shape,
                  f"flash_bwd {name}: {what} dtype/shape")
            check(bool(torch.isfinite(a).all()), f"flash_bwd {name}: {what} "
                  f"not finite")
            check(torch.equal(a, b), f"flash_bwd {name}: {what} differs "
                  f"between two launches")
            errs[what] = flash_bwd_error(torch, a, c, bf16)
            check(errs[what]["within_tolerance"],
                  f"flash_bwd {name}: {what} error {errs[what]}")
        H = K * G
        flops = 10 * B * H * h * attention_pairs(S, Sk, causal, off)
        nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() \
            + lse.numel() * 4
        b_ms, b_by = bound(nbytes, flops, PEAK_BF16 if bf16 else PEAK_F32)

        def call():
            fops.flash_attention_bwd(q, k, v, out, lse, g, causal=causal,
                                     q_offset=off)
        lib = sdpa_backward(torch, q, k, v, g, causal, off)
        # at S = 4096 one call a window: windows of 5 calls lost launches
        device = (one_call_windows(torch, call, 3 if route == "tensor_cores"
                                   else 2) if S >= 4096
                  else profiled(torch, call, reps=20))
        row = {"phase": "flash_bwd", "case": name, "B": B, "S": S, "Sk": Sk,
               "q_offset": off, "K": K, "G": G, "h": h, "dtype": dtype,
               "causal": causal, "route": route, "err": errs,
               "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
               "lse_max_abs_err": lse_err.max().item(),
               "out_max_abs_err": out_err["max_abs_err"],
               "ms": event_ms(torch, call, 5 if S >= 4096 else 20),
               **device,
               "plain_ms": event_ms(torch, lambda: fops
                                    .flash_attention_bwd_plain(
                                        q, k, v, out, lse, g, chunk=chunk,
                                        causal=causal, q_offset=off), 2,
                                    warmup=1),
               "library_ms": event_ms(torch, lib, 10),
               "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
               "bytes": nbytes}
        if name == "qwen3-0.6b:train":
            row["autograd_err"] = flash_bwd_autograd(
                torch, fops, q, k, v, g, causal, off, chunk, plain_out,
                plain_lse, bf16)
        if bf16:
            # the fp32-core kernels on the same inputs: checked, and timed
            # as the yardstick of the tensor-core route
            old = fops._launch_bwd_fp32cores(q, k, v, out, lse, g, causal, off)
            torch.cuda.synchronize()
            row["fp32_cores_err"] = {
                what: flash_bwd_error(torch, a, c, True)
                for what, a, c in zip(("dq", "dk", "dv"), old, want)}
            for what, err in row["fp32_cores_err"].items():
                check(err["within_tolerance"], f"flash_bwd {name}, fp32-core "
                      f"route: {what} error {err}")
            del old
            row["ms_fp32_cores"] = event_ms(
                torch, lambda: fops._launch_bwd_fp32cores(
                    q, k, v, out, lse, g, causal, off),
                3 if S >= 4096 else 10, warmup=1)
        row["tflops"] = flops / row["ms"] / 1e9
        row["bound_share"] = b_ms / row["ms"]
        emit(row)
        rows[name] = row
        del lib
    torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------- SSD scan kernel
def ssd_cases():
    """(name, B, S, H, hd, N, chunk, dtype, init_state, decay): every
    Mamba2 prefill of the serve runs (zamba2: d_model 2048, expand 2,
    d_state 64; mamba2-780m: d_model 1536, d_state 128; chunk 256), then
    zamba2's heads at B = 2, at S = 100 < chunk, from a given initial
    state over 2 and 16 chunks (S = 512, 4096), zamba2's inner width cut
    into heads of 32 and of 128 (the kernel's other head dims), and one
    case of fast decay.  ``decay`` "slow" draws dt and A as Mamba2
    initialises them: per head a dt log-uniform in [1e-3, 0.1] (its
    dt_bias) and A = -uniform [1, 16], dt times exp(0.5 normal) per step
    for the input's part; a head with dt near 1e-3 and A near 1 keeps
    most of its state over a chunk of 256 steps, so the state passed from
    chunk to chunk shows in y.  "fast" draws dt = softplus(normal) and
    A = -exp(0.3 normal), ~0.8 a step, so |cum| passes 88 inside a chunk
    (where exp(cum_i) exp(-cum_j) would overflow) and nothing carries."""
    from repro_torch.models.mamba2 import _dims
    cases = [(cfg.name, 1, S, _dims(cfg)[1], cfg.ssm.head_dim,
              cfg.ssm.d_state, cfg.ssm.chunk, cfg.dtype, False, "slow")
             for cfg, S in served_prefills() if cfg.ssm is not None]
    _, _, _, H, hd, N, Q, dtype, _, _ = cases[0]
    return cases + [
        ("zamba2-1.2b:B=2", 2, 1024, H, hd, N, Q, dtype, False, "slow"),
        ("zamba2-1.2b:S=100", 1, 100, H, hd, N, Q, dtype, False, "slow"),
        ("zamba2-1.2b:init_state", 1, 512, H, hd, N, Q, dtype, True, "slow"),
        ("zamba2-1.2b:init_state:16_chunks", 1, 4096, H, hd, N, Q, dtype,
         True, "slow"),
        ("zamba2-1.2b:hd=32", 1, 1024, H * hd // 32, 32, N, Q, dtype, False,
         "slow"),
        ("zamba2-1.2b:hd=128", 1, 1024, H * hd // 128, 128, N, Q, dtype,
         True, "slow"),
        ("zamba2-1.2b:fast_decay", 1, 1024, H, hd, N, Q, dtype, True,
         "fast")]


def ssd_inputs(torch, gen, B, S, H, hd, N, dtype, init, decay):
    """x, dt, A_log, B, C and the initial state (or None) of an ssd case,
    on the card: x, B and C in the activation dtype; dt and A_log drawn
    as ``ssd_cases`` says for ``decay``."""
    act = getattr(torch, dtype)
    x = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(act)
    if decay == "slow":
        dt_h = torch.empty((H,), device="cuda").uniform_(
            math.log(1e-3), math.log(0.1), generator=gen).exp()
        dt = dt_h * torch.exp(0.5 * torch.randn(
            (B, S, H), generator=gen, device="cuda"))
        A_log = torch.empty((H,), device="cuda").uniform_(
            1.0, 16.0, generator=gen).log()
    else:
        dt = torch.nn.functional.softplus(
            torch.randn((B, S, H), generator=gen, device="cuda"))
        A_log = torch.randn((H,), generator=gen, device="cuda") * 0.3
    Bm = torch.randn((B, S, N), generator=gen, device="cuda").to(act)
    Cm = torch.randn((B, S, N), generator=gen, device="cuda").to(act)
    st0 = (torch.randn((B, H, N, hd), generator=gen, device="cuda")
           if init else None)
    return x, dt, A_log, Bm, Cm, st0


def ssd_ops_split(B, S, H, hd, N, Q):
    """f32 operations of the chunked form on these shapes, as (matrix
    products, the rest): per chunk the lower triangle of C B^T (shared by
    the heads); per chunk and head the masked product of the decayed
    C B^T with xd on that triangle, the carried state's part C . state and
    the state update B^T (w xd), all products; then the decay (subtract,
    exp, multiply), the exp(cum) scale, the state's decay and w xd with
    w = exp(total - cum)."""
    nc, tri = S // Q, Q * (Q + 1) // 2
    products = B * nc * (tri * 2 * N + H * (tri * 2 * hd + 4 * Q * N * hd))
    rest = B * nc * H * (tri * 3 + Q * hd + N * hd + 2 * Q * hd)
    return products, rest


def phase_ssd(torch, sops, gen):
    """The SSD kernels against ``ssd_scan_plain`` on the operands the
    wrapper forms (x and B, C in the activation dtype, as the models pass
    them): y and the final state within 1e-4 of their largest element.
    Each row: ``ms`` (CUDA events around back-to-back calls; below ~0.2 ms
    of device work it reads the host's time per call), ``device_ms`` (the
    profiler's, every kernel of a call summed), ``bound_ms`` (f32 cores),
    ``bound_ms_tc`` (the products in 3xTF32 on the tensor cores, three
    TF32 passes, the rest on the f32 cores, or the bytes if more) and
    ``bound_share`` = bound_ms_tc / device_ms."""
    rows = {}
    for name, B, S, H, hd, N, chunk, dtype, init, decay in ssd_cases():
        x, dt, A_log, Bm, Cm, st0 = ssd_inputs(torch, gen, B, S, H, hd, N,
                                               dtype, init, decay)
        y, fs = sops.ssd_scan(x, dt, A_log, Bm, Cm, chunk=chunk,
                              init_state=st0)
        xd, la = sops._operands(x, dt, A_log)
        Bf, Cf = Bm.float(), Cm.float()
        py, pfs = sops.ssd_scan_plain(xd, la, Bf, Cf, chunk, st0)
        torch.cuda.synchronize()
        errs, scales = {}, {}
        for what, a, b in (("y", y, py), ("state", fs, pfs)):
            scale = scales[what] = b.abs().max().item()
            errs[what] = (a - b).abs().max().item()
            check(bool(torch.isfinite(a).all()), f"ssd {name}: {what} "
                  f"not finite")
            check(errs[what] <= 1e-4 * scale, f"ssd {name} S={S}: {what} "
                  f"error {errs[what]} > 1e-4 x {scale}")
        Q = min(chunk, S)
        # the most of its incoming state a chunk keeps: exp(total)
        carry = la.view(B, S // Q, Q, H).sum(2).exp().max().item()
        nbytes = sum(t.numel() * 4 for t in (xd, la, Bf, Cf, y, fs)
                     + (() if st0 is None else (st0,)))
        products, rest = ssd_ops_split(B, S, H, hd, N, Q)
        nops = products + rest
        b_ms, b_by = bound(nbytes, nops)
        tc_ms = max(nbytes / PEAK_BYTES,
                    3 * products / PEAK_TF32 + rest / PEAK_F32) * 1e3

        def call():
            sops._launch(xd, la, Bf, Cf, chunk, st0)
        row = {"phase": "ssd", "case": name, "B": B, "S": S, "H": H,
               "hd": hd, "N": N, "Q": Q, "init_state": init,
               "decay": decay, "carry": carry, "max_abs_err": errs, "scale": scales,
               "ms": event_ms(torch, call, 20), **profiled(torch, call),
               "plain_ms": event_ms(torch, lambda: sops.ssd_scan_plain(
                   xd, la, Bf, Cf, chunk, st0), 3, warmup=1),
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
               "bound_ms_tc": tc_ms, "flops": nops,
               "flops_products": products, "bytes": nbytes}
        row["tflops"] = nops / row["ms"] / 1e9
        row["bound_share"] = (tc_ms / row["device_ms"]
                              if not isinstance(row["device_ms"], str)
                              else "not measured")
        emit(row)
        rows[name, S] = row
    return rows


# the train phase's SSD shapes (B 4, S 4096, chunk 256): (name, B, S, H,
# hd, N, chunk, dtype, init_state, decay); zamba2 with Mamba2's slow decay
# (the state carried over 16 chunks), mamba2-780m with fast decay (dt ~
# 0.7 and A ~ -e at random weights, |cum| far past 88 in a chunk)
SSD_TRAIN_CASES = (
    ("zamba2-1.2b:train", 4, 4096, 64, 64, 64, 256, "float32", False,
     "slow"),
    ("mamba2-780m:train", 4, 4096, 48, 64, 128, 256, "float32", False,
     "fast"))
SSD_BWD_KERNELS = ("ssd_bwd_state_kernel", "ssd_bwd_pass_kernel",
                   "ssd_bwd_w_kernel", "ssd_bwd_dxd_kernel",
                   "ssd_bwd_ds_kernel", "ssd_bwd_dla_kernel")


def ssd_bwd_ops_split(B, S, H, hd, N, Q):
    """f32 operations of the chunked form's backward, as (matrix
    products, the rest), with C B^T kept from the forward and the
    triangle's dS = sum over heads of (dy xd^T) o L formed once a chunk:
    per chunk and head, on the lower triangle, dy xd^T and (C B^T o L)^T
    dy; per chunk and head, B G, C^T diag(exp(cum)) dy, dy prev^T and xd
    G^T (Q x N x hd each); per chunk dS B and dS^T C on the triangle.
    The rest: per (chunk, head) the decays (subtract, exp), W and W o C
    B^T, their row and column sums, the sum over heads (6 a triangle
    entry), the dy . (C prev) and xd . (B G) terms (2 Q hd each), the
    pass (2 N hd) and <prev, G> (2 N hd)."""
    nc, tri = S // Q, Q * (Q + 1) // 2
    products = B * nc * (H * (tri * 4 * hd + 8 * Q * N * hd) + tri * 4 * N)
    rest = B * nc * H * (6 * tri + 4 * Q * hd + 4 * N * hd)
    return products, rest


def ssd_bwd_error(torch, got, want, tol=1e-4):
    """{output: max abs error} and {output: largest element} of kernel
    F's outputs against the plain version's; each within ``tol`` of its
    largest element."""
    errs, scales = {}, {}
    for what, a, b in zip(("dxd", "dla", "dB", "dC", "dinit"), got, want):
        if b is None:
            check(a is None, f"ssd_bwd: {what} returned without a state")
            continue
        scales[what] = b.abs().max().item()
        errs[what] = (a - b).abs().max().item()
        check(bool(torch.isfinite(a).all()), f"ssd_bwd {what} not finite")
        check(errs[what] <= tol * scales[what], f"ssd_bwd {what}: error "
              f"{errs[what]} > {tol} x {scales[what]}")
    return errs, scales


def ssd_bwd_autograd(torch, sops, rdev, gen):
    """``torch.autograd.grad`` through ``ssd_scan`` on CUDA x, dt, A_log,
    B, C and an initial state that require grad (zamba2's heads, S 1024,
    4 chunks, slow decay), against the same through the plain version:
    exactly one forward and one backward launch, and every gradient
    within 1e-4 of its largest element."""
    x, dt, A_log, Bm, Cm, st0 = ssd_inputs(torch, gen, 1, 1024, 64, 64, 64,
                                           "float32", True, "slow")
    dy = torch.randn_like(x)
    dfinal = torch.randn_like(st0)

    def grads(fn):
        ins = [t.clone().requires_grad_() for t in (x, dt, A_log, Bm, Cm,
                                                    st0)]
        y, fs = fn(*ins)
        return torch.autograd.grad((y * dy).sum() + (fs * dfinal).sum(),
                                   ins)

    rdev.reset_launch_counts()
    got = grads(lambda *a: sops.ssd_scan(*a[:5], chunk=256, init_state=a[5]))
    torch.cuda.synchronize()
    counts = rdev.launch_counts()
    want_counts = {k: 0 for k in counts}
    want_counts.update(ssd_scan=1, ssd_scan_bwd=1)
    check(counts == want_counts, f"ssd_bwd autograd launches {counts}")

    def plain(x, dt, A_log, Bm, Cm, st):
        xd, la = sops._operands(x, dt, A_log)
        return sops.ssd_scan_plain(xd, la, Bm, Cm, 256, st)
    want = grads(plain)
    errs = {}
    for what, a, b in zip(("x", "dt", "A_log", "B", "C", "init_state"), got,
                          want):
        scale = b.abs().max().item()
        errs[what] = (a - b).abs().max().item()
        check(bool(torch.isfinite(a).all()) and errs[what] <= 1e-4 * scale,
              f"ssd_bwd autograd {what}: error {errs[what]} of {scale}")
    return {"launches": {k: v for k, v in counts.items() if v},
            "max_abs_err": errs}


def phase_ssd_bwd(torch, sops, rdev, gen):
    """Kernel F (``csrc/ssd_scan_bwd.cu``) against ``ssd_scan_bwd_plain``
    on every ssd case and at the train phase's two shapes, with a random
    dy and a random final-state cotangent, then none (zero): dxd, dla,
    dB, dC and dinit each within 1e-4 of its largest element (the
    forward's gate, stated before the first run), and a second launch
    bit-equal.  Each row (the first cotangent): ``ms`` (CUDA events),
    ``device_ms`` (the profiler's, the six CUDA kernels summed, and
    ``device_ms_by_kernel``, so that the kernel that sets the pace
    shows),
    ``bound_ms`` (products in 3xTF32 on the tensor cores, the rest on the
    f32 cores, or the bytes of the function's inputs and outputs),
    ``bound_share`` = bound_ms / device_ms, ``plain_ms``; no single
    PyTorch call computes this function (``library_ms`` null).  Then the
    autograd route (``ssd_bwd_autograd``)."""
    rows = {}
    for name, B, S, H, hd, N, chunk, dtype, init, decay in (
            ssd_cases() + list(SSD_TRAIN_CASES)):
        x, dt, A_log, Bm, Cm, st0 = ssd_inputs(torch, gen, B, S, H, hd, N,
                                               dtype, init, decay)
        xd, la = sops._operands(x, dt, A_log)
        Bf, Cf = Bm.float().contiguous(), Cm.float().contiguous()
        xd, la = xd.contiguous(), la.contiguous()
        _, _, saved = sops._launch(xd, la, Bf, Cf, chunk, st0, keep=True)
        dy = torch.randn(xd.shape, generator=gen, device="cuda")
        row = {"phase": "ssd_bwd", "case": name, "B": B, "S": S, "H": H,
               "hd": hd, "N": N, "Q": min(chunk, S), "init_state": init,
               "decay": decay}
        for tag, dfinal in (("", torch.randn((B, H, N, hd), generator=gen,
                                             device="cuda")),
                            ("_no_dfinal", None)):
            def call():
                return sops.ssd_scan_bwd(xd, la, Bf, Cf, st0, dy, dfinal,
                                         chunk=chunk, saved=saved)
            got, again = call(), call()
            want = sops.ssd_scan_bwd_plain(xd, la, Bf, Cf, st0, dy, dfinal,
                                           chunk=chunk)
            torch.cuda.synchronize()
            errs, scales = ssd_bwd_error(torch, got, want)
            check(all(a is None and b is None or torch.equal(a, b)
                      for a, b in zip(got, again)),
                  f"ssd_bwd {name}{tag}: two launches differ")
            row[f"max_abs_err{tag}"] = errs
            row[f"scale{tag}"] = scales
            del got, again, want
            if tag:
                continue
            Q = min(chunk, S)
            # read: xd, la, B, C, dy, dfinal (and the initial state);
            # written: a gradient of each operand's shape
            ops_in = [xd, la, Bf, Cf] + ([] if st0 is None else [st0])
            nbytes = 4 * sum(t.numel() for t in ops_in + ops_in
                             + [dy, dfinal])
            products, rest = ssd_bwd_ops_split(B, S, H, hd, N, Q)
            t_ops = 3 * products / PEAK_TF32 + rest / PEAK_F32
            t_bytes = nbytes / PEAK_BYTES
            row.update({
                "bit_equal": True, "ms": event_ms(torch, call, 10),
                **profiled(torch, call, reps=10),
                "plain_ms": event_ms(torch, lambda: sops.ssd_scan_bwd_plain(
                    xd, la, Bf, Cf, st0, dy, dfinal, chunk=chunk), 2,
                    warmup=1),
                "library_ms": None, "bound_ms": max(t_ops, t_bytes) * 1e3,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "flops": products + rest, "flops_products": products,
                "bytes": nbytes})
            row["bound_share"] = (row["bound_ms"] / row["device_ms"]
                                  if not isinstance(row["device_ms"], str)
                                  else "not measured")
        emit(row)
        rows[name] = row
        del saved, x, xd, la, dy
        torch.cuda.empty_cache()
    auto = ssd_bwd_autograd(torch, sops, rdev, gen)
    emit({"phase": "ssd_bwd_autograd", **auto})
    return rows


# ------------------------------------------------------------- LM serving
# serve_check's models: (arch, depth cut) at full width in f32.  zamba2
# keeps one group of 6 and a tail layer; seamless 2 encoder and 2
# decoder layers
SERVE_CHECKS = (("zamba2-1.2b", {"n_layers": 7}),
                ("qwen3-moe-30b-a3b", {"n_layers": 2}),
                (ENCDEC_ARCH, {"enc_layers": 2, "dec_layers": 2,
                               "n_layers": 4}))
SERVE_CHECK_LEN = 512
ENCDEC_CHECK_STEPS = 8


def routes_to(model, routes, device):
    """Hand recorded MoE routes to ``model`` (its ``routes`` seam)."""
    model.routes = {d: r.to(device) for d, r in routes.items()}


def differing_sets(a, b):
    """Tokens whose top-k expert sets differ, per depth: a, b {depth:
    (B, S, k)}."""
    return {d: int((a[d].cpu().sort(-1).values
                    != b[d].cpu().sort(-1).values).any(-1).sum())
            for d in a}


def phase_serve_check(torch, rdev):
    """Each of ``SERVE_CHECKS`` at full width in f32, cut in depth: the
    same parameters prefill a 512-token prompt (seamless: 512 random
    frames, then BOS) and decode on the card (kernels) and on the CPU
    (plain versions): one decode step (zamba2, qwen3-moe), or 8 greedy
    steps each fed the CPU's token (seamless).  Last-token logits after
    the prefill and after each decode step, and every cache entry,
    agree within 1e-3 of their largest element.  qwen3-moe's CPU runs
    take the card's routes through ``moe_block``'s routes seam: a
    near-tie in the router's top-k would otherwise send a token to
    other experts; a first CPU prefill on its own routes prints how many
    tokens' top-k sets it picked differently (``top_k_sets_differing``,
    per layer).  Exact launches: one attention launch a prefill layer
    (zamba2: a shared block; seamless: an encoder layer), all on the
    fp32 cores (f32), zamba2 also 7 SSD launches; none in decode."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.zoo import get_model
    from repro_torch.utils.params import tree_map
    for arch, cut in SERVE_CHECKS:
        cfg = get_config(arch).replace(dtype="float32", **cut)
        encdec, moe = cfg.family == "encdec", cfg.moe is not None
        gpu = get_model(cfg)
        gpu.init(torch.Generator("cuda").manual_seed(1))
        cpu = get_model(cfg)
        cpu.load(tree_map(lambda t: t.detach().cpu(), gpu.params))
        S = SERVE_CHECK_LEN
        g = torch.Generator().manual_seed(2)
        if encdec:
            inputs, max_len = torch.randn((1, S, cfg.d_model),
                                          generator=g), 16
        else:
            inputs, max_len = torch.randint(0, cfg.vocab_size, (1, S),
                                            generator=g), S + 8

        def compare(what, a, b):
            scale = b.abs().max().item()
            err = (a.cpu().float() - b.float()).abs().max().item()
            check(err <= 1e-3 * max(scale, 1e-30),
                  f"serve_check {arch} {what}: error {err} > 1e-3 x {scale}")
            return err

        errs, row = {}, {}
        with torch.no_grad():
            gpu.seen_routes = {} if moe else None
            rdev.reset_launch_counts()
            g_cache, g_logits = gpu.prefill(gpu.params, inputs.cuda(),
                                            max_len)
            torch.cuda.synchronize()
            counts = rdev.launch_counts()
            if moe:
                g_routes, gpu.seen_routes = gpu.seen_routes, None
                cpu.seen_routes = {}
                cpu.prefill(cpu.params, inputs, max_len)
                row["top_k_sets_differing"] = differing_sets(
                    g_routes, cpu.seen_routes)
                row["tokens_per_layer"] = S
                cpu.seen_routes = None
                routes_to(cpu, g_routes, "cpu")
            t0 = time.perf_counter()
            c_cache, c_logits = cpu.prefill(cpu.params, inputs, max_len)
            cpu_s = time.perf_counter() - t0
            errs["logits"] = compare("logits", g_logits, c_logits)
            for name in c_cache:
                errs[name] = compare(f"cache {name}", g_cache[name],
                                     c_cache[name])
            tok = torch.argmax(c_logits[:, :cfg.vocab_size], dim=-1)
            row["top_token_agrees"] = int(torch.argmax(
                g_logits[0, :cfg.vocab_size])) == int(tok[0])
            pos = 1 if encdec else S
            before = rdev.launch_counts()
            for step in range(ENCDEC_CHECK_STEPS if encdec else 1):
                gpu.seen_routes = {} if moe else None
                g2, _ = gpu.decode_step(gpu.params, g_cache, tok.cuda(), pos)
                if moe:
                    routes_to(cpu, gpu.seen_routes, "cpu")
                c2, _ = cpu.decode_step(cpu.params, c_cache, tok, pos)
                errs[f"decode_logits_{step}" if encdec else
                     "decode_logits"] = compare(f"decode logits {step}", g2,
                                                c2)
                tok = torch.argmax(c2[:, :cfg.vocab_size], dim=-1)
                pos += 1
            if encdec:
                for name in ("k", "v"):
                    errs[f"decoded_{name}"] = compare(
                        f"decoded cache {name}", g_cache[name], c_cache[name])
            torch.cuda.synchronize()
            check(rdev.launch_counts() == before,
                  f"serve_check {arch}: a decode step launched a kernel")
        # an f32 prefill's attention launches take the fp32-core route
        blocks = {"hybrid": 1, "encdec": cfg.enc_layers}.get(
            cfg.family, cfg.n_layers)
        want = {**{k: 0 for k in counts}, "flash_attention": blocks}
        if cfg.family == "hybrid":
            want["ssd_scan"] = cfg.n_layers
        check(counts == want, f"serve_check {arch} launches {counts}, "
              f"want {want}")
        emit({"phase": "serve_check", "arch": cfg.name,
              "layers": cfg.n_layers, "d_model": cfg.d_model,
              "dtype": cfg.dtype, "prompt": S, "launches": counts,
              "max_abs_err": errs, "cpu_prefill_s": cpu_s, **row})
        del gpu, cpu, g_cache, c_cache
        torch.cuda.empty_cache()


# ------------------------------------------------------------ LM training
def train_flops(cfg, B, S, Se=0):
    """Model FLOPs of one training step, without recompute: 6 per
    parameter of every matrix product per token (the unembedding at the
    padded vocab; per attention block, dense layers or zamba2's shared
    block at each of its G uses, the projections and the MLP; per MoE
    layer the router and the top_k experts' three products a token, the
    active parameters, not the capacity's slots, and a shared expert;
    per mamba layer the z, x, B, C and dt projections and out_proj; for
    encdec the encoder's layers on Se frames, the decoder's on S tokens,
    and each decoder layer's cross keys and values on the Se frames),
    the two attention products, 2 h FLOPs per unmasked (query head,
    key) pair each (encdec: Se x Se in the encoder, causal S in the
    decoder, S x Se across), times 3 for forward and backward, and per
    mamba layer the SSD chunked form's matrix products
    (``ssd_ops_split``) times 3.  The depthwise convolutions and the
    elementwise work are not counted."""
    D, L = cfg.d_model, cfg.n_layers
    H, K, h, F = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    proj = D * H * h * 2 + 2 * D * K * h
    matmul = D * cfg.vocab_padded
    flops = 0
    if cfg.family == "encdec":
        enc = cfg.enc_layers * (proj + 3 * D * F) * B * Se
        dec = cfg.dec_layers * (proj + D * H * h * 2 + 3 * D * F) * B * S
        cross_kv = cfg.dec_layers * 2 * D * K * h * B * Se
        pairs = (cfg.enc_layers * Se * Se + cfg.dec_layers * (
            attention_pairs(S, S, True, 0) + S * Se))
        return 6 * (matmul * B * S + enc + dec + cross_kv) \
            + 12 * B * H * h * pairs
    if cfg.moe is not None:
        m = cfg.moe
        n_moe = L // m.every
        matmul += L * proj + (L - n_moe) * 3 * D * F + n_moe * (
            D * m.n_experts + m.top_k * 3 * D * m.d_ff_expert
            + 3 * D * m.shared_expert_ff)
        flops += 12 * B * H * h * attention_pairs(S, S, True, 0) * L
        return 6 * matmul * B * S + flops
    if cfg.ssm is None:
        blocks = L
    else:
        blocks = L // cfg.shared_attn_every if cfg.shared_attn_every else 0
        s = cfg.ssm
        d_in = D * s.expand
        Hs = d_in // s.head_dim
        matmul += L * (3 * D * d_in + 2 * D * s.d_state + D * Hs)
        flops += 3 * L * ssd_ops_split(B, S, Hs, s.head_dim, s.d_state,
                                       min(s.chunk, S))[0]
    if blocks:
        matmul += blocks * (proj + 3 * D * F)
        flops += 12 * B * H * h * attention_pairs(S, S, True, 0) * blocks
    return 6 * matmul * B * S + flops


def step_launches(cfg, tensor_cores):
    """Kernel launches of one training step under remat "full": each
    attention block's forward twice (the forward and its recompute) and
    its backward once; each mamba layer's scan twice inside a checkpoint
    (every mamba2 layer; zamba2's grouped layers), once outside (zamba2's
    tail), and its backward once; all of it once per microbatch.  An
    encdec model's attention blocks: each encoder layer's, and each
    decoder layer's self- and cross-attention.  Where the transformer's
    units (a layer, or ``moe.every`` of them) fill groups of
    ``scan_block``, the two-level remat also recomputes each group under
    its outer checkpoint in the backward, which stops (PyTorch's early
    stop) as soon as it has the group's last unit's input: every block
    but those of each group's last unit a third time.  ``tensor_cores``:
    bf16 at h 64 / 128, where every attention launch takes the
    tensor-core route."""
    L = cfg.n_layers
    out = {}
    recomputed = 0      # attention blocks run a third time
    if cfg.family == "encdec":
        blocks = cfg.enc_layers + 2 * cfg.dec_layers
    elif cfg.ssm is None:
        blocks = L
        per = cfg.moe.every if cfg.moe else 1
        units, blk = L // per, cfg.scan_block
        if cfg.scan_layers and blk and units % blk == 0:
            recomputed = L - units // blk * per
    else:
        k = cfg.shared_attn_every
        blocks = L // k if k else 0
        grouped = blocks * k if k else L
        out.update(ssd_scan=2 * grouped + (L - grouped), ssd_scan_bwd=L)
    if blocks:
        fwd = 2 * blocks + recomputed
        tc = 1 if tensor_cores else 0
        out.update(flash_attention=fwd, flash_attention_tc=fwd * tc,
                   flash_attention_bwd=blocks,
                   flash_attention_bwd_tc=blocks * tc)
    return {k: v * cfg.grad_accum_microbatches for k, v in out.items()}


def step_collectives(model):
    """The FSDP collectives of one training step of ``model`` under its
    plan, as ``parallel.fsdp_counts`` counts them: every leaf that a data
    axis of more than one process cuts is all-gathered over each such
    axis where it is used, a unit's slice of a stacked leaf (never the
    stack) where the unit runs, once in the forward and again in each
    recompute (remat "full" or "dots": once more; the transformer's
    two-level remat twice more, but for each group's last unit, as
    ``step_launches`` counts the attention; zamba2's tail runs outside
    any checkpoint: once), the leaves outside the stacks once a forward;
    each gather's gradient is reduce-scattered once in the backward
    along a batch axis (along a data axis that is not one it is sliced,
    no collective); all of it once per microbatch.  Returns
    {all_gather, reduce_scatter, all_gather_max_numel}: the counts a
    step, and the most elements one all-gather gave."""
    import math
    from repro_torch.distributed import parallel as par
    from repro_torch.utils.params import tree_leaves
    cfg, plan = model.cfg, model.plan
    out = {"all_gather": 0, "reduce_scatter": 0, "all_gather_max_numel": 0}
    if plan is None:
        return out
    data = par.live_axes(plan.mesh, plan.data_axes)
    batch = par.live_axes(plan.mesh, plan.batch_axes)
    r = 0 if cfg.remat == "none" else 1
    specs = model.param_specs()
    for key, sub in model.param_defs().items():
        leaves = tree_leaves(sub)
        k = sum(a == "layer" for a in leaves[0][1].axes) \
            if key in model.stack_keys else 0
        n = math.prod(leaves[0][1].shape[:k])
        uses = [1] * n if k == 0 or key == "tail" else [1 + r] * n
        blk = cfg.scan_block
        if (key == "layers" and cfg.ssm is None and r and cfg.scan_layers
                and blk and n % blk == 0):
            uses = [3 - (u % blk == blk - 1) for u in range(n)]
        sp = dict(tree_leaves(specs[key]))
        for name, d in leaves:
            live = [a for e in tuple(sp[name])[k:]
                    for a in par.live_axes(plan.mesh, e)]
            cuts = [a for a in live if a in data]
            if not cuts:
                continue
            out["all_gather"] += len(cuts) * sum(uses)
            out["reduce_scatter"] += sum(a in batch for a in cuts) * n
            # gathered over the data axes, still cut over "model"
            numel = math.prod(d.shape[k:]) // math.prod(
                plan.mesh.shape[a] for a in live if a not in data)
            out["all_gather_max_numel"] = max(out["all_gather_max_numel"],
                                              numel)
    m = cfg.grad_accum_microbatches
    return {k: v if k.endswith("numel") else v * m for k, v in out.items()}


# train_check's models: (arch, depth cut) at full width in f32; zamba2
# keeps one group of 6 and a tail layer, as serve_check cuts it
TRAIN_CHECKS = ((TRAIN_ARCH, {"n_layers": 2}),
                ("mamba2-780m", {"n_layers": 2}),
                ("zamba2-1.2b", {"n_layers": 7}),
                ("qwen3-moe-30b-a3b", {"n_layers": 2}),
                (ENCDEC_ARCH, {"enc_layers": 2, "dec_layers": 2,
                               "n_layers": 4}))
TRAIN_SSM = ("mamba2-780m", "zamba2-1.2b")
# their train phases cut in depth to about half (mamba2 24 of 48 layers,
# zamba2 20 of 38: three shared-attention groups and the tail), widths
# as published: the restarts' whole checkpoints (12-19 GB) took most of
# their ~290 s, and the script must fit its time limit beside the GAT
# tuner's phases
TRAIN_SSM_LAYERS = {"mamba2-780m": 24, "zamba2-1.2b": 20}


def phase_train_check(torch, rdev):
    """Each of ``TRAIN_CHECKS`` at full width in f32, cut in depth: the
    loss of one batch (B 1, S 512: 2 chunks of 256, so the state carried
    between them counts; seamless also 512 random frames) and every
    parameter's gradient on the card (kernels: exactly
    ``step_launches``, the attention on the fp32 cores) against the
    same on the CPU (plain versions), the same parameters; qwen3-moe's
    CPU run takes the card's routes (``moe_block``'s routes seam), so a
    near-tie in the router's top-k cannot send a token elsewhere.
    Tolerance, stated before the first run: the loss within 1e-5 of its
    value, each gradient within 1e-3 of its largest element (f32 both,
    sums in another order; a lost attention or SSD gradient, a wrong
    mask or a dropped carry moves them by O(1))."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLM, device_batch
    from repro_torch.models.zoo import get_model
    from repro_torch.utils.params import tree_leaves, tree_map
    for arch, cut in TRAIN_CHECKS:
        cfg = get_config(arch).replace(dtype="float32",
                                       grad_accum_microbatches=1, **cut)
        moe = cfg.moe is not None
        gpu = get_model(cfg)
        gpu.init(torch.Generator("cuda").manual_seed(1))
        cpu = get_model(cfg)
        cpu.load(tree_map(lambda t: t.detach().cpu(), gpu.params))
        hb = dict(SyntheticLM(cfg.vocab_size, 512, 1, seed=2).batch_at(0))
        if cfg.family == "encdec":
            hb["enc_emb"] = torch.randn(
                (1, 512, cfg.d_model),
                generator=torch.Generator().manual_seed(2)).numpy()

        def loss_and_grads(model, device):
            leaves = tree_leaves(model.params)
            for _, p in leaves:
                p.requires_grad_(True)
            loss, _ = model.loss(model.params, device_batch(hb, device))
            return loss, torch.autograd.grad(loss, [p for _, p in leaves])

        gpu.seen_routes = {} if moe else None
        rdev.reset_launch_counts()
        g_loss, g_grads = loss_and_grads(gpu, "cuda")
        torch.cuda.synchronize()
        counts = rdev.launch_counts()
        if moe:
            routes_to(cpu, gpu.seen_routes, "cpu")
        t0 = time.perf_counter()
        c_loss, c_grads = loss_and_grads(cpu, "cpu")
        cpu_s = time.perf_counter() - t0
        want = {**{k: 0 for k in counts}, **step_launches(cfg, False)}
        check(counts == want, f"train_check {arch} launches {counts}, "
              f"want {want}")
        loss_err = abs(g_loss.item() - c_loss.item())
        check(loss_err <= 1e-5 * abs(c_loss.item()),
              f"train_check {arch} loss {g_loss.item()} against "
              f"{c_loss.item()}")
        errs = {}
        for (name, _), a, b in zip(tree_leaves(cpu.params), g_grads,
                                   c_grads):
            scale = b.abs().max().item()
            errs[name] = (a.cpu() - b).abs().max().item() / max(scale,
                                                                1e-30)
            check(bool(torch.isfinite(a).all()), f"train_check {arch} "
                  f"{name}: not finite")
            check(errs[name] <= 1e-3, f"train_check {arch} {name}: error "
                  f"{errs[name]} of the largest element")
        emit({"phase": "train_check", "arch": cfg.name,
              "layers": cfg.n_layers, "d_model": cfg.d_model,
              "dtype": cfg.dtype, "remat": cfg.remat, "batch": 1,
              "seq": 512, "launches": counts,
              "loss": g_loss.item(), "loss_cpu": c_loss.item(),
              "loss_abs_err": loss_err,
              "worst_grad_rel_err": max(errs.values()),
              "worst_grad": max(errs, key=errs.get), "grad_rel_err": errs,
              "cpu_s": cpu_s})
        del gpu, cpu, g_grads, c_grads
        torch.cuda.empty_cache()


def kernel_tag(tag, name):
    """Whether profiler kernel ``name`` is the CUDA kernel ``tag`` (by its
    name up to its template or argument list: "flash_bwd_dq<" is not
    "flash_bwd_dq_wgmma<")."""
    return tag + "<" in name or tag + "(" in name


# kernels of the train phase's step whose device time train_profile sums
TRAIN_KERNELS = (("flash_fwd_wgmma",) + BWD_FP32_KERNELS + BWD_TC_KERNELS
                 + ("ssd_state_kernel", "ssd_pass_kernel", "ssd_out_kernel")
                 + SSD_BWD_KERNELS)


def profile_steps(torch, cfg, step_fn, pa, sa, batches, n, per_step):
    """train_profile: ``len(batches)`` more steps of a run's state (pa,
    sa after ``n`` steps) under the profiler.  Returns (the row to emit,
    pa, sa, device ms a call of the attention backward and of the SSD
    backward, or "not measured")."""
    from torch.autograd import DeviceType
    torch.cuda.synchronize()
    with padded_profile() as prof:
        t0 = time.perf_counter()
        for i, hb in enumerate(batches):
            pa, sa, met = step_fn(pa, sa, hb, n + i)
        final_loss = float(met["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if us > 0:
            name = evt.key[:80]
            ms, calls = kernels.get(name, (0.0, 0))
            kernels[name] = (ms + us / 1e3, calls + evt.count)
    busy = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    mine = {tag: sum(ms for k, (ms, _) in kernels.items() if kernel_tag(tag, k))
            for tag in TRAIN_KERNELS}
    mine = {k: v for k, v in mine.items() if v}
    calls = {tag: sum(c for k, (_, c) in kernels.items() if kernel_tag(tag, k))
             for tag in TRAIN_KERNELS}
    steps = len(batches)

    def per_call(tags, n_calls):
        """Device ms a call of a wrapper whose CUDA kernels are ``tags``,
        if the window recorded each of them once for each of its
        ``n_calls`` calls."""
        if not n_calls or any(calls[t] != n_calls for t in tags):
            return "not measured"
        return sum(mine.get(t, 0.0) for t in tags) / n_calls
    bwd_ms = per_call(BWD_TC_KERNELS,
                      steps * per_step.get("flash_attention_bwd_tc", 0))
    ssd_bwd_ms = per_call(SSD_BWD_KERNELS,
                          steps * per_step.get("ssd_scan_bwd", 0))
    gemm = sum(ms for k, (ms, _) in kernels.items()
               if "gemm" in k.lower() or "cutlass" in k.lower())
    row = {"phase": "train_profile", "arch": cfg.name,
           "window": f"{steps} train steps of run A's state (steps "
                     f"{n + 1}-{n + steps})",
           "wall_ms": wall_ms, "device_busy_ms": busy,
           "device_idle_share": (1.0 - busy / wall_ms) if kernels
           else "not measured", "final_loss": final_loss,
           "kernel_device_ms": mine, "kernel_calls": calls,
           "gemm_device_ms": gemm,
           "attention_bwd_device_ms_per_call": bwd_ms,
           "ssd_bwd_device_ms_per_call": ssd_bwd_ms,
           "top_kernels": [{"name": k, "device_ms": ms, "calls": c}
                           for k, (ms, c) in top[:15]]}
    return row, pa, sa, bwd_ms, ssd_bwd_ms


def phase_train(torch, np, rdev, arch=TRAIN_ARCH, n=TRAIN_STEPS,
                layers=None):
    """``TrainLoop`` at ``arch``'s published config (bf16 activations,
    f32 parameters, remat "full", AdamW; ``layers``: cut to that many
    layers) on train_4k's sequence length, global batch 4, random weights
    from seed 0: qwen3-0.6b (28 layers, d_model 1024), mamba2-780m (48
    layers, d_model 1536; ``TRAIN_SSM_LAYERS``: 24) or zamba2-1.2b (38
    layers, d_model 2048; 20).  Run A: ``n`` steps straight.  Run B: n / 2
    steps and a checkpoint, then a new ``TrainLoop`` restored from it for
    n / 2 more.  Gates: every loss finite; exactly ``step_launches`` per
    step, every attention launch on the tensor cores; run B's losses,
    final parameters and optimizer state within 1e-6 of run A's
    (relative to each loss, to each leaf's largest element: the same
    deterministic kernels on the same inputs; a restore that lost the
    moments or the step would move them by ~lr, 1e-3 of them).  Prints
    the median step ms (host clock, steps 2-n of run A; a step ends in
    the host reading its loss), tokens/s, the model-FLOPs share of the
    bf16 peak, peak device memory; train_profile: device time by kernel
    and the idle share over 2 more steps."""
    import shutil
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import device_batch
    from repro_torch.launch.train import TrainLoop
    from repro_torch.utils.params import tree_leaves
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    B, S = TRAIN_BATCH, TRAIN_SEQ
    L = cfg.n_layers
    per_step = step_launches(cfg, True)
    none = {k: 0 for k in rdev.launch_counts()}
    quiet = lambda _: None      # noqa: E731

    def run(loop, steps, log=quiet, **kw):
        rdev.reset_launch_counts()
        t0 = time.perf_counter()
        out = loop.run(steps, log=log, **kw)
        torch.cuda.synchronize()
        return out, rdev.launch_counts(), time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    a = TrainLoop(cfg, global_batch=B, seq=S, device="cuda")
    # the parameters' checksums after MESH_STEPS steps (train_mesh's
    # one-card reference); the optimizer updates a.model.params in place
    sums = {}

    def at_mesh_steps(line):
        if line.startswith(f"step {MESH_STEPS} "):
            sums.update(checksum(torch, a.model.params))
    (pa, sa, _), counts, a_s = run(a, n, log=at_mesh_steps)
    peak = torch.cuda.max_memory_allocated()
    want = {**none, **{k: n * v for k, v in per_step.items()}}
    check(counts == want, f"train {arch} launches {counts}, want {want}")
    losses = [h["loss"] for h in a.history]
    check(len(losses) == n and all(math.isfinite(x) for x in losses),
          f"train {arch} losses {losses}")

    ckpt_dir = os.path.join(ROOT, "build", "chip_smoke_train_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        b1 = TrainLoop(cfg, global_batch=B, seq=S, device="cuda",
                       ckpt_dir=ckpt_dir)
        _, counts_b1, b1_s = run(b1, n // 2, save_every=n // 2)
        b1_losses = [h["loss"] for h in b1.history]
        del b1
        torch.cuda.empty_cache()
        b2 = TrainLoop(cfg, global_batch=B, seq=S, device="cuda",
                       ckpt_dir=ckpt_dir)
        (pb, sb, _), counts_b2, b2_s = run(b2, n)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    half = {**none, **{k: n // 2 * v for k, v in per_step.items()}}
    check(counts_b1 == half and counts_b2 == half,
          f"train {arch} restart launches {counts_b1}, {counts_b2}")
    b_losses = [h["loss"] for h in b2.history]
    check([h["step"] for h in b2.history] == list(range(n // 2 + 1, n + 1)),
          f"train {arch} restart steps {[h['step'] for h in b2.history]}")
    loss_err = max(abs(x - y) / abs(y) for x, y in
                   zip(b1_losses + b_losses, losses))
    check(loss_err <= 1e-6, f"train {arch} restart losses {b1_losses} + "
          f"{b_losses} against {losses}")
    state_err, bit_equal = 0.0, True
    for tree_a, tree_b in ((pa, pb), (sa, sb)):
        for (name, x), (_, y) in zip(tree_leaves(tree_a), tree_leaves(tree_b)):
            bit_equal &= torch.equal(x, y)
            if x.is_floating_point():
                e = ((x - y).abs().max() / x.abs().max().clamp(min=1e-30)
                     ).item()
                state_err = max(state_err, e)
                check(e <= 1e-6, f"train {arch} restart {name}: error {e}")
    del pb, sb, b2

    # train_profile: 2 more steps of run A's state under the profiler
    batches = [device_batch(a.data.batch_at(n + i), "cuda") for i in range(2)]
    prof_row, pa, sa, bwd_ms, ssd_bwd_ms = profile_steps(
        torch, cfg, a.step_fn, pa, sa, batches, n, per_step)
    step_ms = [h["ms"] for h in a.history]
    med = float(np.median(step_ms[1:]))
    flops = train_flops(cfg, B, S)
    row = {"phase": "train", "arch": cfg.name, "layers": L,
           "d_model": cfg.d_model, "dtype": cfg.dtype,
           "param_dtype": cfg.param_dtype, "remat": cfg.remat,
           "optimizer": cfg.optimizer, "global_batch": B, "seq": S,
           "params": sum(p.numel() for _, p in tree_leaves(pa)),
           "steps": n, "losses": losses, "launches": counts,
           "launches_per_step": per_step, "step_ms": step_ms,
           "median_step_ms": med, "tokens_per_s": B * S / med * 1e3,
           "model_flops_per_step": flops,
           "mfu_bf16_peak": flops / (med / 1e3) / PEAK_BF16,
           "max_memory_allocated_bytes": peak, "run_a_s": a_s,
           "checksums_at_mesh_steps": sums,
           "restart": {"run_b1_s": b1_s, "run_b2_s": b2_s,
                       "losses": b_losses, "max_rel_loss_err": loss_err,
                       "max_state_err": state_err, "bit_equal": bit_equal}}
    emit({k: v for k, v in row.items() if k != "checksums_at_mesh_steps"})
    emit(prof_row)
    del pa, sa, a
    torch.cuda.empty_cache()
    row["bwd_device_ms_per_call"] = bwd_ms
    row["ssd_bwd_device_ms_per_call"] = ssd_bwd_ms
    return row


def mesh_launches(n, names=None, runs=None):
    """[(world size, run names)], one torchrun launch each, of the
    train_mesh runs (``tools/train_mesh.py`` ``RUNS``, or ``runs``) on a
    host of ``n`` cards: each run name (of ``names``, when given) at the
    most cards of its runs that ``n`` covers, one launch per world size
    (the most cards first) and one of its own for each ``alone`` run;
    and the names none fits, with the cards they need."""
    if runs is None:
        import train_mesh as tm     # tools/, on the path above
        runs = tm.RUNS
    worlds, missing = {}, {}
    for name in dict.fromkeys(r.name for r in runs
                              if not names or r.name in names):
        fit = [r for r in runs if r.name == name and r.cards <= n]
        if fit:
            run = max(fit, key=lambda r: r.cards)
            worlds.setdefault(run.cards, []).append(run)
        else:
            missing[name] = min(r.cards for r in runs if r.name == name)
    launches = []
    for world, runs in sorted(worlds.items(), reverse=True):
        shared = [r.name for r in runs if not r.alone]
        launches += ([(world, shared)] if shared else []) + [
            (world, [r.name]) for r in runs if r.alone]
    return launches, missing


def phase_train_mesh(torch, np, train=None, names=None):
    """Training over the cards of this host, one process per card:
    ``python -m torch.distributed.run --standalone`` on
    ``tools/train_mesh.py``, rendezvous on the loopback, once per launch
    that ``mesh_launches`` gives (on four cards: 4, the MoE's 16-layer
    cut and granite-3-8b's 40 layers each in a launch of its own, then 3
    for qwen2.5-14b's sequence-parallel run and qwen3-moe's (1, 3) one;
    on one: 1).  Each run of
    ``tools/train_mesh.py`` ``RUNS`` trains its model at published
    widths (the depth cuts in ``RUNS``) from seed 0, B 4 (granite 16,
    its config's 4 microbatches), for ``MESH_STEPS`` steps on each of
    its (data, model) layouts, FSDP one unit at a time:
    qwen3-0.6b ((1, 1); (2, 1), (1, 2); (4, 1), (1, 4), (2, 2), and
    (1, 4) with ``seq_shard_activations`` also against (1, 4) without
    it), mamba2-780m ((1, 4), (2, 2)), zamba2-1.2b, qwen3-moe-30b-a3b at 4
    and 16 layers (expert parallel, 32 experts a rank) and
    seamless-m4t-medium at (1, 4), qwen3-0.6b with int8 gradient
    compression at (4, 1) and (2, 2) (its sharded compression of a fixed
    tree bit-equal to one card's), qwen2.5-14b at (1, 3), qwen3-moe at 4
    layers at (1, 3) (128 experts on 3 cards: each expert's d_ff_expert
    cut), granite-3-8b
    at 8 layers ((4, 1), (2, 2)) and all 40 ((4, 1): no reference, no
    card holds it with its optimizer state), qwen3-0.6b and granite-3-8b
    at 8 layers on masked batches ((4, 1), (2, 2): JAX's masked mean per
    global microbatch, against one card's masked run); qwen3's
    checkpoint saved on one layout is restored onto another (one card: a
    one-card loop).  The worker's gates (``tools/train_mesh.py``
    ``gate_run``, checked after each run): exactly ``step_launches`` a
    step on every rank, and exactly ``step_collectives``' FSDP
    all-gathers and reduce-scatters, a masked run's one token-count
    all-reduce a step (none unmasked); against rank 0's one-card
    reference, one card bit-equal (losses and parameter checksums), more
    within stated tolerances; each run's line says what missed
    (``gates_missed``, every rank's).  Here, in addition: qwen3's reference
    bit-equal to the first steps of ``phase_train``'s run A when it ran
    (``train``).  A run that needs more cards than the host has is
    printed as not run.  ``names``: only the runs of these names.
    Prints per layout the median step ms (host
    clock, steps 2-3), tokens/s, each rank's peak memory (beside the
    run's prediction, where it has one), shard bytes and FSDP
    collectives a step (counts, largest tensors), each rank's profile of
    a 4th step (device busy, NCCL in all and by collective, GEMM,
    attention and SSD ms), the card count, and the memory this process
    still holds on cuda:0."""
    n = torch.cuda.device_count()
    launches, missing = mesh_launches(n, names)
    for name, need in missing.items():
        emit({"phase": "train_mesh", "run": name, "cards": n,
              "not_run": f"needs {need} cards, the host has {n}"})
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = {"allocated_bytes": torch.cuda.memory_allocated(0),
            "reserved_bytes": torch.cuda.memory_reserved(0)}
    rows, seconds, failed = {}, {}, {}
    for what, world, rc, ranks, sec in torchrun_launches(
            "train_mesh.py", os.path.join(ROOT, "build", "train_mesh"),
            launches):
        seconds[what] = sec
        for i, res in enumerate(ranks[0]["runs"] if ranks else ()):
            per_rank = [rk["runs"][i] for rk in ranks if len(rk["runs"]) > i]
            rows.update(mesh_rows(res, per_rank, world))
            ref = res.get("reference")
            emit({"phase": "train_mesh", "run": res["name"],
                  "cards": world, "card": ranks[0]["card"],
                  "seconds": res["seconds"],
                  "gates_missed": [m for rr in per_rank
                                   for m in rr["gates_missed"]],
                  "reference": None if ref is None else {
                      k: ref[k] for k in ("losses", "step_ms", "seconds")},
                  "reference_bit_equal_to_run_a":
                      res["name"] == TRAIN_ARCH and train is not None})
        if rc != 0:     # the next launch still runs; the phase fails after
            failed[what] = rc
            continue
        for res in ranks[0]["runs"]:
            ref = res.get("reference")
            if res["name"] == TRAIN_ARCH and train is not None:
                check(ref["losses"] == train["losses"][:MESH_STEPS]
                      and ref["checksums"] ==
                      train["checksums_at_mesh_steps"],
                      f"train_mesh: the one-card reference {ref['losses']} "
                      f"is not bit-equal to run A's first steps "
                      f"{train['losses']}")
    emit({"phase": "train_mesh", "cards": n, "launches": launches,
          "seconds_per_launch": seconds, "parent_holds_on_cuda0": held})
    check(not failed, f"train_mesh: the workers exited with {failed} "
          f"(launch: exit code)")
    return rows


def torchrun_launches(tool, out_dir, launches):
    """``python -m torch.distributed.run --standalone --nproc-per-node
    W tools/<tool> --out DIR --runs ...`` for each (W, run names) of
    ``launches`` in turn (NCCL and gloo on the loopback), each within
    ``MESH_TIMEOUT_S`` and its process group killed after; ``out_dir``
    emptied first, each launch's rank files and torchrun log
    (``log.txt``, its tail printed on a failure) in
    ``out_dir/launch<k>-world<W>``.  Yields (that directory's name, W,
    exit code, the rank files read, seconds)."""
    import shutil
    import signal
    shutil.rmtree(out_dir, ignore_errors=True)
    env = dict(os.environ, NCCL_SOCKET_IFNAME="lo", GLOO_SOCKET_IFNAME="lo")
    for k, (world, run_names) in enumerate(launches):
        wdir = os.path.join(out_dir, f"launch{k}-world{world}")
        os.makedirs(wdir)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(world),
               os.path.join(ROOT, "tools", tool), "--out", wdir,
               "--runs", *run_names]
        log = os.path.join(wdir, "log.txt")
        t0 = time.perf_counter()
        with open(log, "w") as f:
            proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=f,
                                    stderr=subprocess.STDOUT,
                                    start_new_session=True)
            try:
                rc = proc.wait(timeout=MESH_TIMEOUT_S)
            finally:
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
        sec = time.perf_counter() - t0
        ranks = []
        for r in range(world):
            path = os.path.join(wdir, f"rank{r}.json")
            if os.path.exists(path):
                with open(path) as f:
                    ranks.append(json.load(f))
        if rc != 0 or len(ranks) < world:
            with open(log) as f:
                print(f.read()[-12000:], flush=True)
        yield os.path.basename(wdir), world, rc, ranks, sec


def phase_serve_mesh(torch, np, serve_rows=None, names=None):
    """Serving over the cards of this host, one process per card:
    ``tools/serve_mesh.py`` under torchrun once per launch that
    ``mesh_launches`` gives for its ``RUNS`` (on four cards: 4, the
    48-layer MoE in a launch of its own, then 3 for qwen2.5-14b's
    sequence-parallel runs and qwen3-moe's (1, 3) run; on one: 1).  Each run serves its model at
    published widths (the depth cuts in ``RUNS``), random weights from
    seed 0, on each of its (data, model) layouts: qwen3-0.6b (8
    requests of 256-2048 tokens, 4 slots, 32 new: ``SERVE_MESH_TRAFFIC``)
    at (1, 1), and on four cards at (1, 1), (1, 2), (1, 4);
    mamba2-780m and seamless-m4t-medium (a prefill of 4 x 2048 frames, 32
    decode steps) at (1, 4); zamba2-1.2b's long_500k decode cell at (4,
    1) (a batch of 1 over 524,288 cached positions, the cache cut on S
    over "data"); qwen3-moe-30b-a3b at 16 layers against one card (its
    routes handed across; at (1, 4), and at (1, 3) with each expert's
    d_ff_expert cut) and at all 48; qwen2.5-14b at 8 layers
    against one card and at 48, sequence-parallel over 3 cards.  The
    worker's gates (``tools/serve_mesh.py`` ``gate_run``): exact kernel
    launches on every rank, finite logits, every rank the same tokens,
    a repeat equal; against rank 0's one-card run on its tokens, (1, 1)
    bit-equal (tokens and every call's logits), more cards the logits
    within ``serve_mesh.tolerance`` of the largest (bf16: three times
    the one card's own bf16 error, from its f32 shadow; the f32 twin of
    each run within 1e-4) and every token the one card's but at a near
    tie.  Here, in addition:
    the (1, 1) layout bit-equal to the serve phase's qwen3-0.6b run when
    it ran (``serve_rows``).  A run that needs more cards than the host
    has is printed as not run.  Prints per layout prefill ms by prompt
    length, decode tick ms, TTFT and tokens/s, each rank's peak memory
    and cache bytes and NCCL ms in a profiled decode step, and the card
    count."""
    import serve_mesh as sm         # tools/, on the path above
    n = torch.cuda.device_count()
    launches, missing = mesh_launches(n, names, sm.RUNS)
    for name, need in missing.items():
        emit({"phase": "serve_mesh", "run": name, "cards": n,
              "not_run": f"needs {need} cards, the host has {n}"})
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rows, seconds, failed = {}, {}, {}
    one = (serve_rows or {}).get(TRAIN_ARCH)
    for what, world, rc, ranks, sec in torchrun_launches(
            "serve_mesh.py", os.path.join(ROOT, "build", "serve_mesh"),
            launches):
        seconds[what] = sec
        if rc != 0:
            failed[what] = rc
        for i, res in enumerate(ranks[0]["runs"] if ranks else ()):
            per_rank = [rk["runs"][i] for rk in ranks if len(rk["runs"]) > i]
            ref = res.get("reference")
            emit({"phase": "serve_mesh", "run": res["name"],
                  "cards": world, "card": ranks[0]["card"],
                  "seconds": res["seconds"],
                  "gates_missed": [m for rr in per_rank
                                   for m in rr["gates_missed"]],
                  "launches_want": res["launches_want"],
                  "reference": None if ref is None else {
                      k: ref[k] for k in ref if k not in ("generated",
                                                          "profile")}})
            for j, row in enumerate(res["layouts"]):
                ranks_of = [rr["layouts"][j] for rr in per_rank
                            if len(rr["layouts"]) > j
                            and rr["layouts"][j]["layout"] == row["layout"]]
                out = {"phase": "serve_mesh", "run": res["name"],
                       "cards": world,
                       **{k: row[k] for k in row if k not in (
                           "generated", "profile")},
                       "ranks": len(ranks_of),
                       "launches_per_rank": [r["launches"] for r in ranks_of],
                       "peak_memory_bytes_per_rank":
                           [r["peak_memory_bytes"] for r in ranks_of],
                       "cache_bytes_per_rank": [r["cache_bytes"]
                                                for r in ranks_of],
                       "param_bytes_per_rank": [r["param_bytes"]
                                                for r in ranks_of],
                       "profile_per_rank": [
                           {k: v for k, v in r["profile"].items()
                            if k != "top_kernels"}
                           if isinstance(r["profile"], dict) else r["profile"]
                           for r in ranks_of],
                       "top_kernels_rank0": row["profile"].get("top_kernels")
                       if isinstance(row["profile"], dict) else None}
                if res["name"] == TRAIN_ARCH and row["layout"] == "1x1" \
                        and one is not None:
                    out["tokens_equal_to_serve_phase"] = (
                        row["generated"] == one["generated"])
                    out["bit_equal_to_serve_phase"] = (
                        out["tokens_equal_to_serve_phase"]
                        and row["logits_digest"] == one["logits_digest"])
                    if not out["bit_equal_to_serve_phase"]:
                        failed["1x1 against the serve phase"] = out[
                            "tokens_equal_to_serve_phase"]
                emit(out)
                rows[f"{res['name']}:{row['layout']}"] = out
    emit({"phase": "serve_mesh", "cards": n, "launches": launches,
          "seconds_per_launch": seconds})
    check(not failed, f"serve_mesh: the workers exited with {failed} "
          f"(launch: exit code; qwen3-0.6b's (1, 1) layout not bit-equal "
          f"to the serve phase: whether its tokens were equal)")
    return rows


def mesh_rows(res, per_rank, world):
    """The printed rows of one train_mesh run: per layout and restore,
    rank 0's row with every rank's launches and FSDP collectives a step,
    peak memory (beside the run's prediction, where it has one), shard
    bytes, median step ms and NCCL ms by collective."""
    rows = {}
    for kind in ("layouts", "restores"):
        for i, row in enumerate(res.get(kind, ())):
            ranks_of = [rr[kind][i] for rr in per_rank
                        if len(rr.get(kind, ())) > i]
            out = {"phase": "train_mesh", "run": res["name"],
                   "kind": kind[:-1], "cards": world,
                   **{k: row[k] for k in row if k not in (
                       "checksums", "launches")},
                   "launches_per_rank": [rr["launches_per_step"]
                                         for rr in ranks_of],
                   "collectives_per_rank": [rr["collectives_per_step"]
                                            for rr in ranks_of],
                   "peak_gb_predicted": res.get("peak_gb"),
                   "peak_memory_bytes_per_rank": [rr["peak_memory_bytes"]
                                                  for rr in ranks_of],
                   "param_shard_bytes_per_rank": [rr["param_shard_bytes"]
                                                  for rr in ranks_of],
                   "opt_shard_bytes_per_rank": [rr["opt_shard_bytes"]
                                                for rr in ranks_of],
                   "median_step_ms_per_rank": [rr["median_step_ms"]
                                               for rr in ranks_of],
                   "nccl_ms_per_rank": [rr.get("profile", {}).get("nccl_ms")
                                        for rr in ranks_of],
                   "nccl_ms_by_collective_per_rank": [
                       rr.get("profile", {}).get("nccl_ms_by_collective")
                       for rr in ranks_of]}
            emit(out)
            rows[f"{res['name']}:{kind[:-1]}:{row['layout']}"] = out
    return rows


def checksum(torch, tree):
    """{leaf: the sum of its 32-bit words as an int64} (16-bit words for
    bf16 leaves): one bit changed anywhere changes its leaf's sum."""
    from repro_torch.utils.params import tree_leaves
    out = {}
    for name, x in tree_leaves(tree):
        word = torch.int32 if x.element_size() == 4 else torch.int16
        out[name] = int(x.detach().contiguous().view(word).sum(
            dtype=torch.int64))
    return out


def encdec_batch(torch, cfg, step):
    """The encdec train phase's batch of a step: SyntheticLM tokens
    (TRAIN_BATCH, TRAIN_SEQ) and standard normal frame embeddings
    (TRAIN_BATCH, ENCDEC_FRAMES, D) drawn on the card, both from seed 0
    and the step."""
    from repro_torch.data.pipeline import SyntheticLM, device_batch
    hb = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0
                     ).batch_at(step)
    batch = device_batch(hb, "cuda")
    batch["enc_emb"] = torch.randn(
        (TRAIN_BATCH, ENCDEC_FRAMES, cfg.d_model), device="cuda",
        generator=torch.Generator("cuda").manual_seed(step))
    return batch


def train_runner(torch, cfg):
    """(run(steps, at) -> (state, losses, step ms, checksum of the
    parameters after step ``at``), batch_at(step)) for the MoE and
    encdec train phases, through ``TrainLoop`` (the checksum taken from
    its model's parameters, which the optimizer updates in place, by its
    per-step log hook): qwen3-moe on the loop's own stream (seed 0),
    seamless on ``encdec_batch``es.  Random weights from seed 0."""
    from repro_torch.launch.train import TrainLoop
    batches = None
    if cfg.family == "encdec":
        batches = lambda step: encdec_batch(torch, cfg, step)  # noqa: E731

    def loop():
        return TrainLoop(cfg, global_batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                         device="cuda", batches=batches)

    def run(steps, at):
        a = loop()
        sums = {}

        def hook(line):
            if line.startswith(f"step {at} "):
                sums.update(checksum(torch, a.model.params))
        pa, sa, _ = a.run(steps, log=hook)
        return ((a.step_fn, pa, sa), [h["loss"] for h in a.history],
                [h["ms"] for h in a.history], sums)
    return run, loop().batch_at


def phase_train_repeat(torch, np, rdev, arch, n=TRAIN_STEPS):
    """The MoE and encdec families' train phase, bf16 activations, f32
    parameters, remat "full", AdamW, S 4096, global batch 4, random
    weights from seed 0: qwen3-moe-30b-a3b at full width cut to
    ``MOE_TRAIN``'s 4 layers, 4 microbatches of one row (``TrainLoop``);
    seamless-m4t-medium at its published 6 + 6 layers on tokens (4,
    4096) and frames (4, 2048, 1024) (``TrainLoop(batches=)``).  Run A:
    ``n`` steps.  Gates: every loss finite; exactly ``step_launches``
    per step, every attention launch on the tensor cores; a second run
    of ``REPEAT_STEPS`` steps from the same seed gives bit-equal losses
    and parameter checksums (``checksum``) after its last step to run
    A's after the same step (the restart through a checkpoint stays on
    qwen3-0.6b: qwen3-moe's would hold 37 GB).  Prints the median step
    ms (host clock, steps 2-n), tokens/s (the decoder's), the
    model-FLOPs share of the bf16 peak, peak memory; train_profile:
    device time by kernel and the idle share over 2 more steps."""
    from repro_torch.configs.registry import get_config
    from repro_torch.utils.params import tree_leaves
    cfg = get_config(arch)
    if cfg.moe is not None:
        cfg = cfg.replace(n_layers=MOE_TRAIN[1],
                          grad_accum_microbatches=MOE_TRAIN[2])
    B, S = TRAIN_BATCH, TRAIN_SEQ
    Se = ENCDEC_FRAMES if cfg.family == "encdec" else 0
    per_step = step_launches(cfg, True)
    none = {k: 0 for k in rdev.launch_counts()}
    run, batch_at = train_runner(torch, cfg)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rdev.reset_launch_counts()
    t0 = time.perf_counter()
    (step_fn, pa, sa), losses, step_ms, sums_a = run(n, REPEAT_STEPS)
    torch.cuda.synchronize()
    a_s = time.perf_counter() - t0
    counts = rdev.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {**none, **{k: n * v for k, v in per_step.items()}}
    check(counts == want, f"train {arch} launches {counts}, want {want}")
    check(len(losses) == n and all(math.isfinite(x) for x in losses),
          f"train {arch} losses {losses}")
    n_params = sum(p.numel() for _, p in tree_leaves(pa))
    prof_row, pa, sa, bwd_ms, _ = profile_steps(
        torch, cfg, step_fn, pa, sa, [batch_at(n + i) for i in range(2)], n,
        per_step)
    del step_fn, pa, sa
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    _, losses_b, _, sums_b = run(REPEAT_STEPS, REPEAT_STEPS)
    b_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    check(losses_b == losses[:REPEAT_STEPS], f"train {arch} repeat losses "
          f"{losses_b} against {losses[:REPEAT_STEPS]}")
    check(sums_a and sums_b == sums_a, f"train {arch}: the repeat run's "
          f"parameters differ after step {REPEAT_STEPS}")
    med = float(np.median(step_ms[1:]))
    flops = train_flops(cfg, B, S, Se)
    row = {"phase": "train", "arch": cfg.name, "layers": cfg.n_layers,
           "enc_layers": cfg.enc_layers, "dec_layers": cfg.dec_layers,
           "d_model": cfg.d_model, "dtype": cfg.dtype,
           "param_dtype": cfg.param_dtype, "remat": cfg.remat,
           "optimizer": cfg.optimizer, "global_batch": B, "seq": S,
           "frames": Se, "microbatches": cfg.grad_accum_microbatches,
           "params": n_params, "steps": n, "losses": losses,
           "launches": counts, "launches_per_step": per_step,
           "step_ms": step_ms, "median_step_ms": med,
           "tokens_per_s": B * S / med * 1e3,
           "model_flops_per_step": flops,
           "mfu_bf16_peak": flops / (med / 1e3) / PEAK_BF16,
           "max_memory_allocated_bytes": peak, "run_a_s": a_s,
           "repeat": {"steps": REPEAT_STEPS, "run_s": b_s,
                      "losses_bit_equal": True,
                      "param_checksums_equal": True}}
    emit(row)
    emit(prof_row)
    row["bwd_device_ms_per_call"] = bwd_ms
    return row


def logits_digest(torch, sums):
    """A hash of per-call logits checksums (``logits_sum``), in order:
    equal digests, bit-equal logits call by call."""
    import hashlib
    vals = torch.stack(sums).cpu().tolist() if sums else []
    return hashlib.sha1(json.dumps(vals).encode()).hexdigest()


def logits_sum(torch, logits):
    """The sum of the logits' 32-bit words as an int64 (a device scalar):
    one bit changed changes it."""
    return logits.contiguous().view(torch.int32).sum(dtype=torch.int64)


class WatchLogits:
    """Records whether every prefill and decode step of the served model
    classes returns finite logits (a device flag, read once at the end),
    and each call's logits checksum (``digest``)."""

    def __init__(self, torch, classes):
        self.torch, self.classes = torch, classes
        self.flags, self.saved, self.sums = [], [], []

    def __enter__(self):
        for cls in self.classes:
            pre, dec = cls.prefill, cls.decode_step
            self.saved.append((cls, pre, dec))

            def prefill(model, *a, _f=pre, **kw):
                cache, logits = _f(model, *a, **kw)
                self.flags.append(self.torch.isfinite(logits).all())
                self.sums.append(logits_sum(self.torch, logits))
                return cache, logits

            def decode_step(model, *a, _f=dec, **kw):
                logits, cache = _f(model, *a, **kw)
                self.flags.append(self.torch.isfinite(logits).all())
                self.sums.append(logits_sum(self.torch, logits))
                return logits, cache

            cls.prefill, cls.decode_step = prefill, decode_step
        return self

    def __exit__(self, *exc):
        for cls, pre, dec in self.saved:
            cls.prefill, cls.decode_step = pre, dec

    def all_finite(self):
        return bool(self.torch.stack(self.flags).all().item())

    def digest(self):
        return logits_digest(self.torch, self.sums)


def run_serve(torch, rdev, arch, requests, slots, max_len, max_new,
              prompt_lens, layers=None):
    """``serve(..., smoke=False)`` between a reset and a read of the
    launch counters; returns (serve's result, with the device bytes
    allocated before it, ``allocated_before_bytes``, counts, all logits
    finite, peak device bytes)."""
    import gc
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import mamba2, transformer, zamba2
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with WatchLogits(torch, (zamba2.Zamba2LM, mamba2.Mamba2LM,
                             transformer.TransformerLM)) as watch:
        rdev.reset_launch_counts()
        out = serve_mod.serve(arch, smoke=False, requests=requests,
                              slots=slots, max_len=max_len, max_new=max_new,
                              seed=0, device="cuda", prompt_lens=prompt_lens,
                              layers=layers)
        torch.cuda.synchronize()
        counts = rdev.launch_counts()
        finite = watch.all_finite()
        out["logits_digest"] = watch.digest()
    out["allocated_before_bytes"] = before
    return out, counts, finite, torch.cuda.max_memory_allocated()


def serve_row(np, arch, out, counts, finite, peak):
    eng = out["engine"]
    by_len = {}
    for n, sec in eng.prefill_s:
        by_len.setdefault(n, []).append(sec * 1e3)
    ticks = np.asarray(eng.tick_s) * 1e3
    return {"phase": "serve", "arch": arch, "layers": out["cfg"].n_layers,
            "d_model": out["cfg"].d_model, "dtype": out["cfg"].dtype,
            "param_dtype": out["cfg"].param_dtype,
            "params": sum(p.numel() for p in out["model"].parameters()),
            "requests": len(out["done"]), "slots": eng.B,
            "max_len": eng.max_len, "launches": counts,
            "logits_finite": finite, **out["stats"], "wall_s": out["wall_s"],
            "prefill_ms_by_prompt_len": by_len,
            "decode_ticks": len(ticks),
            "decode_tick_ms_mean": float(ticks.mean()),
            "decode_tick_ms_median": float(np.median(ticks)),
            "max_memory_allocated_bytes": peak,
            "allocated_before_bytes": out["allocated_before_bytes"]}


def phase_serve(torch, np, rdev, runs=SERVE_RUNS, rerun_first=True):
    """The runs of ``SERVE_RUNS`` at published configs, through ``serve``.
    zamba2-1.2b first: 8 requests (prompts of 256, 512, 1024 and 2048
    tokens, twice each), 32 new tokens each, 4 slots; each prefill
    launches the attention kernel once per shared block (6) and the SSD
    kernel once per mamba layer (38), decode neither; a second run gives
    the same tokens.  Then mamba2-780m (48 SSD launches per request),
    qwen3-0.6b (28 attention launches per request), qwen3-moe-30b-a3b
    cut to 16 layers (16) and chameleon-34b cut to 8 (8), 2 requests
    each.  Every attention launch takes the tensor-core route (bf16).
    ``runs`` and ``rerun_first`` let ``tools/smoke_phases.py`` serve a
    few of the runs alone."""
    none = {"gat_mp": 0, "gat_mp_bwd": 0, "memsim": 0, "memsim_zoo": 0,
            "flash_attention": 0, "flash_attention_tc": 0,
            "flash_attention_bwd": 0, "flash_attention_bwd_tc": 0,
            "ssd_scan": 0, "ssd_scan_bwd": 0}
    first, rows = None, {}
    model = None
    for arch, requests, slots, max_new, lens, per, layers in runs:
        t0 = time.perf_counter()
        out, counts, finite, peak = run_serve(
            torch, rdev, arch, requests, slots, SERVE_MAX_LEN, max_new, lens,
            layers)
        want = {**none, **{k: requests * v for k, v in per.items()}}
        check(counts == want, f"{arch} serve launches {counts}, want {want}")
        check(counts["flash_attention_tc"] == counts["flash_attention"],
              f"{arch} serve: an attention launch left the tensor cores")
        check(finite, f"{arch} serve: non-finite logits")
        check(len(out["done"]) == requests
              and all(len(r.tokens) == max_new for r in out["done"]),
              f"{arch} serve: a request did not finish with {max_new} tokens")
        check(sorted(len(r.prompt) for r in out["done"])
              == sorted([lens[i % len(lens)] for i in range(requests)]),
              f"{arch} serve: prompt lengths")
        row = serve_row(np, arch, out, counts, finite, peak)
        row["seconds"] = time.perf_counter() - t0
        # for serve_mesh's one-card layout: each request's tokens and the
        # logits' digest (not printed)
        kept = {"generated": {str(r.rid): r.tokens for r in out["done"]},
                "logits_digest": out["logits_digest"]}
        if first is None and rerun_first:
            tokens = {r.rid: r.tokens for r in out["done"]}
            model = out["model"]
            out = None          # frees the engine's caches before the rerun
            again, counts2, _, _ = run_serve(torch, rdev, arch, requests,
                                             slots, SERVE_MAX_LEN, max_new,
                                             lens)
            check({r.rid: r.tokens for r in again["done"]} == tokens,
                  f"{arch} serve: a second run gave other tokens")
            check(counts2 == want, f"{arch} second run launches {counts2}")
            row["second_run_same_tokens"] = True
            row["second_run_tokens_per_s"] = again["stats"]["tokens_per_s"]
            del again
            first = row
        del out
        emit(row)
        rows[arch] = dict(row, **kept)
        torch.cuda.empty_cache()
    return first, model, rows


def phase_serve_profile(torch, np, model):
    """Device time by kernel (torch.profiler) over one 2048-token zamba2
    prefill and 10 decode ticks of the engine, against the host clock of
    the same window."""
    from torch.autograd import DeviceType
    from repro_torch.serving.engine import Engine, Request
    eng = Engine(model, model.params, slots=4, max_len=2112)
    prompt = np.random.default_rng(5).integers(0, model.cfg.vocab_size, 2048,
                                               dtype=np.int32)
    torch.cuda.synchronize()
    with padded_profile() as prof:
        t0 = time.perf_counter()
        eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=11))
        for _ in range(10):
            eng.tick()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    check(len(eng.done) == 1 and len(eng.done[0].tokens) == 11,
          "profiled request did not finish")
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            kernels.append({"name": evt.key[:80], "calls": evt.count,
                            "device_ms": dev_us / 1e3})
    kernels.sort(key=lambda k: -k["device_ms"])
    busy = sum(k["device_ms"] for k in kernels)
    mine = {tag: sum(k["device_ms"] for k in kernels if tag in k["name"])
            for tag in ("flash_fwd_wgmma", "flash_fwd_fp32cores",
                        "ssd_state_kernel", "ssd_pass_kernel",
                        "ssd_out_kernel")}
    mine["ssd_scan (3 kernels)"] = sum(mine[k] for k in (
        "ssd_state_kernel", "ssd_pass_kernel", "ssd_out_kernel"))
    emit({"phase": "serve_profile", "arch": model.cfg.name,
          "window": "one 2048-token prefill and 10 decode ticks, 4 slots",
          "wall_ms": wall_ms, "prefill_ms": eng.prefill_s[0][1] * 1e3,
          "decode_tick_ms": [t * 1e3 for t in eng.tick_s],
          "device_busy_ms": busy,
          "device_idle_share": (1.0 - busy / wall_ms) if kernels
          else "not measured", "kernel_device_ms": mine,
          "top_kernels": kernels[:15]})


def phase_serve_encdec(torch, np, rdev):
    """seamless-m4t-medium at its published config (6 encoder and 6
    decoder layers, d_model 1024, 16 heads of 64, d_ff 4096, vocab
    256,206; bf16 activations, f32 parameters, random weights from seed
    0), through the model's own entry points (the engine takes token
    prompts): ``prefill`` of B = 4 sequences of 2048 random frames (the
    frontend stub's input, seed 0), then 32 greedy ``decode_step``s, the
    whole run twice.  Gates: exactly 6 attention launches a prefill (one
    an encoder layer, non-causal, all on the tensor cores) and none a
    decode step (decode attends over the self and cross caches in plain
    torch ops); every logit finite; the second run gives the same
    tokens.  Prints prefill ms, decode step ms, decode tokens/s and peak
    memory (host clock; each decode step ends in a device sync)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.zoo import get_model
    cfg = get_config(ENCDEC_ARCH)
    B, F, n = ENCDEC_BATCH, ENCDEC_FRAMES, ENCDEC_STEPS
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = get_model(cfg)
    model.init(torch.Generator("cuda").manual_seed(0))
    frames = torch.randn((B, F, cfg.d_model), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(0))
    none = {k: 0 for k in rdev.launch_counts()}

    def run():
        with torch.no_grad():
            torch.cuda.synchronize()
            rdev.reset_launch_counts()
            t0 = time.perf_counter()
            cache, logits = model.prefill(model.params, frames, n + 8)
            tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)
            torch.cuda.synchronize()
            pre_ms = (time.perf_counter() - t0) * 1e3
            pre = rdev.launch_counts()
            flags, toks, step_ms = [torch.isfinite(logits).all()], [tok], []
            for i in range(n):
                t0 = time.perf_counter()
                logits, cache = model.decode_step(model.params, cache, tok,
                                                  i + 1)
                tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                flags.append(torch.isfinite(logits).all())
                toks.append(tok)
            counts = rdev.launch_counts()
        return (pre_ms, step_ms, pre, counts, bool(torch.stack(flags).all()),
                torch.stack(toks, 1).cpu())

    pre_ms, step_ms, pre, counts, finite, tokens = run()
    peak = torch.cuda.max_memory_allocated()
    want = {**none, "flash_attention": cfg.enc_layers,
            "flash_attention_tc": cfg.enc_layers}
    check(pre == want, f"serve_encdec prefill launches {pre}, want {want}")
    check(counts == pre, f"serve_encdec decode launched {counts} - {pre}")
    check(finite, "serve_encdec: non-finite logits")
    again = run()
    check(torch.equal(again[5], tokens), "serve_encdec: a second run gave "
          "other tokens")
    check(again[3] == counts, f"serve_encdec second run launches {again[3]}")
    med = float(np.median(step_ms))
    row = {"phase": "serve_encdec", "arch": cfg.name,
           "enc_layers": cfg.enc_layers, "dec_layers": cfg.dec_layers,
           "d_model": cfg.d_model, "dtype": cfg.dtype,
           "param_dtype": cfg.param_dtype,
           "params": sum(p.numel() for p in model.parameters()),
           "batch": B, "frames": F, "decode_steps": n,
           "launches_prefill": pre, "logits_finite": finite,
           "second_run_same_tokens": True, "prefill_ms": pre_ms,
           "prefill_ms_second_run": again[0],
           "decode_step_ms": step_ms, "decode_step_ms_median": med,
           "decode_tokens_per_s": B * n / (sum(step_ms) / 1e3),
           "tokens_per_s": B * (n + 1) / ((pre_ms + sum(step_ms)) / 1e3),
           "max_memory_allocated_bytes": peak,
           "first_tokens": tokens[:, :8].tolist()}
    emit(row)
    del model
    torch.cuda.empty_cache()
    return row


# ------------------------------------------------------- placement
PLACEMENT_TAIL = 48        # Zipf-tail requests after the catalogue sweep


def placement_stream(sp, registry):
    """Every supported (arch, shape) of the registry over the serving
    shapes once, so that every size class misses, then a Zipf tail of
    ``synthetic_stream``, numbered on."""
    from repro_torch.serving.placement_service import PlacementRequest
    sweep = [(a, s) for a, s, ok, _ in registry.all_cells()
             if s in sp.SERVE_SHAPES]
    tail = sp.synthetic_stream(PLACEMENT_TAIL, seed=0)
    return ([PlacementRequest(i, a, s) for i, (a, s) in enumerate(sweep)]
            + [PlacementRequest(len(sweep) + r.request_id, r.arch, r.shape)
               for r in tail]), len(sweep)


def placement_launches(svc):
    """The kernel launches a service's counters imply: per generation a
    population forward (4 GAT launches) and a simulator zoo launch, per
    warm start from a prior one forward, per neighbour re-score a zoo
    launch, per compiler reference a single-graph launch."""
    c = svc.metrics.snapshot()["counters"]
    gens = sum(v for k, v in c.items() if k.startswith("generations"))
    return {"gat_mp": 4 * (gens + c["prior_forwards"]), "gat_mp_bwd": 0,
            "memsim": c["compiler_refs"],
            "memsim_zoo": gens + c["nn_rescored"], "flash_attention": 0,
            "flash_attention_tc": 0, "flash_attention_bwd": 0,
            "flash_attention_bwd_tc": 0, "ssd_scan": 0, "ssd_scan_bwd": 0}, gens


def placement_gat_capture(ops, kept):
    """A stand-in for the GNN's ``gat_ops`` that launches the kernel as
    the path does and keeps, in ``kept``, a copy of the inputs of the
    first launch of each shape (z, e_src, e_dst, mask, rep)."""
    def gat_mp(z, es, ed, a, rep=1):
        key = (tuple(z.shape), tuple(a.shape), rep)
        if key not in kept:
            kept[key] = tuple(t.detach().clone()
                              for t in (z, es, ed, a)) + (rep,)
        return ops.gat_mp(z, es, ed, a, rep)
    return types.SimpleNamespace(gat_mp=gat_mp)


def placement_gat_check(torch, ops, kept, run):
    """Hold the kernel against its plain version at every shape the
    service gave it in one run, at the gat phase's gates; the level-0
    shapes must cover classes 128 to 1024."""
    classes = {key[0][1] for key in kept}
    check({128, 256, 512, 1024} <= classes,
          f"placement gat ({run}): classes seen {sorted(classes)}")
    worst, worst_l = 0.0, 0.0
    for z, es, ed, a, rep in kept.values():
        err, l_rel = gat_compare(torch, ops, z, es, ed, a, rep)
        worst, worst_l = max(worst, err), max(worst_l, l_rel)
    return {"shapes": [[list(k[0]), list(k[1]), k[2]] for k in kept],
            "max_abs_err": worst, "l_max_rel_err": worst_l}


def placements(results):
    """hash -> (source, speedup, latency, mapping bytes), and the
    (request, hit) sequence."""
    return ({r.graph_hash: (r.source, r.speedup, r.latency_ms,
                            r.mapping.tobytes()) for r in results},
            sorted((r.request_id, r.cache_hit, r.nn_hit) for r in results))


def phase_placement(torch, np, rdev):
    """The placement service through ``serve_placements.serve`` at its
    defaults (pop 8, batch 4, budget "auto", the neighbour cache on, the
    GNN at 128 x 4 levels x 4 heads) on the card: the registry sweep
    (classes 128, 256, 512 and 1024 all miss) and a Zipf tail, traced
    (``REPRO_OBS=jsonl``) and persisted.  Checks: every result ok; every
    served mapping re-evaluated by the plain simulator on the CPU gives
    the reported latency (1e-6 rel) and a speedup of at least 1.0; the
    launch counts are what the service's counters imply; a second fresh
    service and a ``thread:2`` one give the same placements and hit/miss
    sequence; in both, the GAT kernel, held against its plain version at
    every shape the service gives it (B = pop x slots, shared masks,
    classes 128 to 1024), agrees within the gat phase's gates; the trace passes ``tools/trace_report.py``'s gate; a
    service restarted from the persisted directory answers the stream
    with 0 evaluator calls and no kernel launch, then re-scores a
    one-node variant of llama3-405b decode_32k through the neighbour
    cache with the launches its counters imply.  Then the device busy
    time and idle share of one class-1024 miss batch.  Returns the
    launch counts of the traced run."""
    import dataclasses
    import tempfile
    import trace_report
    from repro_torch import obs
    from repro_torch.configs import registry
    from repro_torch.core import gnn
    from repro_torch.graphs.extract import extract_for
    from repro_torch.kernels.gat_mp import ops as gat_ops
    from repro_torch.launch import serve_placements as sp
    from repro_torch.memsim import compiler, simulator as sim
    from repro_torch.serving import placement_service as ps

    reqs, n_sweep = placement_stream(sp, registry)
    with tempfile.TemporaryDirectory() as tmp:
        trace, persist = os.path.join(tmp, "trace.jsonl"), \
            os.path.join(tmp, "svc")
        rdev.reset_launch_counts()
        with obs.override(mode="jsonl", path=trace):
            results, summary, svc = sp.serve(reqs, seed=0, persist=persist,
                                             device="cuda", log=None)
        torch.cuda.synchronize()
        counts = rdev.launch_counts()
        want, gens = placement_launches(svc)
        check(counts == want, f"placement launches {counts}, the service's "
              f"counters imply {want}")
        check(len(results) == len(reqs) and all(r.ok for r in results),
              f"placement: failed {[r.error for r in results if not r.ok]}")
        graphs = {(r.arch, r.shape): extract_for(r.arch, r.shape)
                  for r in results}
        sweep = [r for r in results if r.request_id < n_sweep]
        classes = sorted({ps.size_class(graphs[r.arch, r.shape].n)
                          for r in sweep if not r.cache_hit})
        check({128, 256, 512, 1024} <= set(classes),
              f"placement: classes missed {classes}")
        worst = 0.0
        for (arch, shape), g in graphs.items():
            r = next(x for x in results if (x.arch, x.shape) == (arch, shape))
            _, ref = compiler.compiler_reference(g, "cpu")
            res = sim.evaluate(sim.build_sim_graph(g, "cpu"),
                               torch.as_tensor(r.mapping), ref)
            lat = float(res["latency"]) * 1e3
            err = abs(lat - r.latency_ms) / r.latency_ms
            worst = max(worst, err)
            check(err <= 1e-6, f"placement {arch} {shape}: latency "
                  f"{r.latency_ms} ms, the CPU simulator gives {lat}")
            check(ref * 1e3 / lat >= 1.0 and r.speedup >= 1.0,
                  f"placement {arch} {shape}: speedup {ref * 1e3 / lat}")
        mine = placements(results)

        kept_off, kept_thread = {}, {}
        try:
            gnn.gat_ops = placement_gat_capture(gat_ops, kept_off)
            again = sp.serve(reqs, seed=0, device="cuda", log=None)[0]
            gnn.gat_ops = placement_gat_capture(gat_ops, kept_thread)
            t0 = time.perf_counter()
            threaded, _, tsvc = sp.serve(reqs, seed=0, slots="thread:2",
                                         device="cuda", log=None)
            thread_s = time.perf_counter() - t0
        finally:
            gnn.gat_ops = gat_ops
        check(placements(again) == mine,
              "placement: a second fresh service gave other placements")
        gat_held = {"off": placement_gat_check(torch, gat_ops, kept_off,
                                               "off"),
                    "thread:2": placement_gat_check(torch, gat_ops,
                                                    kept_thread, "thread:2")}
        del kept_off, kept_thread
        check(placements(threaded) == mine,
              "placement: thread:2 gave other placements than off")
        check(not tsvc._slots and tsvc.stats()["queued"] == 0,
              "placement: thread:2 left work behind")

        events, bad = trace_report.load_events(trace)
        problems = trace_report.gate(trace_report.TraceIndex(events))
        check(not problems and not bad, f"placement trace gate: {problems}")

        rdev.reset_launch_counts()
        restarted = ps.PlacementService(seed=0, persist=persist,
                                        device="cuda")
        replay = restarted.run(reqs)
        torch.cuda.synchronize()
        rcounts = rdev.launch_counts()
        check(restarted.evaluator_calls == 0
              and not any(rcounts.values()),
              f"placement restart: {restarted.evaluator_calls} refinements, "
              f"launches {rcounts}")
        check(all(r.ok and r.cache_hit for r in replay)
              and {r.graph_hash: r.mapping.tobytes() for r in replay}
              == {h: v[3] for h, v in mine[0].items()},
              "placement restart: not every request hit the cache")

        # the neighbour path on the card: a one-node variant of a served
        # graph is re-scored (one zoo launch) and served or refined
        g = graphs["llama3-405b", "decode_32k"]
        nodes = list(g.nodes)
        nodes[7] = dataclasses.replace(
            nodes[7], weight_bytes=nodes[7].weight_bytes * 2)
        near = dataclasses.replace(g, nodes=nodes)
        got = restarted.submit(ps.PlacementRequest(len(reqs), "near",
                                                   "decode_32k"), graph=near)
        got = [got] if got is not None else restarted.run_until_drained()
        torch.cuda.synchronize()
        ncounts = rdev.launch_counts()
        nwant, _ = placement_launches(restarted)
        check(restarted.metrics.counter("nn_rescored").value == 1
              and ncounts == nwant and len(got) == 1 and got[0].ok
              and got[0].speedup >= 1.0,
              f"placement neighbour: launches {ncounts}, want {nwant}, "
              f"{got}")
        neighbour = {"nn_hit": got[0].nn_hit, "source": got[0].source,
                     "speedup": got[0].speedup, "launches": ncounts}

    # one class-1024 miss batch (llama3-405b at the serving shapes) under
    # a padded profile, on a warmed service
    from torch.autograd import DeviceType
    prof_svc = ps.PlacementService(seed=1, device="cuda")
    prof_svc.run([ps.PlacementRequest(0, "seamless-m4t-medium",
                                      "decode_32k")])
    for i, shape in enumerate(sp.SERVE_SHAPES):
        check(prof_svc.submit(ps.PlacementRequest(1 + i, "llama3-405b",
                                                  shape)) is None,
              "placement profile: llama3-405b did not miss")
    torch.cuda.synchronize()
    with padded_profile() as prof:
        t0 = time.perf_counter()
        batch = prof_svc.run_until_drained()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    check(len(batch) == 3 and all(r.ok for r in batch),
          "placement profile: the class-1024 batch failed")
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            kernels.append({"name": evt.key[:80], "calls": evt.count,
                            "device_ms": dev_us / 1e3})
    kernels.sort(key=lambda k: -k["device_ms"])
    busy = sum(k["device_ms"] for k in kernels)
    refine = {k: v for k, v in svc.metrics.snapshot()["histograms"].items()
              if k.startswith("refine_ms")}
    c = svc.metrics.snapshot()["counters"]
    emit({"phase": "placement", "requests": len(reqs), "sweep": n_sweep,
          "classes_missed": classes, "summary": summary,
          "placements_per_s": summary["placements_per_sec"],
          "hit_p50_ms": summary["hit_p50_ms"],
          "hit_p99_ms": summary["hit_p99_ms"],
          "miss_p50_ms": summary["miss_p50_ms"],
          "miss_p99_ms": summary["miss_p99_ms"],
          "mean_speedup": summary["mean_speedup"],
          "egrl_frac": summary["egrl_frac"],
          "refine_ms_per_class": {
              k: {"count": v["count"],
                  "mean_ms": v["sum"] / v["count"] if v["count"] else 0.0,
                  "max_ms": v.get("max")} for k, v in refine.items()},
          "counters": c, "generations": gens, "launches": counts,
          "latency_max_rel_err": worst,
          "second_service_equal": True, "thread2_equal": True,
          "gat_held": gat_held,
          "thread2_wall_s": thread_s, "off_wall_s": summary["wall_s"],
          "trace_events": len(events), "trace_gate": "ok",
          "restart_evaluator_calls": restarted.evaluator_calls,
          "restart_launches": rcounts, "neighbour": neighbour})
    emit({"phase": "placement_profile",
          "window": "one class-1024 miss batch: llama3-405b at train_4k, "
                    "prefill_32k and decode_32k, from submit to commit",
          "wall_ms": wall_ms, "device_busy_ms": busy,
          "device_idle_share": (1.0 - busy / wall_ms) if kernels
          else "not measured",
          "counters": prof_svc.metrics.snapshot()["counters"],
          "top_kernels": kernels[:12]})
    return counts


def per_launch(tot):
    """A group's times over its launches (calls of the wrapper)."""
    n = tot["launches"]
    return {f"{k}_per_launch": (tot[k] / n if not isinstance(tot[k], str)
                                else tot[k])
            for k in ("ms", "device_ms", "bound_ms", "library_ms",
                      "plain_ms")}


def run_egrl(torch, np, rdev, gen, regs_memsim):
    """Phases 3-8, the EGRL slices' paths; returns their kernel rows.
    ``regs_memsim``: registers and spills of both simulator kernels."""
    from repro_torch.core import egrl, gnn, params, replay, sac
    from repro_torch.graphs import bucketed, zoo
    from repro_torch.kernels.gat_mp import ops
    from repro_torch.memsim import batch as mb, compiler, simulator as sim

    masks = {name: torch.as_tensor(make().adjacency() > 0, device="cuda")
             for name, make in zoo.WORKLOADS.items()}

    # 3. GAT forward kernel against its plain version
    phase_gat(torch, gen, ops, masks)
    bert = zoo.bert()
    feats = torch.as_tensor(bert.features(), device="cuda")
    gat_path = phase_gat_path(torch, gnn, ops, params, feats, masks["bert"],
                              gen)

    zoo_masks = {"+".join(b.names): b.adj > 0 for b in
                 bucketed.build_bucketed_zoo(
                     [make() for make in zoo.WORKLOADS.values()],
                     device="cuda").buckets}
    phase_gat_zoo(torch, gen, ops, zoo_masks)

    # 4. GAT backward kernel against its plain version
    phase_gat_bwd(torch, gen, ops, masks)
    bwd_path = phase_gat_path_bwd(torch, np, ops, sac, replay, feats,
                                  masks["bert"], gen)

    # 5. simulator kernel against its plain version, and its zoo entry
    mem_path = phase_memsim(torch, zoo, sim, compiler, gen)
    zoo_path = phase_memsim_zoo(torch, zoo, sim, mb, bucketed, gen)

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
    phase_gat_tune(torch, zoo)

    # the multi-workload path
    zoo_runs = phase_zoo(torch, np, zoo, egrl, sim, compiler, rdev)
    zoo_counts = zoo_runs["egrl"]["launches"]

    # the search across several devices
    shard_counts, dispatch_counts = phase_shard(torch, np, zoo, egrl, rdev)

    # 7. Greedy-DP, the simulator's heaviest caller
    greedy = phase_greedy(torch, np, rdev, zoo, sim, compiler)

    # 8. profile
    phase_profile(torch, egrl, zoo)
    phase_profile(torch, egrl, zoo, mode="egrl", generations=1)
    phase_profile(torch, egrl, zoo, mode="egrl", generations=1, multi=True)

    ea = runs["bert", "ea"]["launches"]
    src = "the BERT egrl run (launches_ea: the BERT EA run)"
    return [
        {"name": "gat_mp_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/gat_mp.cu",
         "replaces": "src/repro/kernels/gat_mp/gat_mp.py:35",
         "launches": counts["gat_mp"], "launches_ea": ea["gat_mp"],
         "launches_from": src,
         "max_abs_err": gat_path["err"],
         "ms": gat_path["ms"], "plain_ms": gat_path["plain_ms"],
         "bound_ms": gat_path["bound_ms"], "bound_by": gat_path["bound_by"],
         "library_ms": gat_path["library_ms"],
         "device_ms": gat_path["device_ms"],
         **per_launch(gat_path),
         "launches_zoo_egrl": zoo_counts["gat_mp"],
         "launches_shard": shard_counts["gat_mp"],
         "launches_shard_from": "the BERT egrl run at 3 pop shards, 3 "
                                "generations (memsim_evaluate_zoo's: the "
                                "7-graph zoo's async dispatch run)",
         "per": "one population forward: 4 launches, BERT, P=16"},
        {"name": "gat_mp_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/gat_mp_bwd.cu",
         "replaces": "src/repro/kernels/gat_mp/gat_mp.py:98",
         "launches": counts["gat_mp_bwd"], "launches_ea": ea["gat_mp_bwd"],
         "launches_from": src,
         "max_abs_err": bwd_path["err"],
         "ms": bwd_path["ms"], "plain_ms": bwd_path["plain_ms"],
         "bound_ms": bwd_path["bound_ms"], "bound_by": bwd_path["bound_by"],
         "library_ms": bwd_path["library_ms"],
         "device_ms": bwd_path["device_ms"],
         **per_launch(bwd_path),
         "launches_zoo_egrl": zoo_counts["gat_mp_bwd"],
         "launches_shard": shard_counts["gat_mp_bwd"],
         "per": "one SAC step: 8 calls (one CUDA launch each), BERT, B=24 "
                "and B=1"},
        {"name": "memsim_evaluate", "route": "cuda",
         "source": "src/repro_torch/csrc/memsim.cu",
         "replaces": "src/repro/memsim/simulator.py:163",
         "launches": counts["memsim"], "launches_ea": ea["memsim"],
         "launches_from": src,
         "launches_greedy": greedy,
         "launches_greedy_from": "Greedy-DP at Figure 4's budget (4000)",
         "max_abs_err": mem_path["err"],
         "ms": mem_path["ms"], "plain_ms": mem_path["plain_ms"],
         "bound_ms": mem_path["bound_ms"], "bound_by": mem_path["bound_by"],
         "library_ms": None, "device_ms": mem_path["device_ms"],
         "latency_bound_ms": mem_path["latency_bound_ms"],
         "bound_share": mem_path["bound_share"],
         "sm_clock_mhz": mem_path["sm_clock_mhz"],
         "latency_reward_bit_equal": mem_path["latency_reward_bit_equal"],
         "launches_zoo_egrl": zoo_counts["memsim"],
         "launches_shard": shard_counts["memsim"],
         **regs_memsim["memsim_kernel"],
         "per": "one population: 1 launch, BERT, P=20; bound_ms is the "
                "roofline, latency_bound_ms the dependent chain (the "
                "larger sets bound_share)"},
        {"name": "memsim_evaluate_zoo", "route": "cuda",
         "source": "src/repro_torch/csrc/memsim.cu",
         "replaces": "src/repro/memsim/batch.py:79",
         "launches": zoo_counts["memsim_zoo"],
         "launches_ea": zoo_runs["ea"]["launches"]["memsim_zoo"],
         "launches_from": "the 7-graph zoo egrl run, 3 generations "
                          "(launches_ea: the zoo EA run)",
         "max_abs_err": zoo_path["err"],
         "ms": zoo_path["ms"], "plain_ms": zoo_path["plain_ms"],
         "bound_ms": zoo_path["bound_ms"], "bound_by": zoo_path["bound_by"],
         "library_ms": None, "device_ms": zoo_path["device_ms"],
         "latency_bound_ms": zoo_path["latency_bound_ms"],
         "bound_share": zoo_path["bound_share"],
         "single_graph_device_ms": zoo_path["single_graph_device_ms"],
         "launches_shard": dispatch_counts["memsim_zoo"],
         **regs_memsim["memsim_zoo_kernel"],
         "per": "one bucket: 1 launch, moe_transformer + dense_cnn "
                "(N_max 1043, W_max 126), P=20"}]


def kernel_name(mangled):
    """The kernel's own name in a mangled entry name (the last component
    of its nested name that holds "kernel"), with its int template
    argument."""
    import re
    names, m = [], re.match(r"_ZN?", mangled)
    pos = m.end() if m else len(mangled)
    while True:
        d = re.match(r"\d+", mangled[pos:])
        if not d:
            break
        start = pos + d.end()
        names.append(mangled[start:start + int(d.group())])
        pos = start + int(d.group())
    name = next((x for x in reversed(names) if "kernel" in x), mangled)
    arg = re.search(r"ILi(\d+)E", mangled)
    return name + (f"<{arg.group(1)}>" if arg else "")


def ptxas_kernels(rep):
    """Per source, each entry's registers and spill bytes (stores and
    loads) from the compiler's ``-Xptxas -v`` report."""
    import re
    out = {}
    for src, v in rep.items():
        entry = None
        for ln in v["log"].splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                entry = kernel_name(m.group(1))
                out.setdefault(src, {})[entry] = {"registers": None,
                                                  "spill_bytes": 0}
                continue
            if entry is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m:
                out[src][entry]["spill_bytes"] = int(m.group(1)) + int(
                    m.group(2))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                out[src][entry]["registers"] = int(m.group(1))
    return out


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(
        argv)
    t_all = time.perf_counter()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        sys.exit("chip_smoke: src/repro_torch not found next to the script")
    sys.path.insert(0, SRC)
    from repro_torch import device as rdev
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_scan import ops as sops

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
    rep = build.build(["gat_mp", "gat_mp_bwd", "memsim", "flash_attention",
                       "flash_attention_bwd", "ssd_scan", "ssd_scan_bwd"])
    regs = ptxas_kernels(rep)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source": {k: {"seconds": v["seconds"], "cached": v["cached"],
                             "ptxas": [ln.strip() for ln in
                                       v["log"].splitlines()
                                       if "registers" in ln or "spill" in ln
                                       or "smem" in ln or "entry" in ln]}
                         for k, v in rep.items()},
          "kernels": regs})
    check(len(regs.get("ssd_scan", {})) == 9,
          f"ssd_scan: no compiler report for its 9 kernels: {regs}")
    for entry, info in regs["ssd_scan"].items():
        check(info["spill_bytes"] == 0, f"ssd_scan {entry} spills {info}")
    check(len(regs.get("ssd_scan_bwd", {})) == 18,
          f"ssd_scan_bwd: no compiler report for its 18 kernels (state, w, "
          f"dxd and ds kernels x 4 head dims, pass, dla): {regs}")
    for entry, info in regs["ssd_scan_bwd"].items():
        check(info["spill_bytes"] == 0, f"ssd_scan_bwd {entry} spills {info}")
    check(sorted(regs.get("memsim", {})) == ["memsim_kernel",
                                             "memsim_zoo_kernel"],
          f"memsim: no compiler report for its two kernels: {regs}")
    for entry, info in regs["memsim"].items():
        check(info["spill_bytes"] == 0, f"{entry} spills {info}")
    check(len(regs.get("flash_attention_bwd", {})) == 22,
          f"flash_attention_bwd: no compiler report for its 22 kernels "
          f"(fp32 cores: 2 kernels x 4 head dims x 2 dtypes; tensor cores: "
          f"3 kernels x 2 head dims): {regs}")
    bwd_tc = {e: info for e, info in regs["flash_attention_bwd"].items()
              if any(n in e for n in BWD_TC_KERNELS)}
    check(len(bwd_tc) == 6, f"flash_attention_bwd: {len(bwd_tc)} "
          f"tensor-core kernels in the compiler report, want 6")
    for entry, info in bwd_tc.items():
        check(info["spill_bytes"] == 0, f"{entry} spills {info}")

    gen = torch.Generator("cuda").manual_seed(0)
    seconds = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t0
        emit({"phase_done": name, "seconds": seconds[name]})
        return out

    rows = timed("egrl", run_egrl, torch, np, rdev, gen,
                 regs["memsim"])                           # 3-8
    flash = timed("flash", phase_flash, torch, fops, gen)  # 9
    ssd = timed("ssd", phase_ssd, torch, sops, gen)        # 10
    flash_bwd = timed("flash_bwd", phase_flash_bwd, torch, fops,
                      gen)                                 # 15
    ssd_bwd = timed("ssd_bwd", phase_ssd_bwd, torch, sops, rdev, gen)
    timed("serve_check", phase_serve_check, torch, rdev)   # 11
    serve, model, serve_rows = timed("serve", phase_serve, torch, np,
                                     rdev)                 # 12
    timed("serve_profile", phase_serve_profile, torch, np, model)
    del model
    torch.cuda.empty_cache()
    encdec = timed("serve_encdec", phase_serve_encdec, torch, np, rdev)
    serve_mesh = timed("serve_mesh", phase_serve_mesh, torch, np,
                       serve_rows)
    with one_device_env():
        placement = timed("placement", phase_placement, torch, np, rdev)  # 14
    timed("train_check", phase_train_check, torch, rdev)   # 16
    train = timed("train", phase_train, torch, np, rdev)   # 17
    train_mesh = timed("train_mesh", phase_train_mesh, torch, np, train)
    train_ssm = {arch: timed(f"train:{arch}", phase_train, torch, np, rdev,
                             arch, TRAIN_STEPS, TRAIN_SSM_LAYERS[arch])
                 for arch in TRAIN_SSM}
    train_new = {arch: timed(f"train:{arch}", phase_train_repeat, torch, np,
                             rdev, arch)
                 for arch in (MOE_TRAIN[0], ENCDEC_ARCH)}

    # 13. kernels
    f, s_ = flash["zamba2-1.2b", 2048], ssd["zamba2-1.2b", 2048]
    fq = flash["qwen3-0.6b", 2048]
    src = "the zamba2-1.2b serve run (8 requests, 256 to 2048 tokens)"
    rows += [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:23",
         "launches": serve["launches"]["flash_attention"],
         "launches_from": src, "max_abs_err": f["max_abs_err"],
         "ms": f["ms"], "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
         "bound_by": f["bound_by"], "library_ms": f["library_ms"],
         "kernel_route": f["route"],
         "launches_tensor_cores": serve["launches"]["flash_attention_tc"],
         "ms_fp32_cores": f["ms_fp32_cores"], "tflops": f["tflops"],
         "bound_share": f["bound_share"],
         "ms_over_library": f["ms_over_library"],
         "qwen3_2048": {k: fq[k] for k in ("ms", "ms_fp32_cores",
                                           "library_ms", "bound_ms",
                                           "tflops")},
         "per": "one call at zamba2's 2048-token prefill: B=1, 32 heads of "
                "64, bf16, causal"},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:23",
         "launches": serve["launches"]["ssd_scan"],
         "launches_from": src, "max_abs_err": max(s_["max_abs_err"].values()),
         "ms": s_["ms"], "plain_ms": s_["plain_ms"],
         "bound_ms": s_["bound_ms"], "bound_by": s_["bound_by"],
         "library_ms": None, "device_ms": s_["device_ms"],
         "bound_ms_tc": s_["bound_ms_tc"], "bound_share": s_["bound_share"],
         "cuda_kernels": ["ssd_state_kernel", "ssd_pass_kernel",
                          "ssd_out_kernel"],
         "mamba2_780m_2048": {k: ssd["mamba2-780m", 2048][k] for k in (
             "ms", "device_ms", "bound_ms", "bound_ms_tc", "bound_share")},
         "per": "one call (3 CUDA kernels) at zamba2's 2048-token prefill: "
                "B=1, H=64, hd=64, N=64, Q=256; bound_ms on the f32 cores, "
                "bound_ms_tc in 3xTF32 on the tensor cores"}]
    fb = flash_bwd["qwen3-0.6b:train"]
    # device ms from a profile that recorded every launch of its window:
    # the flash_bwd row's one-call windows, else train_profile's
    bwd_dev, bwd_from = fb["device_ms"], fb["device_ms_from"]
    if isinstance(bwd_dev, str):
        bwd_dev = train["bwd_device_ms_per_call"]
        bwd_from = (f"train_profile: the tensor-core kernels over the "
                    f"{2 * train['layers']} calls of 2 steps (the "
                    f"flash_bwd row: {fb['device_ms_from']})")
    rows.append(
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
         "replaces": "src/repro/models/attention.py:113",
         "launches": train["launches"]["flash_attention_bwd"],
         "launches_from": f"the {TRAIN_ARCH} train run ({TRAIN_STEPS} steps, "
                          f"B={TRAIN_BATCH}, S={TRAIN_SEQ})",
         "max_abs_err": fb["max_abs_err"], "ms": fb["ms"],
         "plain_ms": fb["plain_ms"], "bound_ms": fb["bound_ms"],
         "bound_by": fb["bound_by"], "library_ms": fb["library_ms"],
         "device_ms": bwd_dev, "device_ms_from": bwd_from,
         "device_ms_train_profile": train["bwd_device_ms_per_call"],
         "tflops": fb["tflops"], "bound_share": fb["bound_share"],
         "kernel_route": fb["route"], "ms_fp32_cores": fb["ms_fp32_cores"],
         "launches_tensor_cores":
             train["launches"]["flash_attention_bwd_tc"],
         "cuda_kernels": list(BWD_TC_KERNELS),
         "cuda_kernels_fp32_cores": list(BWD_FP32_KERNELS),
         "zamba2_heads_4096": {k: flash_bwd["bf16:h=64:S=4096"][k] for k in (
             "ms", "device_ms", "ms_fp32_cores", "library_ms", "bound_ms",
             "tflops")},
         "per": f"one call at the train shape: B={TRAIN_BATCH}, "
                f"S={TRAIN_SEQ}, 8 KV heads x 2 queries of 128, bf16, "
                f"causal; library_ms: SDPA's backward, KV expanded; "
                f"device_ms_train_profile: the tensor-core kernels' device "
                f"time in train_profile over its calls"})
    fz, fm = ssd_bwd["zamba2-1.2b:train"], ssd_bwd["mamba2-780m:train"]
    z_train = train_ssm["zamba2-1.2b"]
    rows.append(
        {"name": "ssd_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd_scan_bwd.cu",
         "replaces": "src/repro/models/mamba2.py:77",
         "launches": z_train["launches"]["ssd_scan_bwd"],
         "launches_from": f"the zamba2-1.2b train run ({TRAIN_STEPS} steps, "
                          f"B={TRAIN_BATCH}, S={TRAIN_SEQ})",
         "max_abs_err": max(max(r["max_abs_err"].values()) for r in
                            ssd_bwd.values()),
         "ms": fz["ms"], "plain_ms": fz["plain_ms"],
         "bound_ms": fz["bound_ms"], "bound_by": fz["bound_by"],
         "library_ms": None, "device_ms": fz["device_ms"],
         "device_ms_train_profile": z_train["ssd_bwd_device_ms_per_call"],
         "bound_share": fz["bound_share"],
         "cuda_kernels": list(SSD_BWD_KERNELS),
         "device_ms_by_kernel": fz["device_ms_by_kernel"],
         "mamba2_780m_train": {k: fm[k] for k in (
             "ms", "device_ms", "device_ms_by_kernel", "plain_ms",
             "bound_ms", "bound_share")},
         "per": "one call at zamba2's train shape: B=4, S=4096, H=64, "
                "hd=64, N=64, Q=256; bound_ms in 3xTF32 on the tensor "
                "cores; max_abs_err: the largest over every ssd_bwd case "
                "(each held to 1e-4 of its own largest element)"})
    for r in rows:
        if r["name"].startswith("flash_attention"):
            r["launches_train"] = train["launches"][r["name"]]
            # the paths of the MoE, VLM and encdec families
            r["launches_new_paths"] = {
                **{f"serve:{a}": serve_rows[a]["launches"][r["name"]]
                   for a in (MOE_TRAIN[0], "chameleon-34b")},
                f"serve_encdec:{ENCDEC_ARCH} (one prefill)":
                    encdec["launches_prefill"][r["name"]],
                **{f"train:{a}": t["launches"][r["name"]]
                   for a, t in train_new.items()}}
        if r["name"].startswith("ssd_scan") or r["name"].startswith(
                "flash_attention"):
            # per rank a step, each layout of the train_mesh phase (on
            # each rank's heads, query rows or experts)
            r["launches_train_mesh"] = {
                k: [lp.get(r["name"], 0) for lp in m["launches_per_rank"]]
                for k, m in train_mesh.items()}
            r["launches_train_ssm"] = {a: t["launches"].get(r["name"])
                                       for a, t in train_ssm.items()}
        if r["name"] in ("flash_attention", "ssd_scan"):
            # per rank over each serve_mesh layout's traffic
            r["launches_serve_mesh"] = {
                k: [lp.get(r["name"], 0) for lp in m["launches_per_rank"]]
                for k, m in serve_mesh.items()}
    for r in rows:
        counter = {"gat_mp_fwd": "gat_mp", "memsim_evaluate": "memsim",
                   "memsim_evaluate_zoo": "memsim_zoo"}.get(r["name"],
                                                            r["name"])
        r["launches_zamba2_serve"] = serve["launches"].get(counter)
        r["launches_placement"] = placement.get(counter)
    emit({"phase_seconds": seconds, "total_s": time.perf_counter() - t_all})
    emit({"kernels": rows, "device": kind, "nvidia_smi": smi})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
