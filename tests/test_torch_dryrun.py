"""The port's dry run (``launch/dryrun.py``, ``launch/programs.py``
``build_cell``, ``distributed/cost.py``) on meta tensors, against the
JAX package on the CPU.

The port's dry runs run in one subprocess (``_torch_dryrun_worker.py``):
the fake process group is process-global.  JAX's side is compiled here
on one device with no plan (``make_train_step(model, cfg, None)``, the
model's ``decode_step``), at the smoke configs, B 2, S 64:

- the argument bytes of every family's train and decode cell equal
  ``memory_analysis().argument_size_in_bytes`` exactly (the decode step
  jitted with ``keep_unused``: jit otherwise drops seamless's encoder
  leaves, which a decode step does not read but a server holds);
- the train step's FLOPs lie within 2 % of the trip-aware
  ``hlo_cost.analyze_cost`` count.  The moe and encdec families need no
  op taken out: their counts, like the others', lie within 1.2 % (the
  port's from ``FlopCounterMode``, which counts matrix products only, as
  ``analyze_cost`` counts ``dot``s; the gap is the port's below JAX's in
  every family, measured -0.4 % to -1.1 %);
- the ring formulas are ``hlo_analysis._per_device_bytes``;
- qwen3-0.6b's train step at (4, 1), B 4, S 4096, full width counts 393
  all-gathers and 197 reduce-scatters, the largest gather 622.9 MB (the
  padded embedding in f32): what run T4 read on four H100s, and
  ``chip_smoke.step_collectives``;
- a smoke qwen3 step on a (2, 2, 2) pod/data/model mesh completes
  (``tests/test_distributed.py::test_multi_pod_lowering_small``'s
  counterpart), its config's 4 microbatches over a rank's 2 rows (the
  sharded step caps them at the rows, as the 512-card mesh's MoE cells
  need);
- a cell that fails makes ``main`` return 1 and is named in the log.
"""
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs its files in parallel workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.configs.registry import smoke_config as jax_smoke  # noqa: E402
from repro.distributed import hlo_analysis  # noqa: E402
from repro.distributed.hlo_cost import analyze_cost  # noqa: E402
from repro.models.zoo import get_model as jax_model  # noqa: E402
from repro.training.train_step import make_train_step  # noqa: E402
from repro.utils.params import abstract_params  # noqa: E402
from repro_torch.distributed import cost  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import _torch_dryrun_worker as W  # noqa: E402

FLOP_TOL = 0.02


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "out.json"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-W", "ignore",
                           os.path.join(HERE, "_torch_dryrun_worker.py"),
                           str(out)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


def jax_cell(arch, kind):
    """(argument bytes, trip-aware FLOPs) of JAX's smoke cell on one
    device, no plan."""
    cfg = jax_smoke(jax_config(arch))
    model = jax_model(cfg)
    p_abs = abstract_params(model.param_defs())
    B, S = W.SMOKE_B, W.SMOKE_S
    i32 = jnp.int32
    if kind == "train":
        step, opt_init, _ = make_train_step(model, cfg, None)
        tok = jax.ShapeDtypeStruct((B, S), i32)
        batch = {"tokens": tok, "labels": tok}
        if cfg.family == "encdec":
            batch["enc_emb"] = jax.ShapeDtypeStruct((B, S, cfg.d_model),
                                                    jnp.bfloat16)
        lowered = jax.jit(step).lower(p_abs, jax.eval_shape(opt_init, p_abs),
                                      batch, jax.ShapeDtypeStruct((), i32))
    else:
        lowered = jax.jit(model.decode_step, keep_unused=True).lower(
            p_abs, model.cache_struct(B, S), jax.ShapeDtypeStruct((B,), i32),
            jax.ShapeDtypeStruct((), i32))
    compiled = lowered.compile()
    return (compiled.memory_analysis().argument_size_in_bytes,
            analyze_cost(compiled.as_text())["flops"])


@pytest.mark.parametrize("family", sorted(W.FAMILIES))
def test_argument_bytes_and_flops_match_jax(port, family):
    arch = W.FAMILIES[family]
    for kind in ("train", "decode"):
        mine = port["smoke"][f"{family}:{kind}"]
        args, flops = jax_cell(arch, kind)
        assert mine["argument_bytes"] == args, (kind, mine["argument_bytes"],
                                                args)
        if kind == "train":
            assert abs(mine["flops"] - flops) <= FLOP_TOL * flops, \
                (mine["flops"], flops)


@pytest.mark.parametrize("kind", ["all-gather", "reduce-scatter",
                                  "all-reduce", "all-to-all",
                                  "collective-permute"])
@pytest.mark.parametrize("n", [2, 4, 16, 256])
def test_ring_formulas_are_jax(kind, n):
    for nbytes in (4, 1000, 622854144):
        assert cost._per_device_bytes(kind, nbytes, n) == \
            hlo_analysis._per_device_bytes(kind, nbytes, n)


def test_fsdp_collectives_of_the_4x1_step(port):
    """393 all-gathers, 197 reduce-scatters, the largest gather the
    padded (152064, 1024) f32 embedding: run T4's reading on four H100s
    and ``chip_smoke.step_collectives``'; the rest are all-reduces (the
    loss and the global norm's sums)."""
    m = port["mesh_4x1"]
    coll, want = m["collectives"], m["step_collectives"]
    assert (coll["all_gather"], coll["reduce_scatter"]) == (393, 197)
    assert (want["all_gather"], want["reduce_scatter"]) == (393, 197)
    assert coll["all_gather_max_bytes"] == 622854144 == \
        4 * want["all_gather_max_numel"]
    assert set(coll["by_kind"]) == {"all-gather", "reduce-scatter",
                                    "all-reduce"}
    # each rank holds its blocks of the f32 parameters and of AdamW's two
    # moments (make_specs' layout on a (4, 1) mesh), one row of tokens and
    # labels, and two int32 steps (the train step's and AdamW's)
    import numpy as np
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.rules import make_plan
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.programs import local_shape
    from repro_torch.models.zoo import get_model
    from repro_torch.utils.params import make_specs, tree_leaves
    cfg = get_config("qwen3-0.6b")
    mesh = Mesh(("data", "model"), np.empty((4, 1), dtype=object))
    plan = make_plan(cfg, mesh, ShapeCfg("t", W.MESH_S, W.MESH_B, "train"))
    defs = get_model(cfg).param_defs()
    specs = dict(tree_leaves(make_specs(defs, plan.rules)))
    local = sum(math.prod(local_shape(d.shape, specs[k], mesh))
                for k, d in tree_leaves(defs))
    assert m["argument_bytes"] == 3 * 4 * local + 2 * 4 * W.MESH_S + 8
    assert m["flops"] > 0 and m["peak_temp_bytes"] > 0


def test_pod_mesh_step_completes(port):
    pod = port["pod"]
    assert pod["batch_axes"] == ["pod", "data"]
    assert pod["flops"] > 0
    assert pod["collectives"]["all_gather"] > 0
    # one row a microbatch: 2 microbatches x 2 layers of attention
    assert pod["kernel_ops"]["flash_attention"] == 2 * 2


def test_failing_cell_makes_main_return_1(port):
    f = port["failing"]
    assert f["rc"] == 1
    assert "FAIL qwen3-0.6b x decode_32k multi_pod=True" in f["log"]
    assert "1 ok, 1 failed" in f["log"]
    assert f["files"] == ["qwen3-0.6b__decode_32k__16x16.json"]


def _plain_flops(fn):
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def test_kernel_wrappers_on_meta_count_one_op_each():
    """On meta tensors each wrapper gives its outputs' shapes, counts as
    ONE op of its inputs' and outputs' bytes, forward and backward, and
    counts the FLOPs its plain version computes on the CPU."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.gat_mp import ops as gops
    from repro_torch.kernels.ssd_scan import ops as sops

    def meta(*shape, dtype=torch.float32, grad=True):
        return torch.empty(shape, dtype=dtype, device="meta",
                           requires_grad=grad)

    def cpu(*shape, dtype=torch.float32):
        return torch.randn(shape).to(dtype)

    # GAT: z (B, N, D), e (B, N, H), one shared mask
    z, es, ed = meta(3, 40, 128), meta(3, 40, 4), meta(3, 40, 4)
    adj = torch.empty((1, 40, 40), dtype=torch.bool, device="meta")
    with cost.count_step() as c:
        out, m, l = gops.gat_mp(z, es, ed, adj)
        fwd_bytes = c.hbm_bytes
        torch.autograd.grad(out.sum(), (z, es, ed))
    s = c.summary()
    assert out.shape == z.shape and m.shape == l.shape == es.shape
    assert s["kernel_ops"] == {"gat_mp": 1, "gat_mp_bwd": 1}
    assert fwd_bytes == _nbytes(z, es, ed, adj, out, m, l)
    zc, ec, dc = cpu(3, 40, 128), cpu(3, 40, 4), cpu(3, 40, 4)
    ac = torch.ones((1, 40, 40), dtype=torch.bool)
    oc, mc, lc = gops.gat_mp_plain(zc, ec, dc, ac)
    want = _plain_flops(lambda: gops.gat_mp_plain(zc, ec, dc, ac)) + \
        _plain_flops(lambda: gops.gat_mp_bwd_plain(zc, ec, dc, ac, mc, lc,
                                                   oc, torch.ones_like(oc)))
    assert s["flops"] == want

    # attention: q (B, S, K, G, h), bf16, causal, 2 KV chunks
    q, k, v = (meta(2, 64, 2, 2, 32, dtype=torch.bfloat16),
               meta(2, 64, 2, 32, dtype=torch.bfloat16),
               meta(2, 64, 2, 32, dtype=torch.bfloat16))
    with cost.count_step() as c:
        o = fops.flash_attention(q, k, v, chunk=32)
        torch.autograd.grad(o.float().sum(), (q, k, v))
    s = c.summary()
    assert o.shape == q.shape and o.dtype == torch.bfloat16
    assert s["kernel_ops"] == {"flash_attention": 1,
                               "flash_attention_bwd": 1}
    qc, kc, vc = (cpu(2, 64, 2, 2, 32, dtype=torch.bfloat16),
                  cpu(2, 64, 2, 32, dtype=torch.bfloat16),
                  cpu(2, 64, 2, 32, dtype=torch.bfloat16))
    oc, lse = fops.flash_attention_plain(qc, kc, vc, chunk=32, causal=True,
                                         return_lse=True)
    want = _plain_flops(lambda: fops.flash_attention_plain(
        qc, kc, vc, chunk=32, causal=True, return_lse=True)) + \
        _plain_flops(lambda: fops.flash_attention_bwd_plain(
            qc, kc, vc, oc, lse, torch.ones_like(oc), chunk=32, causal=True))
    assert s["flops"] == want

    # SSD scan: x (B, S, H, hd), 2 chunks, forward and its gradient
    x, dt, A = meta(2, 32, 4, 16), meta(2, 32, 4), meta(4)
    Bm, Cm = meta(2, 32, 8), meta(2, 32, 8)
    with cost.count_step() as c:
        y, final = sops.ssd_scan(x, dt, A, Bm, Cm, chunk=16)
        torch.autograd.grad(y.sum(), (x, dt, A, Bm, Cm))
    s = c.summary()
    assert y.shape == x.shape and final.shape == (2, 4, 8, 16)
    assert s["kernel_ops"] == {"ssd_scan": 1, "ssd_scan_bwd": 1}
    with torch.no_grad():
        y2, _ = sops.ssd_scan(x.detach(), dt.detach(), A.detach(),
                              Bm.detach(), Cm.detach(), chunk=16)
    assert y2.shape == x.shape
