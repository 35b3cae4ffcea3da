"""The port's training pieces against the JAX package, piece by piece, on
the CPU: the attention backward (``flash_attention_bwd_plain`` and the
autograd route through ``flash_attention``) against ``jax.vjp`` of
``blocked_attention``, the forward's log-sum-exp against
``_flash_fwd_impl``, ``rms_norm``'s hand-written gradient, ``chunked_xent``,
int8 gradient compression, one AdamW and one Adafactor step, the
synthetic data stream, the prefetcher and ``apply_plan``.  Inputs come
from numpy seeds; each comparison states its tolerance."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs its files in parallel workers, and
# the port's small CPU ops lose more to thread hand-offs than they gain
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.training import optimizers as jopt  # noqa: E402
from repro.training import remat as jremat  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.data import pipeline as pipe  # noqa: E402
from repro_torch.distributed import compression as comp  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.launch.mesh import make_process_mesh  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.training import optimizers as opt  # noqa: E402
from repro_torch.training import remat  # noqa: E402
from repro_torch.utils.params import tree_leaves  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close(got, want, tol, what):
    """|got - want| <= tol * max|want| elementwise."""
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


# f32: both sum the same f32 products in another order.  bf16: both round
# q * scale, p and ds to bf16 at the same places; an f32 value one ulp
# apart may round the other way, so one bf16 ulp of the largest element.
GRAD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 2])
def test_flash_backward_matches_jax_vjp(dtype, causal, G):
    """S = 64 keys in 4 chunks of 16, B = 2, K = 2, h = 16."""
    td, jd = DTYPES[dtype]
    rng = np.random.default_rng(3 + G + 2 * causal)
    B, S, K, h, chunk = 2, 64, 2, 16, 16
    q, g = (rng.standard_normal((B, S, K, G, h)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.standard_normal((B, S, K, h)).astype(np.float32)
            for _ in range(2))
    out, vjp = jax.vjp(lambda a, b, c: jatt.blocked_attention(
        a, b, c, chunk=chunk, causal=causal),
        *(jnp.asarray(x).astype(jd) for x in (q, k, v)))
    want = vjp(jnp.asarray(g).astype(jd))
    tq, tk, tv = (torch.tensor(x).to(td).requires_grad_() for x in (q, k, v))
    tout = ops.flash_attention(tq, tk, tv, causal=causal, chunk=chunk)
    tout.backward(torch.tensor(g).to(td))
    close(tout, out, GRAD_TOL[dtype], "out")
    for what, a, b in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                          want):
        assert a.dtype == td
        close(a, b, GRAD_TOL[dtype], what)
    # the plain backward called directly on the forward's out and lse
    with torch.no_grad():
        o, lse = ops.flash_attention_plain(tq, tk, tv, chunk=chunk,
                                           causal=causal, return_lse=True)
        direct = ops.flash_attention_bwd(tq, tk, tv, o, lse,
                                         torch.tensor(g).to(td),
                                         causal=causal, chunk=chunk)
    for a, b in zip(direct, (tq.grad, tk.grad, tv.grad)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal,Sq,offset", [(True, 32, 0), (False, 32, 0),
                                               (True, 16, 16)])
def test_forward_lse_matches_flash_fwd_impl(dtype, causal, Sq, offset):
    """The plain forward's log-sum-exp against ``_flash_fwd_impl`` at
    the same q positions (arange(Sq) + offset): within 1e-5 (1 + |lse|),
    both f32 over the same products; out within GRAD_TOL."""
    td, jd = DTYPES[dtype]
    rng = np.random.default_rng(11)
    B, Sk, K, G, h, chunk = 2, 32, 2, 2, 32, 8
    q = rng.standard_normal((B, Sq, K, G, h)).astype(np.float32)
    k, v = (rng.standard_normal((B, Sk, K, h)).astype(np.float32)
            for _ in range(2))
    jout, jlse = jatt._flash_fwd_impl(
        chunk, causal, *(jnp.asarray(x).astype(jd) for x in (q, k, v)),
        jnp.arange(Sq) + offset)
    out, lse = ops.flash_attention_plain(
        *(torch.tensor(x).to(td) for x in (q, k, v)), chunk=chunk,
        causal=causal, q_offset=offset, return_lse=True)
    assert lse.shape == (B, K, G, Sq) and lse.dtype == torch.float32
    jl = np.asarray(jlse)
    assert np.all(np.abs(lse.numpy() - jl) <= 1e-5 * (1 + np.abs(jl)))
    close(out, jnp.moveaxis(jout, 3, 1).astype(jd), GRAD_TOL[dtype], "out")


@pytest.mark.parametrize("grad", [False, True])
def test_flash_attention_returns_lse(grad):
    """``flash_attention(..., return_lse=True)`` gives the plain
    forward's out and lse bit for bit, with and without the autograd
    route; lse carries no gradient, and out's gradient still flows."""
    rng = np.random.default_rng(12)
    q = torch.tensor(rng.standard_normal((1, 32, 2, 2, 16)),
                     dtype=torch.float32)
    k, v = (torch.tensor(rng.standard_normal((1, 32, 2, 16)),
                         dtype=torch.float32) for _ in range(2))
    want = ops.flash_attention_plain(q, k, v, chunk=8, causal=True,
                                     q_offset=0, return_lse=True)
    q.requires_grad_(grad)
    out, lse = ops.flash_attention(q, k, v, causal=True, chunk=8,
                                   return_lse=True)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
    assert out.requires_grad == grad and not lse.requires_grad
    if grad:
        out.sum().backward()
        assert q.grad is not None and bool(torch.isfinite(q.grad).all())


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rms_norm_gradient_matches_custom_vjp(dtype):
    """Gradients of x and scale against ``_rms_bwd``: f32 within 1e-5 of
    the largest element; bf16 within one bf16 ulp of it (the same
    roundings, f32 sums in another order)."""
    td, jd = DTYPES[dtype]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jy, vjp = jax.vjp(lambda a, s: jcm.rms_norm(a, s, 1e-6),
                      jnp.asarray(x).astype(jd), jnp.asarray(scale))
    jdx, jds = vjp(jnp.asarray(g).astype(jd))
    tx = torch.tensor(x).to(td).requires_grad_()
    ts = torch.tensor(scale).requires_grad_()
    y = cm.rms_norm(tx, ts, 1e-6)
    y.backward(torch.tensor(g).to(td))
    assert tx.grad.dtype == td and ts.grad.dtype == torch.float32
    close(y, jy, GRAD_TOL[dtype], "y")
    close(tx.grad, jdx, GRAD_TOL[dtype], "dx")
    close(ts.grad, jds, 1e-5 if dtype == "float32" else 2.0 ** -7, "dscale")


def test_grad_dtype_barrier_is_identity_with_cast_cotangent():
    x = torch.randn(3, 4, dtype=torch.bfloat16, requires_grad=True)
    y = cm.grad_dtype_barrier(x)
    assert torch.equal(y, x)
    y.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("tied", [True, False])
def test_chunked_xent_matches_jax(masked, tied):
    """vocab 250 padded to 256, 4 chunks of 8 tokens: loss, token count
    and the gradients of h and the (un)embedding within 1e-5 of the
    largest element (f32 logits, sums in another order)."""
    cfg = get_config("qwen3-0.6b").replace(
        vocab_size=250, d_model=16, logit_chunk=8, tie_embeddings=tied,
        dtype="float32")
    jcfg = jax_config("qwen3-0.6b").replace(
        vocab_size=250, d_model=16, logit_chunk=8, tie_embeddings=tied,
        dtype="float32")
    rng = np.random.default_rng(7 + tied)
    B, S, D, Vp = 2, 32, 16, cfg.vocab_padded
    p = {"table": (0.3 * rng.standard_normal((Vp, D))).astype(np.float32)}
    if not tied:
        p["unembed"] = (0.3 * rng.standard_normal((D, Vp))).astype(np.float32)
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    t = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.7).astype(np.float32) if masked else None

    def jloss(p_, h_):
        return jcm.chunked_xent(p_, h_, jnp.asarray(t), jcfg,
                                mask=None if mask is None
                                else jnp.asarray(mask))
    (jl, jcnt), jvjp = jax.vjp(jloss, jax.tree.map(jnp.asarray, p),
                               jnp.asarray(h))
    jdp, jdh = jvjp((jnp.float32(1.0), jnp.float32(0.0)))
    tp = {k: torch.tensor(v).requires_grad_() for k, v in p.items()}
    th = torch.tensor(h).requires_grad_()
    loss, cnt = cm.chunked_xent(tp, th, torch.tensor(t).long(), cfg,
                                mask=None if mask is None
                                else torch.tensor(mask))
    loss.backward()
    assert float(cnt) == float(jcnt)
    close(loss, jl, 1e-6, "loss")
    close(th.grad, jdh, 1e-5, "dh")
    for k in p:
        if tp[k].grad is None:          # untied: the table is not used
            assert k == "table" and not tied and not np.any(to_np(jdp[k]))
            continue
        close(tp[k].grad, jdp[k], 1e-5, f"d{k}")


@pytest.mark.parametrize("shape,dtype", [((1000,), "float32"),
                                         ((3, 256), "float32"),
                                         ((17, 33), "bfloat16"),
                                         ((100,), "float32")])
def test_compress_decompress_bit_equal(shape, dtype):
    """Bit-equal: the same f32 divisions and half-to-even rounding; a
    tensor of fewer than 256 values passes through."""
    td, jd = DTYPES[dtype]
    x = (np.random.default_rng(2).standard_normal(shape) * 3).astype(
        np.float32)
    want = jcomp.compress_decompress(jnp.asarray(x).astype(jd))
    got = comp.compress_decompress(torch.tensor(x).to(td))
    assert got.dtype == td
    assert np.array_equal(to_np(got), to_np(want))


def test_error_feedback_matches_jax():
    """Two rounds of ``compress_with_error_feedback`` on a tree (a leaf
    below the block size passes through): compressed grads and residuals
    bit-equal."""
    rng = np.random.default_rng(4)
    tree = {"a": rng.standard_normal((40, 30)).astype(np.float32),
            "b": {"c": rng.standard_normal(17).astype(np.float32)}}
    jef = jcomp.init_error_feedback(jax.tree.map(jnp.asarray, tree))
    ef = comp.init_error_feedback({"a": torch.tensor(tree["a"]),
                                   "b": {"c": torch.tensor(tree["b"]["c"])}})
    for _ in range(2):
        jg, jef = jcomp.compress_with_error_feedback(
            jax.tree.map(jnp.asarray, tree), jef)
        g, ef = comp.compress_with_error_feedback(
            {"a": torch.tensor(tree["a"]),
             "b": {"c": torch.tensor(tree["b"]["c"])}}, ef)
        for path, want in jax.tree_util.tree_leaves_with_path(jg):
            name = ".".join(p.key for p in path)
            assert np.array_equal(to_np(dict(tree_leaves(g))[name]), to_np(want))
        for path, want in jax.tree_util.tree_leaves_with_path(jef):
            name = ".".join(p.key for p in path)
            assert np.array_equal(to_np(dict(tree_leaves(ef))[name]),
                                  to_np(want))


def _opt_tree(rng):
    """Leaves of the kinds a model has: a factored matrix (both dims >=
    128), a stacked (L, D, F) weight, a vector, a small matrix, and a
    vector whose gradients the test scales to the size of AdamW's eps."""
    return {"w": (0.05 * rng.standard_normal((128, 160))).astype(np.float32),
            "layers": {"k": (0.05 * rng.standard_normal((2, 128, 144))
                             ).astype(np.float32),
                       "scale": (1 + 0.1 * rng.standard_normal(32)
                                 ).astype(np.float32)},
            "b": (0.05 * rng.standard_normal((8, 12))).astype(np.float32),
            "tiny": (0.05 * rng.standard_normal(64)).astype(np.float32)}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_steps_match_jax(name):
    """Three steps from zero state on the same params and gradients (the
    gradients large enough that the global-norm clip acts; the "tiny"
    leaf's about 4e-9 after the clip, where AdamW's eps of 1e-8 sets the
    step).  Each parameter's movement p_after - p_before against JAX's,
    per element, within 1e-4 of the summed learning rate (the whole
    movement is about that sum) plus one f32 spacing of the parameter per
    step (each step rounds p once, and updates 1e-7 apart may round to
    neighbouring floats); every state leaf within 1e-5 of its largest
    element; step counts equal."""
    rng = np.random.default_rng(8)
    params = _opt_tree(rng)
    grads = [jax.tree.map(lambda a: (rng.standard_normal(a.shape)
                                     ).astype(np.float32), params)
             for _ in range(3)]
    for g in grads:
        g["tiny"] *= np.float32(1e-6)
    jcfg, jinit, jupdate = jopt.make_optimizer(name)
    cfg, init, update = opt.make_optimizer(name)
    jp = jax.tree.map(jnp.asarray, params)
    js = jinit(jp)
    tp = convert.lm_params_from_jax(params)
    ts = init(tp)
    lr_sum = 0.0
    for g in grads:
        jp, js, jm = jupdate(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, tm = update(convert.opt_state_from_jax(g), ts, tp)
        close(tm["grad_norm"], jm["grad_norm"], 1e-6, "grad_norm")
        close(tm["lr"], jm["lr"], 1e-7, "lr")
        lr_sum += float(jm["lr"])
    want = dict(tree_leaves(jax.tree.map(np.asarray, jp)))
    for k, before in tree_leaves(params):
        moved = want[k].astype(np.float64) - before
        got = to_np(dict(tree_leaves(tp))[k]).astype(np.float64) - before
        tol = 1e-4 * lr_sum + len(grads) * np.spacing(np.abs(want[k]))
        assert np.all(np.abs(got - moved) <= tol), (
            k, np.abs(got - moved).max(), np.abs(moved).max())
    jstate = dict(tree_leaves(jax.tree.map(np.asarray, js)))
    tstate = dict(tree_leaves(ts))
    assert set(jstate) == set(tstate)
    for k, want_v in jstate.items():
        if k == "step":
            assert int(tstate[k]) == int(want_v) == 3
            assert tstate[k].dtype == torch.int32
        else:
            close(tstate[k], want_v, 1e-5, k)
    back = convert.opt_state_to_jax(ts)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, js))


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 2)])
def test_synthetic_lm_batches_bit_equal(seed, step):
    src = pipe.SyntheticLM(151936, 64, 3, seed=seed)
    ref = jpipe.SyntheticLM(151936, 64, 3, seed=seed)
    got, want = src.batch_at(step), ref.batch_at(step)
    for k in ("tokens", "labels"):
        assert np.array_equal(got[k], want[k])
    dev = pipe.device_batch(got, "cpu")
    assert dev["tokens"].dtype == torch.int64
    assert np.array_equal(dev["labels"].numpy(), want["labels"])
    # a world of one process: its block is every row
    mesh = make_process_mesh((1, 1), ("data", "model"), "cpu")
    one = pipe.device_batch(got, "cpu", mesh, ("data",))
    for k in ("tokens", "labels"):
        assert torch.equal(one[k], dev[k])


def test_token_file_batches_equal_jax(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(1).integers(0, 60000, 3000).astype(
        np.uint16).tofile(path)
    src = pipe.TokenFile(str(path), 1000, 31, 4)
    ref = jpipe.TokenFile(str(path), 1000, 31, 4)
    assert src.n_batches == ref.n_batches == 23
    for step in (0, 5, 30):
        got, want = src.batch_at(step), ref.batch_at(step)
        assert all(np.array_equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("start", [0, 5])
def test_prefetcher_order_and_resume(start):
    """Batches come in step order from ``start`` (a resumed run), each
    equal to ``batch_at``; ``step`` follows; close stops the thread."""
    src = pipe.SyntheticLM(1000, 16, 2, seed=1)
    pf = pipe.Prefetcher(src, start_step=start, depth=2)
    try:
        for want in range(start, start + 4):
            s, b = pf.next(timeout=30)
            assert s == want and pf.step == want + 1
            assert np.array_equal(b["tokens"], src.batch_at(want)["tokens"])
    finally:
        pf.close()
    pf._t.join(10)
    assert not pf._t.is_alive()
    assert pipe.DataState.from_dict(pipe.DataState(7).to_dict()).step == 7


@pytest.mark.parametrize("arch,remat_", [("qwen3-0.6b", "full"),
                                         ("llama3-405b", "full"),
                                         ("granite-3-8b", "dots"),
                                         ("qwen3-moe-30b-a3b", "full")])
def test_apply_plan_matches_jax(arch, remat_):
    plan = {"derived": {"act_resident_frac": 0.25,
                        "suggested_remat": remat_}}
    got = remat.apply_plan(get_config(arch), plan)
    want = jremat.apply_plan(jax_config(arch), plan)
    assert (got.remat, got.scan_block) == (want.remat, want.scan_block)
    assert remat.knobs_from_plan(plan) == jremat.knobs_from_plan(plan)
