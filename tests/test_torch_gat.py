"""The port's GAT op (plain version, CPU) against the JAX Pallas kernel
run in interpret mode, as tests/test_kernels.py runs it on the CPU.
Inputs are unit normal from a numpy seed; out, m and l agree to 1e-5
(f32 sums taken in another order).  The masks include the cases the
CUDA kernels' edge lists must get right (a column no row reaches, a
row with every column set or masked, asymmetric per-batch masks, N = 1,
H = 1 and 8); the kernels themselves run only on the card, where
``chip_smoke.py`` holds them against the plain version on the same
masks.  The wrapper's launch logic is tested here with a stand-in for
the built library."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs its files in parallel workers, and
# the port's small CPU ops lose more to thread hand-offs than they gain
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.gat_mp import ops as jops  # noqa: E402
from repro.kernels.gat_mp.ref import gat_mp_ref  # noqa: E402
from repro_torch.kernels.gat_mp import ops  # noqa: E402

H, HD = 4, 32
TOL = 1e-5


def _inputs(rng, B, N, shared):
    z = rng.standard_normal((B, N, H * HD)).astype(np.float32)
    es = rng.standard_normal((B, N, H)).astype(np.float32)
    ed = rng.standard_normal((B, N, H)).astype(np.float32)
    adj = rng.random((1 if shared else B, N, N)) < 0.05
    adj |= np.eye(N, dtype=bool)
    return z, es, ed, adj


def _jax_fused(z, es, ed, adj, heads=H):
    o, m, l = jops._fused_call(heads, 128, True, jnp.asarray(z),
                               jnp.asarray(es), jnp.asarray(ed),
                               jnp.asarray(adj.astype(np.float32)))
    return np.asarray(o), np.asarray(m), np.asarray(l)


def _port(z, es, ed, adj):
    out = ops.gat_mp(torch.as_tensor(z), torch.as_tensor(es),
                     torch.as_tensor(ed), torch.as_tensor(adj))
    return [x.numpy() for x in out]


@pytest.mark.parametrize("N", [57, 130, 388])
def test_gat_matches_pallas_interpret(N):
    rng = np.random.default_rng(N)
    z, es, ed, adj = _inputs(rng, 1, N, shared=True)
    o, m, l = _port(z, es, ed, adj)
    jo, jm, jl = _jax_fused(z[0], es[0], ed[0], adj[0])
    np.testing.assert_allclose(o[0], jo, atol=TOL, rtol=0)
    np.testing.assert_allclose(m[0], jm, atol=TOL, rtol=0)
    np.testing.assert_allclose(l[0], jl, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("shared", [False, True], ids=["per-element",
                                                       "shared"])
def test_gat_batch_matches_per_element(shared):
    rng = np.random.default_rng(7)
    B, N = 3, 97
    z, es, ed, adj = _inputs(rng, B, N, shared)
    o, m, l = _port(z, es, ed, adj)
    for b in range(B):
        a = adj[0 if shared else b]
        jo, jm, jl = _jax_fused(z[b], es[b], ed[b], a)
        np.testing.assert_allclose(o[b], jo, atol=TOL, rtol=0)
        np.testing.assert_allclose(m[b], jm, atol=TOL, rtol=0)
        np.testing.assert_allclose(l[b], jl, atol=TOL, rtol=TOL)


def test_all_masked_row_averages_real_columns():
    """A row with no edge averages z over the N real columns (the dense
    reference's answer; m = -1e30 and l = N)."""
    rng = np.random.default_rng(3)
    N = 57
    z, es, ed, adj = _inputs(rng, 1, N, shared=True)
    adj[0, 5] = False
    o, m, l = _port(z, es, ed, adj)
    ref = np.asarray(gat_mp_ref(jnp.asarray(z[0]), jnp.asarray(es[0]),
                                jnp.asarray(ed[0]),
                                jnp.asarray(adj[0].astype(np.float32)),
                                heads=H))
    np.testing.assert_allclose(o[0], ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(o[0, 5], z[0].mean(0), atol=TOL, rtol=0)
    assert np.all(m[0, 5] == np.float32(-1e30)) and np.all(l[0, 5] == N)


def test_gat_rejects_bad_inputs():
    z = torch.zeros(2, 8, 128)
    e = torch.zeros(2, 8, 4)
    adj = torch.ones(1, 8, 8, dtype=torch.bool)
    with pytest.raises(ValueError, match="adj"):
        ops.gat_mp(z, e, e, torch.ones(3, 8, 8, dtype=torch.bool))
    with pytest.raises(ValueError, match="float32"):
        ops.gat_mp(z.double(), e, e, adj)
    with pytest.raises(ValueError, match="e_src"):
        ops.gat_mp(z, e[:, :4], e, adj)
    with pytest.raises(ValueError, match="mask"):
        ops.gat_mp(z, e, e, adj.float())


# ---------------------------------------------------------------- backward
# The backward against the Pallas pair's backward (``_fused_bwd``, the
# kernel ``_bwd_kernel`` in interpret mode) on the residuals of its own
# forward.  Gradients are sums of up to N products of unit-normal terms
# taken in another order, so they agree to 1e-5 of their largest element.
BWD_TOL = 1e-5


def _jax_fused_bwd(z, es, ed, adj, g, heads=H):
    args = [jnp.asarray(x) for x in (z, es, ed, adj.astype(np.float32))]
    o, m, l = jops._fused_call(heads, 128, True, *args)
    dz, des, ded, _ = jops._fused_bwd(heads, 128, True, (*args, o, m, l),
                                      jnp.asarray(g))
    return (np.array(o), np.array(m), np.array(l)), \
        (np.array(dz), np.array(des), np.array(ded))


def _port_bwd(z, es, ed, adj, m, l, o, g):
    out = ops.gat_mp_bwd(*(torch.as_tensor(x) for x in (z, es, ed, adj, m, l,
                                                         o, g)))
    return [x.numpy() for x in out]


def _close(got, want, floor=0.0):
    for a, b in zip(got, want):
        np.testing.assert_allclose(
            a, b, atol=BWD_TOL * max(np.abs(b).max(), floor), rtol=0)


@pytest.mark.parametrize("N", [57, 130, 388])
def test_gat_bwd_matches_pallas_interpret(N):
    rng = np.random.default_rng(100 + N)
    z, es, ed, adj = _inputs(rng, 1, N, shared=True)
    g = rng.standard_normal(z.shape).astype(np.float32)
    (o, m, l), want = _jax_fused_bwd(z[0], es[0], ed[0], adj[0], g[0])
    got = _port_bwd(z, es, ed, adj, m[None], l[None], o[None], g)
    _close([x[0] for x in got], want)


def test_gat_bwd_batch_matches_per_element():
    """B = 3 with one mask per batch element, as the actor's pooled
    levels give the kernel."""
    rng = np.random.default_rng(11)
    B, N = 3, 97
    z, es, ed, adj = _inputs(rng, B, N, shared=False)
    g = rng.standard_normal(z.shape).astype(np.float32)
    fwd = [_jax_fused_bwd(z[b], es[b], ed[b], adj[b], g[b])[0]
           for b in range(B)]
    o, m, l = (np.stack([f[i] for f in fwd]) for i in range(3))
    got = _port_bwd(z, es, ed, adj, m, l, o, g)
    for b in range(B):
        want = _jax_fused_bwd(z[b], es[b], ed[b], adj[b], g[b])[1]
        _close([x[b] for x in got], want)


def test_gat_bwd_all_masked_row_matches_dense_reference():
    """A row with no edge weighs every real column 1/N: its cotangent
    reaches dz of every column, and it adds nothing to de_src / de_dst.
    Held against ``jax.grad`` through the dense reference (the Pallas
    pair pads N to 128 and would average over the padded columns)."""
    import jax
    rng = np.random.default_rng(5)
    N = 57
    z, es, ed, adj = _inputs(rng, 1, N, shared=True)
    adj[0, 5] = False
    g = rng.standard_normal(z.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: gat_mp_ref(
        a, b, c, jnp.asarray(adj[0].astype(np.float32)), heads=H),
        jnp.asarray(z[0]), jnp.asarray(es[0]), jnp.asarray(ed[0]))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g[0]))]
    o, m, l = ops.gat_mp_plain(*(torch.as_tensor(x) for x in (z, es, ed,
                                                              adj)))
    got = _port_bwd(z, es, ed, adj, m.numpy(), l.numpy(), o.numpy(), g)
    _close([x[0] for x in got], want)
    # the row's cotangent alone: g / N on every column, no dpre anywhere
    g5 = np.zeros_like(g)
    g5[0, 5] = g[0, 5]
    dz, des, ded = _port_bwd(z, es, ed, adj, m.numpy(), l.numpy(),
                             o.numpy(), g5)
    np.testing.assert_allclose(dz[0], np.broadcast_to(g[0, 5] / N, dz[0].shape),
                               atol=1e-7, rtol=1e-6)
    assert not des.any() and not ded.any()


def test_gat_autograd_matches_autograd_through_plain():
    """``gat_mp`` under autograd (its ``autograd.Function``, backward
    ``gat_mp_bwd_plain``) against ``torch.autograd.grad`` through the
    dense ``gat_mp_plain``, with a shared mask holding an all-masked
    row.  Same f32 math in another order: 1e-5 of the largest element."""
    rng = np.random.default_rng(9)
    B, N = 2, 41
    z, es, ed, adj = _inputs(rng, B, N, shared=True)
    adj[0, 7] = False
    g = torch.as_tensor(rng.standard_normal(z.shape).astype(np.float32))
    ins = [torch.as_tensor(x).requires_grad_() for x in (z, es, ed)]
    mask = torch.as_tensor(adj)
    got = torch.autograd.grad(ops.gat_mp(*ins, mask)[0], ins, g)
    want = torch.autograd.grad(ops.gat_mp_plain(*ins, mask)[0], ins, g)
    _close([x.numpy() for x in got], [x.numpy() for x in want])
    # no input needs a gradient: no autograd node is made
    out = ops.gat_mp(*(x.detach() for x in ins), mask)[0]
    assert out.grad_fn is None and not out.requires_grad


# ------------------------------------------------- masks the edge lists meet
def _edge_mask(rng, kind, N, B):
    """(1 or B, N, N) mask of the named kind, every row with an edge."""
    if kind == "asymmetric":                     # one mask per element
        adj = rng.random((B, N, N)) < 0.08
        adj |= np.eye(N, dtype=bool)
        assert (adj != adj.transpose(0, 2, 1)).any()
        return adj
    adj = rng.random((1, N, N)) < 0.05
    adj |= np.eye(N, dtype=bool)
    if kind == "unreached-column":
        c = N // 2
        adj[:, :, c] = False
        adj[:, c, (c + 1) % N] = True
    elif kind == "full-row":
        adj[:, N // 3] = True
    return adj


def _cancel_scale(z, g, heads):
    """Largest sum over a head's features of |g_i| |z_j|.  At N = 1 with
    its one column set, out = z and de_src = de_dst = g . z - g . out:
    rounding noise of this size in every version."""
    B, N, D = z.shape
    gz = (np.abs(g).reshape(B, N, heads, D // heads)
          * np.abs(z).reshape(B, N, heads, D // heads))
    return gz.sum(-1).max()


EDGE_CASES = [("unreached-column", 33, 4), ("unreached-column", 130, 4),
              ("full-row", 1, 4), ("full-row", 33, 4), ("full-row", 130, 4),
              ("asymmetric", 33, 4), ("asymmetric", 130, 4),
              ("full-row", 33, 1), ("full-row", 130, 1),
              ("unreached-column", 33, 8), ("unreached-column", 130, 8)]


@pytest.mark.parametrize("kind,N,heads", EDGE_CASES,
                         ids=[f"{k}-N{n}-H{h}" for k, n, h in EDGE_CASES])
def test_gat_edge_masks_match_pallas_interpret(kind, N, heads):
    """Forward and backward of the plain version against the Pallas pair
    (interpret mode) per batch element, B = 2, at D = 32 H."""
    rng = np.random.default_rng(1000 + 10 * N + heads)
    B = 2
    adj = _edge_mask(rng, kind, N, B)
    z = rng.standard_normal((B, N, 32 * heads)).astype(np.float32)
    es = rng.standard_normal((B, N, heads)).astype(np.float32)
    ed = rng.standard_normal((B, N, heads)).astype(np.float32)
    g = rng.standard_normal(z.shape).astype(np.float32)
    o, m, l = _port(z, es, ed, adj)
    got = _port_bwd(z, es, ed, adj, m, l, o, g)
    floor = _cancel_scale(z, g, heads) if N == 1 else 0.0
    for b in range(B):
        a = adj[b if adj.shape[0] == B else 0]
        (jo, jm, jl), want = _jax_fused_bwd(z[b], es[b], ed[b], a, g[b],
                                            heads)
        np.testing.assert_allclose(o[b], jo, atol=TOL, rtol=0)
        np.testing.assert_allclose(m[b], jm, atol=TOL, rtol=0)
        np.testing.assert_allclose(l[b], jl, atol=TOL, rtol=TOL)
        _close([x[b] for x in got], want, floor)
    if kind == "unreached-column":    # no row reaches it: no gradient
        c = N // 2
        assert not got[0][:, c].any() and not got[2][:, c].any()


@pytest.mark.parametrize("N", [1, 33, 130])
def test_gat_all_masked_row_matches_dense_reference(N):
    """A row with every column masked (row 0 at N = 1, else row 5),
    forward and backward, against the dense reference and ``jax.vjp``
    through it (the Pallas pair pads columns and would average them in)."""
    import jax
    rng = np.random.default_rng(2000 + N)
    z, es, ed, adj = _inputs(rng, 1, N, shared=True)
    r = 5 if N > 5 else 0
    adj[0, r] = False
    g = rng.standard_normal(z.shape).astype(np.float32)
    o, m, l = _port(z, es, ed, adj)
    mask = jnp.asarray(adj[0].astype(np.float32))
    ref, vjp = jax.vjp(lambda a, b, c: gat_mp_ref(a, b, c, mask, heads=H),
                       jnp.asarray(z[0]), jnp.asarray(es[0]),
                       jnp.asarray(ed[0]))
    np.testing.assert_allclose(o[0], np.asarray(ref), atol=TOL, rtol=0)
    np.testing.assert_allclose(o[0, r], z[0].mean(0), atol=TOL, rtol=0)
    assert np.all(m[0, r] == np.float32(-1e30)) and np.all(l[0, r] == N)
    want = [np.asarray(x) for x in vjp(jnp.asarray(g[0]))]
    got = _port_bwd(z, es, ed, adj, m, l, o, g)
    _close([x[0] for x in got], want)


# ------------------------------------------- the wrapper, with a fake library
class _FakeLib:
    """Stands in for the built library: records each C entry called and
    returns ``err``."""

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def function(self, lib, name, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes)
            self.calls.append(name)
            return self.err
        return fn


def _no_plain(*args):
    raise AssertionError("the plain version ran for a kernel launch")


@pytest.fixture
def fake_lib(monkeypatch):
    """The wrapper's launch path on CPU tensors: a fake library, the
    stream call made without CUDA, and the plain versions forbidden."""
    from repro_torch import device as rdev

    def make(err=0):
        lib = _FakeLib(err)
        monkeypatch.setattr(ops.build, "function", lib.function)
        monkeypatch.setattr(ops.build, "cuda_call",
                            lambda fn, like, *args: fn(*args, 0))
        monkeypatch.setattr(ops, "gat_mp_plain", _no_plain)
        monkeypatch.setattr(ops, "gat_mp_bwd_plain", _no_plain)
        rdev.reset_launch_counts()
        return lib
    yield make
    rdev.reset_launch_counts()


def _small_args():
    rng = np.random.default_rng(4)
    z, es, ed, adj = _inputs(rng, 2, 9, shared=True)
    m = np.zeros_like(es)
    return [torch.as_tensor(x) for x in (z, es, ed, adj, m, m + 1, z, z)]


def test_gat_launch_is_one_c_call_counted_once(fake_lib):
    from repro_torch import device as rdev
    lib = fake_lib()
    z, es, ed, adj = _small_args()[:4]
    out, m, l = ops._launch(z, es, ed, adj)
    assert lib.calls == ["gat_mp_fwd"]
    assert out.shape == z.shape and m.shape == l.shape == es.shape
    counts = rdev.launch_counts()
    assert counts["gat_mp"] == 1 and counts["gat_mp_bwd"] == 0


def test_gat_bwd_launch_is_one_c_call_counted_once(fake_lib):
    """The backward is one launch per call: one C call, counted once,
    and no scratch beyond its three outputs."""
    from repro_torch import device as rdev
    lib = fake_lib()
    args = _small_args()
    dz, de_src, de_dst = ops._launch_bwd(*args)
    assert lib.calls == ["gat_mp_bwd"]
    assert dz.shape == args[0].shape
    assert de_src.shape == de_dst.shape == args[1].shape
    counts = rdev.launch_counts()
    assert counts["gat_mp_bwd"] == 1 and counts["gat_mp"] == 0
    ops._launch_bwd(*args)
    assert rdev.launch_counts()["gat_mp_bwd"] == 2 and len(lib.calls) == 2


@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_gat_failed_launch_raises_without_fallback(fake_lib, which):
    """A nonzero CUDA error raises RuntimeError: no plain version runs and
    nothing is counted."""
    from repro_torch import device as rdev
    lib = fake_lib(err=700)
    args = _small_args()
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        if which == "fwd":
            ops._launch(*args[:4])
        else:
            ops._launch_bwd(*args)
    assert len(lib.calls) == 1
    assert rdev.launch_counts()["gat_mp"] == 0
    assert rdev.launch_counts()["gat_mp_bwd"] == 0


def _c_params(source, name):
    """The parameter list of ``extern "C" int name(...)`` in a csrc file."""
    import pathlib
    import re
    text = (pathlib.Path(ops.__file__).resolve().parents[2] / "csrc"
            / source).read_text()
    found = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
    assert found, f"no extern \"C\" {name} in {source}"
    return [" ".join(p.split()) for p in found.group(1).split(",")]


@pytest.mark.parametrize("source,name,argtypes", [
    ("gat_mp.cu", "gat_mp_fwd", ops._ARGTYPES),
    ("gat_mp_bwd.cu", "gat_mp_bwd", ops._BWD_ARGTYPES)])
def test_gat_argtypes_match_c_declaration(source, name, argtypes):
    import ctypes
    params = _c_params(source, name)
    assert len(params) == len(argtypes)
    for param, t in zip(params, argtypes):
        want = (ctypes.c_void_p if "*" in param else ctypes.c_longlong
                if param.startswith("long long") else ctypes.c_int)
        assert param.startswith(("int ", "long long ")) or "*" in param
        assert t is want, (param, t)
