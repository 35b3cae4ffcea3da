"""The port's GAT op (plain version, CPU) against the JAX Pallas kernel
run in interpret mode, as tests/test_kernels.py runs it on the CPU.
Inputs are unit normal from a numpy seed; out, m and l agree to 1e-5
(f32 sums taken in another order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

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


def _jax_fused(z, es, ed, adj):
    o, m, l = jops._fused_call(H, 128, True, jnp.asarray(z), jnp.asarray(es),
                               jnp.asarray(ed),
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


def _jax_fused_bwd(z, es, ed, adj, g):
    args = [jnp.asarray(x) for x in (z, es, ed, adj.astype(np.float32))]
    o, m, l = jops._fused_call(H, 128, True, *args)
    dz, des, ded, _ = jops._fused_bwd(H, 128, True, (*args, o, m, l),
                                      jnp.asarray(g))
    return (np.array(o), np.array(m), np.array(l)), \
        (np.array(dz), np.array(des), np.array(ded))


def _port_bwd(z, es, ed, adj, m, l, o, g):
    out = ops.gat_mp_bwd(*(torch.as_tensor(x) for x in (z, es, ed, adj, m, l,
                                                         o, g)))
    return [x.numpy() for x in out]


def _close(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=BWD_TOL * np.abs(b).max(),
                                   rtol=0)


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
