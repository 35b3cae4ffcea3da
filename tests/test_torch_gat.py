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
