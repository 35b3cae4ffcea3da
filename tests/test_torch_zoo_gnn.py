"""The port's padded multi-graph forwards (``population_logits_zoo``,
``gnn_forward_masked`` / ``_zoo`` / ``_bucketed``, ``entropy_masked``)
against the JAX package's, on the same genomes (numpy-seeded) over a
2-bucket zoo of small graphs (resnet50 | mobilenet_v2, resnet101,
tiny_gpt): real rows within 1e-4 absolute (as the single-graph forward,
``tests/test_torch_gnn.py``), padded rows 0, and real rows bit for bit
unchanged by what the padded slots hold.  The JAX side runs its GAT on
the dense "jnp" backend; the port the plain GAT on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs its files in parallel workers, and
# the port's small CPU ops lose more to thread hand-offs than they gain
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import gnn as jgnn  # noqa: E402
from repro.graphs import bucketed as jbucketed  # noqa: E402
from repro.graphs import zoo as jzoo  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import gnn  # noqa: E402
from repro_torch.graphs import bucketed, zoo  # noqa: E402
from repro_torch.kernels.gat_mp import ops  # noqa: E402

SMALL = ["resnet50", "mobilenet_v2", "resnet101", "tiny_gpt"]
TOL = 1e-4
P = 3


@pytest.fixture(scope="module")
def setup():
    bz = bucketed.build_bucketed_zoo([zoo.WORKLOADS[n]() for n in SMALL],
                                     "auto", device="cpu")
    jbz = jbucketed.build_bucketed_zoo([jzoo.WORKLOADS[n]() for n in SMALL],
                                       "auto")
    assert bz.n_buckets == 2
    F = bz.n_features
    template = jgnn.init_gnn(jax.random.PRNGKey(0), F)
    jpop = jnp.stack([jgnn.flatten_params(jgnn.init_gnn(
        jax.random.PRNGKey(i + 1), F)) for i in range(P)])
    pop = convert.gnn_from_jax(np.asarray(jpop))
    return bz, jbz, template, jpop, pop


def test_population_logits_bucketed_match_jax(setup):
    bz, jbz, template, jpop, pop = setup
    ours = gnn.population_logits_bucketed(pop, bz.buckets)
    theirs = jax.jit(jgnn.population_logits_bucketed,
                     static_argnames="backend")(template, jbz.buckets, jpop,
                                                backend="jnp")
    for gb, a, b in zip(bz.buckets, ours, theirs):
        assert a.shape == (P, gb.n_graphs, gb.n_max, 2, 3)
        for j, n in enumerate(gb.sizes):
            np.testing.assert_allclose(a[:, j, :n].numpy(),
                                       np.asarray(b)[:, j, :n], atol=TOL,
                                       rtol=0)
            assert not a[:, j, n:].any()
        assert bool(torch.isfinite(a).all())
    # one genome: the bucketed and zoo forms are the population's row
    one = gnn.gnn_forward_bucketed(pop[1], bz.buckets)
    for a, b in zip(one, ours):
        torch.testing.assert_close(a, b[1], rtol=0, atol=1e-6)


def test_masked_forward_matches_jax_and_the_unpadded_forward(setup):
    """One graph padded to its bucket's width (mobilenet_v2, 65 nodes in
    123): JAX's ``gnn_forward_masked``, and the port's own unpadded
    forward on the real graph."""
    bz, jbz, template, jpop, pop = setup
    k, s = bz.graph_bucket[1], bz.graph_slot[1]
    gb, jgb = bz.buckets[k], jbz.buckets[k]
    n = gb.sizes[s]
    assert n < gb.n_max
    got = gnn.gnn_forward_masked(pop[0], gb.feats[s], gb.adj[s],
                                 gb.node_mask[s], n)
    want = jgnn.gnn_forward_masked(
        jgnn.unflatten_params(template, jpop[0]), jgb.feats[s], jgb.adj[s],
        jgb.node_mask[s], jgb.n_nodes[s], backend="jnp")
    np.testing.assert_allclose(got[:n].numpy(), np.asarray(want)[:n],
                               atol=TOL, rtol=0)
    assert not got[n:].any()
    g = zoo.mobilenet_v2()
    plain = gnn.gnn_forward(pop[0], torch.as_tensor(g.features()),
                            torch.as_tensor(g.adjacency() > 0))
    np.testing.assert_allclose(got[:n].numpy(), plain.numpy(), atol=TOL,
                               rtol=0)


def test_padding_content_cannot_reach_the_real_rows(setup):
    """Garbage in the padded feature rows and among the padded nodes'
    own adjacency leaves every real row bit for bit the same."""
    bz, _, _, _, pop = setup
    gb = bz.buckets[1]
    clean = gnn.population_logits_zoo(pop, gb.feats, gb.adj, gb.node_mask,
                                      gb.n_nodes)
    rng = np.random.default_rng(3)
    feats, adj = gb.feats.clone(), gb.adj.clone()
    for j, n in enumerate(gb.sizes):
        m = gb.n_max - n
        if m == 0:
            continue
        feats[j, n:] = torch.as_tensor(
            rng.standard_normal((m, feats.shape[-1])).astype(np.float32))
        adj[j, n:, n:] = torch.as_tensor(
            (rng.random((m, m)) < 0.3).astype(np.float32))
    dirty = gnn.population_logits_zoo(pop, feats, adj, gb.node_mask,
                                      gb.n_nodes)
    assert torch.equal(clean, dirty)


def test_pool_masked_keeps_the_real_top_k_with_ties_to_the_lower_index():
    """Dead slots score -inf and sort last; only the first k_real slots
    stay live; tied scores keep the lower index (as ``lax.top_k``)."""
    h = torch.zeros((2, 6, 4))
    h[:, :, 0] = torch.tensor([1.0, 3.0, 3.0, -1.0, 9.0, 0.5])
    w = torch.tensor([[1.0, 0, 0, 0]]).repeat(2, 1)
    live = torch.tensor([[1.0, 1, 1, 1, 0, 0], [1.0, 1, 1, 1, 1, 1]])
    adj = torch.ones((1, 6, 6), dtype=torch.bool)
    h_k, adj_k, idx, keep = gnn._pool_masked(
        w, h, adj, live, 4, torch.tensor([2, 3]),
        torch.zeros(2, dtype=torch.long))
    assert idx[0].tolist()[:3] == [1, 2, 0] and idx[1].tolist()[:3] == [4, 1,
                                                                      2]
    assert keep.tolist() == [[1, 1, 0, 0], [1, 1, 1, 0]]
    assert not h_k[0, 2:].any() and not adj_k[0, 2:].any()
    assert not adj_k[0, :, 2:].any() and bool(adj_k[1, :3, :3].all())


def test_entropy_masked_and_gat_shared_masks_match():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 10, 2, 3)).astype(np.float32)
    mask = np.ones((3, 10), np.float32)
    mask[0, 6:] = 0
    mask[2, 1:] = 0
    got = gnn.entropy_masked(torch.as_tensor(logits), torch.as_tensor(mask))
    want = [jgnn.entropy_masked(jnp.asarray(lg), jnp.asarray(m))
            for lg, m in zip(logits, mask)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    full = gnn.entropy_masked(torch.as_tensor(logits[1]),
                              torch.ones(10))
    torch.testing.assert_close(full, gnn.entropy(torch.as_tensor(logits[1])))
    # gat_mp's shared-mask form: element b reads mask (b // rep) % G, the
    # same as the masks materialised per element
    G, N, rep, B = 2, 9, 3, 12
    adj = torch.as_tensor(rng.random((G, N, N)) < 0.4)
    z = torch.as_tensor(rng.standard_normal((B, N, 64)).astype(np.float32))
    es, ed = (torch.as_tensor(rng.standard_normal((B, N, 2)).astype(
        np.float32)) for _ in range(2))
    full = adj[(torch.arange(B) // rep) % G]
    for a, b in zip(ops.gat_mp(z, es, ed, adj, rep),
                    ops.gat_mp(z, es, ed, full)):
        assert torch.equal(a, b)
    out, m, l = ops.gat_mp(z, es, ed, full)
    g = torch.ones_like(z)
    for a, b in zip(ops.gat_mp_bwd(z, es, ed, adj, m, l, out, g, rep),
                    ops.gat_mp_bwd(z, es, ed, full, m, l, out, g)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="dividing"):
        ops.gat_mp(z, es, ed, adj, 5)
