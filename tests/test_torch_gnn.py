"""The port's Graph U-Net population forward (plain GAT, CPU) against the
JAX package's ``gnn.population_logits(..., backend="jnp")``, on genomes
made by the JAX initializer and carried over by ``repro_torch.convert``.
The pooled node sets must agree exactly; logits agree to 1e-4 abs (four
chained attention levels amplify f32 rounding)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs its files in parallel workers, and
# the port's small CPU ops lose more to thread hand-offs than they gain
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import boltzmann as jbz  # noqa: E402
from repro.core import gnn as jgnn  # noqa: E402
from repro.graphs import zoo as jzoo  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import boltzmann as bz, gnn, params  # noqa: E402
from repro_torch.graphs import zoo  # noqa: E402

P = 4
LOGIT_TOL = 1e-4


def _jax_population(n_features, seed=0, n=P):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    trees = [jgnn.init_gnn(k, n_features) for k in keys]
    return trees, jnp.stack([jgnn.flatten_params(t) for t in trees])


def _jax_pool_indices(tree, feats, adj):
    """The pooled index sets of one genome, level by level, through the
    JAX package's own functions."""
    n = feats.shape[0]
    k1, k2 = max(2, n // 2), max(2, n // 4)
    h = jnp.tanh(feats @ tree["inp"])
    h = jgnn._gat(tree["gat0"], h, adj > 0, "jnp")
    h1, a1, i1 = jgnn._pool(tree["pool1"], h, adj, k1)
    h1 = jgnn._gat(tree["gat1"], h1, a1 > 0, "jnp")
    _, _, i2 = jgnn._pool(tree["pool2"], h1, a1, k2)
    return np.asarray(i1), np.asarray(i2)


def test_spec_is_jax_leaf_order():
    tree = jgnn.init_gnn(jax.random.PRNGKey(0), 19)
    paths = [".".join(str(k.key) for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert paths == [name for name, _, _ in params.SPEC]
    assert [tuple(x.shape) for x in jax.tree.leaves(tree)] == \
        [shape for _, shape, _ in params.SPEC]
    assert params.V == 87040 == jgnn.flatten_params(tree).shape[0]


def test_convert_round_trip():
    trees, flat = _jax_population(19, n=2)
    vec = convert.gnn_from_jax(jax.tree.map(np.asarray, trees[0]))
    np.testing.assert_array_equal(vec.numpy(), np.asarray(flat[0]))
    pop = convert.gnn_from_jax(np.asarray(flat))
    assert pop.shape == (2, params.V)
    back = convert.gnn_to_jax(vec, tree=True)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(trees[0])):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(
        np.asarray(jgnn.unflatten_params(trees[0], convert.gnn_to_jax(vec))
                   ["gat2"]["w"]),
        params.unflatten(pop)["gat2.w"][0].numpy())
    # unflatten hands out views of the population, not copies
    views = params.unflatten(pop)
    views["pool2"][1, 0] = 123.0
    assert float(pop[1, params.V - 128]) == 123.0
    # Boltzmann flats share the JAX encoding
    b = jbz.init_boltzmann(jax.random.PRNGKey(1), 57)
    jflat = np.asarray(jbz.to_flat(b.prior, b.log_t))
    tflat = convert.boltzmann_from_jax(jflat, 57)
    tb = bz.from_flat(tflat, 57)
    np.testing.assert_array_equal(tb.prior.numpy(), np.asarray(b.prior))
    np.testing.assert_array_equal(convert.boltzmann_to_jax(tflat), jflat)
    np.testing.assert_allclose(
        bz.boltzmann_logits(tb).numpy(),
        np.asarray(jbz.boltzmann_logits(b)), rtol=1e-6, atol=0)
    with pytest.raises(ValueError):
        convert.boltzmann_from_jax(jflat, 58)


def test_init_gnn_scales():
    g = torch.Generator().manual_seed(0)
    pop = torch.stack([params.init_gnn(g, 19) for _ in range(64)])
    p = params.unflatten(pop)
    assert float(p["gat0.b"].abs().max()) == 0.0
    assert float(p["out_b1"].abs().max()) == 0.0
    assert float(p["gat1.w"].std()) == pytest.approx(1 / 128 ** 0.5, rel=0.02)
    assert float(p["inp"].std()) == pytest.approx(1 / 19 ** 0.5, rel=0.05)
    assert float(p["gat3.a_src"].std()) == pytest.approx(0.5, rel=0.05)
    assert float(p["pool1"].std()) == pytest.approx(1.0, rel=0.05)


@pytest.mark.parametrize("name", ["resnet50", "bert"])
def test_population_logits_match_jax(name):
    g, jg = zoo.WORKLOADS[name](), jzoo.WORKLOADS[name]()
    feats_np, adj_np = jg.features(), jg.adjacency()
    trees, flat = _jax_population(feats_np.shape[1], seed=len(name))
    pop = convert.gnn_from_jax(np.asarray(flat))
    feats = torch.as_tensor(g.features())
    adj = torch.as_tensor(g.adjacency() > 0)
    logits, (i1, i2) = gnn.population_forward(pop, feats, adj)
    for b, tree in enumerate(trees):
        j1, j2 = _jax_pool_indices(tree, jnp.asarray(feats_np),
                                   jnp.asarray(adj_np))
        # the kept node SETS agree; the order within a set may differ
        # where two scores sit one rounding apart at tanh's saturation
        # (each level is permutation-equivariant, so logits still agree)
        np.testing.assert_array_equal(np.sort(i1[b].numpy()), np.sort(j1))
        np.testing.assert_array_equal(np.sort(i2[b].numpy()), np.sort(j2))
    jlogits = jax.jit(jgnn.population_logits, static_argnames="backend")(
        trees[0], jnp.asarray(feats_np), jnp.asarray(adj_np), flat,
        backend="jnp")
    assert logits.shape == (P, g.n, 2, 3)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=LOGIT_TOL, rtol=0)
    # one genome through gnn_forward gives the same row
    np.testing.assert_allclose(gnn.gnn_forward(pop[2], feats, adj).numpy(),
                               logits[2].numpy(), atol=1e-6, rtol=0)


def test_pool_breaks_ties_by_lower_index():
    h = torch.zeros(1, 6, 4)
    h[0, :, 0] = torch.tensor([5.0, 9.0, 5.0, 9.0, 9.0, -1.0])
    w = torch.tensor([[1.0, 0.0, 0.0, 0.0]])
    adj = torch.eye(6, dtype=torch.bool)[None]
    _, _, idx = gnn._pool(w, h, adj, 4)      # tanh saturates: ties at 1.0
    assert idx[0].tolist() == [1, 3, 4, 0]
    _, _, jidx = jgnn._pool(jnp.asarray(w[0].numpy()),
                            jnp.asarray(h[0].numpy()),
                            jnp.asarray(adj[0].numpy()), 4)
    assert np.asarray(jidx).tolist() == idx[0].tolist()


def test_action_helpers_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((57, 2, 3)).astype(np.float32)
    acts = rng.integers(0, 3, (57, 2)).astype(np.int32)
    tl, ta = torch.as_tensor(logits), torch.as_tensor(acts)
    assert gnn.greedy_actions(tl).numpy().tolist() == \
        np.asarray(jgnn.greedy_actions(jnp.asarray(logits))).tolist()
    assert float(gnn.log_prob(tl, ta)) == pytest.approx(
        float(jgnn.log_prob(jnp.asarray(logits), jnp.asarray(acts))),
        rel=1e-5)
    assert float(gnn.entropy(tl)) == pytest.approx(
        float(jgnn.entropy(jnp.asarray(logits))), rel=1e-5)
    # jax.random.categorical is the Gumbel-max argmax of its own draws
    key = jax.random.PRNGKey(4)
    gum = np.array(jax.random.gumbel(key, logits.shape))
    assert gnn.sample_actions(tl, torch.as_tensor(gum)).numpy().tolist() == \
        np.asarray(jgnn.sample_actions(key, jnp.asarray(logits))).tolist()
