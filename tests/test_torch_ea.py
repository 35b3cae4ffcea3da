"""The port's EA step against JAX ``ea.evolve`` on the same populations,
fitness and random draws.  ``jax_evolve_draws`` reproduces, from the JAX
key, every draw ``_evolve_core`` makes (``keys = split(key, 12)`` and
the per-child splits of ``src/repro/core/ea.py``) and hands them to the
port.  Elite rows are bit-equal; the other rows agree to 1e-6."""
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs its files in parallel workers, and
# the port's small CPU ops lose more to thread hand-offs than they gain
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import boltzmann as jbz  # noqa: E402
from repro.core import ea as jea  # noqa: E402
from repro_torch.core import boltzmann as bz, ea  # noqa: E402
from repro_torch.core import params  # noqa: E402

CFG = dict(tournament_k=3, crossover_prob=0.7, mut_prob=0.9, mut_frac=0.1,
           mut_std=0.1)
TOL = 1e-6
# the JAX step, compiled once per configuration
_jax_evolve = jax.jit(jea.evolve, static_argnames=(
    "n_nodes", "e_g", "e_b", "tournament_k", "crossover_prob", "mut_prob",
    "mut_frac", "mut_std", "n_g", "n_b"))


def _t(x):
    return torch.tensor(np.asarray(x))


@partial(jax.jit, static_argnames=("n_g", "n_b", "e_g", "e_b",
                                   "genome_size", "n_nodes", "k"))
def _draw_arrays(key, *, n_g, n_b, e_g, e_b, genome_size, n_nodes, k):
    """Every draw of JAX ``_evolve_core`` for ``key``, in one program."""
    keys = jax.random.split(key, 12)
    out = {}
    nc = n_g - e_g
    if n_g and nc:
        ck = jax.random.split(keys[2], nc)
        mut = jax.vmap(lambda kk: jax.random.split(kk, 3))(
            jax.random.split(keys[4], nc))
        out["g"] = (
            jax.random.randint(keys[0], (nc, k), 0, n_g),
            jax.random.randint(keys[1], (nc,), 0, e_g),
            jax.vmap(lambda kk: jax.random.randint(
                kk, (), 1, genome_size))(ck),
            jax.random.uniform(keys[3], (nc,)),
            jax.vmap(jax.random.uniform)(mut[:, 0]),
            jax.vmap(lambda kk: jax.random.uniform(
                kk, (genome_size,)))(mut[:, 1]),
            jax.vmap(lambda kk: jax.random.normal(
                kk, (genome_size,)))(mut[:, 2]),
            jax.random.uniform(keys[5], (nc,)))
    nc = n_b - e_b
    if n_b and nc:
        n_prior = jbz.prior_size(n_nodes)
        width = jbz.flat_size(n_nodes)
        pool = ea.elite_pool_size(n_g, e_g, e_b)
        mate = (None,) * 4
        if pool:
            ck = jax.random.split(keys[8], nc)
            if n_g and e_g:
                ks, kc = jax.vmap(jax.random.split)(ck).transpose(1, 0, 2)
                seed = jax.vmap(lambda kk: jax.random.normal(
                    kk, (n_nodes, 2)))(ks)
            else:
                kc, seed = ck, jnp.zeros((nc, n_nodes, 2))
            mate = (jax.random.randint(keys[7], (nc,), 0, pool), seed,
                    jax.vmap(lambda kk: jax.random.randint(
                        kk, (), 1, width))(kc),
                    jax.random.uniform(keys[9], (nc,)))
        kp, kt, mp, mt = jax.vmap(lambda kk: jax.random.split(kk, 4))(
            jax.random.split(keys[10], nc)).transpose(1, 0, 2)
        out["b"] = (
            jax.random.randint(keys[6], (nc, k), 0, n_b), *mate,
            jax.vmap(lambda kk: jax.random.normal(kk, (n_prior,)))(kp),
            jax.vmap(lambda kk: jax.random.uniform(kk, (n_prior,)))(mp),
            jax.vmap(lambda kk: jax.random.normal(kk, (2 * n_nodes,)))(kt),
            jax.vmap(lambda kk: jax.random.uniform(kk, (2 * n_nodes,)))(mt),
            jax.random.uniform(keys[11], (nc,)))
    return out


def _torch_draws(arrays):
    return [None if x is None else
            (_t(x).long() if np.issubdtype(np.asarray(x).dtype, np.integer)
             else _t(x)) for x in arrays]


def jax_evolve_draws(key, *, n_g, n_b, e_g, e_b, genome_size, n_nodes,
                     tournament_k):
    """The draws of JAX ``_evolve_core`` (single device, unpadded) for
    ``key`` -- ``keys = split(key, 12)`` and the per-child splits of
    ``src/repro/core/ea.py`` -- as the port's ``EvolveDraws``."""
    arr = _draw_arrays(key, n_g=n_g, n_b=n_b, e_g=e_g, e_b=e_b,
                       genome_size=genome_size, n_nodes=n_nodes,
                       k=tournament_k)
    return ea.EvolveDraws(
        ea.GnnDraws(*_torch_draws(arr["g"])) if "g" in arr else None,
        ea.BoltzDraws(*_torch_draws(arr["b"])) if "b" in arr else None)


def _populations(rng, n_g, n_b, n_nodes, width):
    gnn_pop = (0.1 * rng.standard_normal((n_g, width))).astype(np.float32)
    bz_pop = np.stack([np.asarray(jbz.to_flat(*jbz.init_boltzmann(
        jax.random.PRNGKey(10 + i), n_nodes))) for i in range(n_b)])
    # rounded fitness: ties exercise the stable ranking and the
    # first-maximum tournament
    fit_g = np.round(rng.standard_normal(n_g), 1).astype(np.float32)
    fit_b = np.round(rng.standard_normal(n_b), 1).astype(np.float32)
    logits = rng.standard_normal((n_g, n_nodes, 2, 3)).astype(np.float32)
    return gnn_pop, fit_g, bz_pop, fit_b, logits


@pytest.mark.parametrize("n_g,n_b,e_g,e_b,width", [
    (16, 4, 3, 1, params.V),    # the EGRLConfig defaults, full genome
    (6, 3, 2, 0, 999),          # no Boltzmann elite: the mate is the child
    (0, 4, 0, 2, 999),          # Boltzmann only: mates are Boltzmann elites
])
def test_evolve_matches_jax(n_g, n_b, e_g, e_b, width):
    n_nodes = 57
    rng = np.random.default_rng(n_g + 10 * n_b)
    gnn_pop, fit_g, bz_pop, fit_b, logits = _populations(rng, n_g, n_b,
                                                         n_nodes, width)
    key = jax.random.PRNGKey(42)
    jg, jb = _jax_evolve(key, jnp.asarray(gnn_pop), jnp.asarray(fit_g),
                        jnp.asarray(bz_pop), jnp.asarray(fit_b),
                        jnp.asarray(logits), n_nodes=n_nodes, e_g=e_g,
                        e_b=e_b, **CFG)
    draws = jax_evolve_draws(key, n_g=n_g, n_b=n_b, e_g=e_g, e_b=e_b,
                             genome_size=width, n_nodes=n_nodes,
                             tournament_k=CFG["tournament_k"])
    tg, tb = ea.evolve(_t(gnn_pop), _t(fit_g), _t(bz_pop), _t(fit_b),
                       _t(logits), draws, n_nodes=n_nodes, e_g=e_g, e_b=e_b,
                       **{k: v for k, v in CFG.items()
                          if k != "tournament_k"})
    jg, jb = np.asarray(jg), np.asarray(jb)
    assert tg.shape == jg.shape and tb.shape == jb.shape
    np.testing.assert_array_equal(tg[:e_g].numpy(), jg[:e_g])
    np.testing.assert_array_equal(tb[:e_b].numpy(), jb[:e_b])
    np.testing.assert_allclose(tg.numpy(), jg, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tb.numpy(), jb, atol=TOL, rtol=TOL)
    if n_g:
        # row 0 is the best genome, the first of equals
        best = int(np.flatnonzero(fit_g == fit_g.max())[0])
        np.testing.assert_array_equal(tg[0].numpy(), gnn_pop[best])


def test_tournament_picks_first_maximum():
    fit = torch.tensor([0.5, 2.0, 2.0, -1.0])
    cands = torch.tensor([[3, 2, 1], [0, 3, 0], [1, 2, 2]])
    assert ea.tournament_indices(fit, cands).tolist() == [2, 0, 1]
    jwin = jea.tournament_indices(jax.random.PRNGKey(0), jnp.asarray(fit),
                                  64, 3)
    jc = jax.random.randint(jax.random.PRNGKey(0), (64, 3), 0, 4)
    assert ea.tournament_indices(fit, _t(jc).long()).tolist() == \
        np.asarray(jwin).tolist()


def test_operators_match_jax():
    rng = np.random.default_rng(5)
    v = 1000
    g = rng.standard_normal((1, v)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    k1, k2, k3 = jax.random.split(key, 3)
    out = ea.mutate_gnn(_t(g), _t(jax.random.uniform(k1))[None],
                        _t(jax.random.uniform(k2, (v,)))[None],
                        _t(jax.random.normal(k3, (v,)))[None],
                        frac=0.1, std=0.1)
    ref = jea.mutate_gnn(key, jnp.asarray(g[0]), frac=0.1, std=0.1)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)
    mate = rng.standard_normal((1, v)).astype(np.float32)
    pt = jax.random.randint(key, (), 1, v)
    np.testing.assert_array_equal(
        ea.single_point_crossover(_t(mate), _t(g), _t(pt)[None]).numpy()[0],
        np.asarray(jea.single_point_crossover(key, jnp.asarray(mate[0]),
                                              jnp.asarray(g[0]))))
    # seeding from a GNN posterior
    logits = rng.standard_normal((57, 2, 3)).astype(np.float32)
    noise = jax.random.normal(key, (57, 2))
    seeded = bz.seed_from_logits(_t(logits), _t(noise))
    jseeded = jbz.seed_from_logits(jnp.asarray(logits), key)
    np.testing.assert_array_equal(seeded.prior.numpy(), logits)
    np.testing.assert_allclose(seeded.log_t.numpy(),
                               np.asarray(jseeded.log_t), atol=TOL, rtol=0)
