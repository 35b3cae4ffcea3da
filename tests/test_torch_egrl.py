"""The port's EA-mode EGRL generation against the same generation composed
from the JAX package's functions, on the same populations and the same
random draws (Gumbel noise and EA draws taken from JAX keys), and the
whole port run on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import boltzmann as jbz  # noqa: E402
from repro.core import gnn as jgnn  # noqa: E402
from repro.graphs import zoo as jzoo  # noqa: E402
from repro.memsim import compiler as jcompiler  # noqa: E402
from repro.memsim import simulator as jsim  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import boltzmann as bz, gnn  # noqa: E402
from repro_torch.core.egrl import EGRL, EGRLConfig, GenerationDraws  # noqa
from repro_torch.graphs import zoo  # noqa: E402
from test_torch_ea import _jax_evolve, jax_evolve_draws  # noqa: E402

TOL = 1e-6


def _gumbel_sample(keys, logits):
    """jax.random.categorical per row, and the Gumbel draws it is the
    argmax of (checked here, so the port can take the same draws)."""
    maps = jax.vmap(lambda k, l: jax.random.categorical(k, l, axis=-1))(
        keys, logits)
    gum = jax.vmap(lambda k: jax.random.gumbel(k, logits.shape[1:]))(keys)
    np.testing.assert_array_equal(np.asarray(maps),
                                  np.asarray(jnp.argmax(logits + gum, -1)))
    return np.asarray(maps).astype(np.int32), np.array(gum)


def test_generation_matches_jax():
    name = "resnet50"
    cfg = EGRLConfig(total_steps=400, seed=3)
    algo = EGRL(zoo.WORKLOADS[name](), cfg, mode="ea", device="cpu")
    n = algo.g.n
    jg = jzoo.WORKLOADS[name]()
    feats, adj = jnp.asarray(jg.features()), jnp.asarray(jg.adjacency())
    jsg = jsim.build_sim_graph(jg)
    _, ref = jcompiler.compiler_reference(jg)
    gnn_pop = jnp.asarray(convert.gnn_to_jax(algo.gnn_pop))
    bz_pop = jnp.asarray(convert.boltzmann_to_jax(algo.bz_pop))

    # ---- the JAX generation, composed from the package's functions
    template = jgnn.init_gnn(jax.random.PRNGKey(0), feats.shape[1])
    logits = jax.jit(jgnn.population_logits, static_argnames="backend")(
        template, feats, adj, gnn_pop, backend="jnp")
    kg, kb, ke = jax.random.split(jax.random.PRNGKey(11), 3)
    maps_g, gum_g = _gumbel_sample(jax.random.split(kg, algo.n_g), logits)
    bz_logits = jbz.boltzmann_logits(jbz.from_flat(bz_pop, n))
    maps_b, gum_b = _gumbel_sample(jax.random.split(kb, algo.n_b), bz_logits)
    maps = np.concatenate([maps_g, maps_b])
    res = jsim.evaluate_population(jsg, jnp.asarray(maps), jnp.float32(ref),
                                   cfg.reward_scale)
    reward = np.asarray(res["reward"])
    next_g, next_b = _jax_evolve(
        ke, gnn_pop, jnp.asarray(reward[:algo.n_g]), bz_pop,
        jnp.asarray(reward[algo.n_g:]), logits, n_nodes=n, e_g=algo.e_g,
        e_b=algo.e_b, tournament_k=cfg.tournament_k,
        crossover_prob=cfg.crossover_prob, mut_prob=cfg.mut_prob,
        mut_frac=cfg.mut_frac, mut_std=cfg.mut_std)

    # ---- the port's sampling on the same draws gives the same mappings
    tg, tb = torch.as_tensor(gum_g), torch.as_tensor(gum_b)
    tlogits = gnn.population_logits(algo.gnn_pop, algo.feats, algo.adj)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(logits),
                               atol=1e-4, rtol=0)
    np.testing.assert_array_equal(gnn.sample_actions(tlogits, tg).numpy(),
                                  maps_g)
    np.testing.assert_array_equal(
        bz.sample(bz.from_flat(algo.bz_pop, n), tb).numpy(), maps_b)

    # ---- one port generation on those draws
    draws = GenerationDraws(tg, tb, jax_evolve_draws(
        ke, n_g=algo.n_g, n_b=algo.n_b, e_g=algo.e_g, e_b=algo.e_b,
        genome_size=algo.genome_size, n_nodes=n,
        tournament_k=cfg.tournament_k))
    rec = algo.generation(draws)
    assert rec["steps"] == cfg.pop_size
    assert rec["gen_best_reward"] == pytest.approx(float(reward.max()),
                                                   rel=TOL)
    assert rec["gen_mean_reward"] == pytest.approx(float(reward.mean()),
                                                   rel=TOL)
    assert rec["valid_frac"] == float(np.asarray(res["valid"]).mean())
    np.testing.assert_array_equal(algo.best_mapping,
                                  maps[int(np.argmax(reward))])
    np.testing.assert_allclose(algo.gnn_pop.numpy(), np.asarray(next_g),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(algo.bz_pop.numpy(), np.asarray(next_b),
                               atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(algo.best_gnn_vec(), np.asarray(next_g)[0])


def test_config_matches_jax():
    import dataclasses
    from repro.core.egrl import EGRLConfig as JConfig

    def fields(cfg):
        return {f.name: getattr(cfg, f.name)
                for f in dataclasses.fields(cfg)}
    port, ref = fields(EGRLConfig()), fields(JConfig())
    assert fields(port.pop("sac")) == fields(ref.pop("sac"))
    assert port == ref


def test_population_split_matches_jax():
    from repro.core.egrl import _EvoPopulation
    for pop_size, elites, frac in [(20, 4, 0.2), (10, 3, 0.25), (7, 2, 0.5),
                                   (5, 5, 0.2)]:
        cfg = EGRLConfig(pop_size=pop_size, elites=elites,
                         boltzmann_frac=frac)
        ref = _EvoPopulation()
        ref.cfg, ref.mode = cfg, "ea"
        ref._split_population()
        algo = EGRL(zoo.resnet50(), cfg, device="cpu")
        assert (algo.n_g, algo.n_b, algo.e_g, algo.e_b) == \
            (ref.n_g, ref.n_b, ref.e_g, ref.e_b)
        assert algo.gnn_pop.shape[0] == algo.n_g
        assert algo.bz_pop.shape[0] == algo.n_b


def test_ea_mode_run_beats_the_compiler_on_cpu():
    """The whole port run on resnet50 at 400 steps, seed 0 (the JAX
    package reaches 1.256 there)."""
    algo = EGRL(zoo.resnet50(), EGRLConfig(total_steps=400, seed=0),
                mode="ea", device="cpu")
    hist = algo.train()
    assert algo.steps == 400 and len(hist) == 20
    assert (algo.n_g, algo.n_b, algo.e_g, algo.e_b) == (16, 4, 3, 1)
    assert hist[-1]["best_speedup"] > 1.0
    assert algo.best_mapping.shape == (57, 2)
    logits = algo.best_policy_logits()
    assert logits.shape == (57, 2, 3) and bool(torch.isfinite(logits).all())
    # the same seed gives the same run
    again = EGRL(zoo.resnet50(), EGRLConfig(total_steps=100, seed=0),
                 mode="ea", device="cpu")
    again.train()
    assert [h["best_reward"] for h in again.history] == \
        [h["best_reward"] for h in hist[:5]]
