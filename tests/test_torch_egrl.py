"""The port's EA-mode EGRL generation against the same generation composed
from the JAX package's functions, on the same populations and the same
random draws (Gumbel noise and EA draws taken from JAX keys), and the
whole port run on the CPU."""
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


def test_egrl_generation_matches_jax(monkeypatch):
    """One "egrl"-mode generation against the same generation composed
    from the JAX package's functions: the population and the learner
    start from one state, the replay buffers from the same 30 entries,
    and both take the same Gumbel, EA and action-noise draws.  Rollout
    rewards and the next population agree to 1e-6 as in EA mode; the
    SAC losses to rtol 1e-3 (Adam's first steps are lr * sign(g), so a
    parameter whose gradient is rounding noise may move 2 lr apart).
    The JAX learner runs its GAT on the dense "jnp" backend."""
    from repro.core import replay as jreplay
    from repro.core import sac as jsac
    monkeypatch.setenv("REPRO_GAT_BACKEND", "jnp")
    name = "resnet50"
    cfg = EGRLConfig(pop_size=5, total_steps=400, seed=3)
    algo = EGRL(zoo.WORKLOADS[name](), cfg, mode="egrl", device="cpu")
    n, n_g, n_b = algo.g.n, algo.n_g, algo.n_b
    assert n_g > algo.e_g                          # migration happens
    jg = jzoo.WORKLOADS[name]()
    feats, adj = jnp.asarray(jg.features()), jnp.asarray(jg.adjacency())
    jsg = jsim.build_sim_graph(jg)
    _, ref = jcompiler.compiler_reference(jg)
    gnn_pop = jnp.asarray(convert.gnn_to_jax(algo.gnn_pop))
    bz_pop = jnp.asarray(convert.boltzmann_to_jax(algo.bz_pop))
    jl = jsac.SACLearner(feats, adj, jax.random.PRNGKey(0), cfg.sac)
    for key, val in convert.sac_state_to_jax(algo.learner.state()).items():
        setattr(jl, key, jax.tree.map(jnp.asarray, val))
    jbuf = jreplay.ReplayBuffer(n, seed=cfg.seed)
    rng = np.random.default_rng(0)
    pre_a = rng.integers(0, 3, (30, n, 2))
    pre_r = (5.0 + rng.standard_normal(30)).astype(np.float32)
    jbuf.add_batch(pre_a, pre_r)
    algo.buffer.add_batch(pre_a, pre_r)

    # ---- the JAX generation (core/egrl.py:421-497), composed
    template = jgnn.init_gnn(jax.random.PRNGKey(0), feats.shape[1])
    logits = jax.jit(jgnn.population_logits, static_argnames="backend")(
        template, feats, adj, gnn_pop, backend="jnp")
    kg, kb, kp, ke = jax.random.split(jax.random.PRNGKey(12), 4)
    maps_g, gum_g = _gumbel_sample(jax.random.split(kg, n_g), logits)
    bz_logits = jbz.boltzmann_logits(jbz.from_flat(bz_pop, n))
    maps_b, gum_b = _gumbel_sample(jax.random.split(kb, n_b), bz_logits)
    pg_logits = jgnn.gnn_forward(jl.actor, feats, adj, backend="jnp")[None]
    maps_pg, gum_pg = _gumbel_sample(jax.random.split(kp, 1), pg_logits)
    maps = np.concatenate([maps_g, maps_b, maps_pg])
    reward = np.concatenate([np.asarray(jsim.evaluate_population(
        jsg, jnp.asarray(m), jnp.float32(ref), cfg.reward_scale)["reward"])
        for m in (np.concatenate([maps_g, maps_b]), maps_pg)])
    next_g, next_b = _jax_evolve(
        ke, gnn_pop, jnp.asarray(reward[:n_g]), bz_pop,
        jnp.asarray(reward[n_g:n_g + n_b]), logits, n_nodes=n, e_g=algo.e_g,
        e_b=algo.e_b, tournament_k=cfg.tournament_k,
        crossover_prob=cfg.crossover_prob, mut_prob=cfg.mut_prob,
        mut_frac=cfg.mut_frac, mut_std=cfg.mut_std)
    jbuf.add_batch(maps, reward)
    steps = len(maps)
    pairs = [jbuf.sample(cfg.sac.batch) for _ in range(steps)]
    noise = np.clip(0.2 * rng.standard_normal(
        (steps, cfg.sac.batch, n, 2, 3)), -0.5, 0.5).astype(np.float32)
    out = jl._update_scan(jl.actor, jl.critic, jl.opt_a, jl.opt_c,
                          jnp.asarray(np.stack([p[0] for p in pairs])),
                          jnp.asarray(np.stack([p[1] for p in pairs])),
                          jnp.asarray(noise))
    jcl, jal, jen = (float(x) for x in out[4:])

    # ---- one port generation on those draws
    draws = GenerationDraws(
        torch.as_tensor(gum_g), torch.as_tensor(gum_b), jax_evolve_draws(
            ke, n_g=n_g, n_b=n_b, e_g=algo.e_g, e_b=algo.e_b,
            genome_size=algo.genome_size, n_nodes=n,
            tournament_k=cfg.tournament_k),
        gumbel_pg=torch.as_tensor(gum_pg), sac_noise=torch.as_tensor(noise))
    rec = algo.generation(draws)
    assert rec["steps"] == steps == cfg.pop_size + cfg.pg_rollouts
    assert rec["gen_best_reward"] == pytest.approx(float(reward.max()),
                                                   rel=TOL)
    assert rec["gen_mean_reward"] == pytest.approx(float(reward.mean()),
                                                   rel=TOL)
    # every rollout is in the buffer, in the order GNN, Boltzmann, PG
    assert len(algo.buffer) == len(jbuf) == 30 + steps
    np.testing.assert_array_equal(algo.buffer.actions[:len(jbuf)],
                                  jbuf.actions[:len(jbuf)])
    np.testing.assert_array_equal(algo.buffer.rewards, jbuf.rewards)
    assert rec["critic_loss"] == pytest.approx(jcl, rel=1e-3)
    assert rec["actor_loss"] == pytest.approx(jal, rel=1e-3)
    assert rec["entropy"] == pytest.approx(jen, rel=1e-3)
    # the EA rows as in JAX; the last GNN row is the migrated actor
    np.testing.assert_allclose(algo.gnn_pop[:n_g - 1].numpy(),
                               np.asarray(next_g)[:n_g - 1], atol=TOL,
                               rtol=TOL)
    assert torch.equal(algo.gnn_pop[n_g - 1], algo.learner.actor)
    np.testing.assert_allclose(algo.bz_pop.numpy(), np.asarray(next_b),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("mode,steps", [("egrl", 100), ("pg", 30)])
def test_sac_modes_run_on_cpu(mode, steps):
    """The port's "egrl" and "pg" runs on resnet50, seed 0.  Every
    rollout lands in the replay buffer; SAC trains once it holds a
    batch (24); "egrl" beats the compiler within 100 steps."""
    algo = EGRL(zoo.resnet50(), EGRLConfig(total_steps=steps, seed=0),
                mode=mode, device="cpu")
    hist = algo.train()
    assert len(algo.buffer) == algo.steps >= steps
    per_gen = algo.n_g + algo.n_b + algo.cfg.pg_rollouts
    trained = [h for h in hist if "critic_loss" in h]
    assert len(trained) == len(hist) - (24 - 1) // per_gen
    assert algo.learner.opt_a["t"] == per_gen * len(trained)
    assert all(np.isfinite([h["critic_loss"], h["actor_loss"],
                            h["entropy"]]).all() for h in trained)
    logits = algo.best_policy_logits()
    assert logits.shape == (57, 2, 3) and bool(torch.isfinite(logits).all())
    if mode == "egrl":
        assert hist[-1]["best_speedup"] > 1.0
        np.testing.assert_array_equal(algo.gnn_pop[algo.n_g - 1].numpy(),
                                      algo.learner.actor.numpy())
    else:
        assert (algo.n_g, algo.n_b, per_gen) == (0, 0, 1)
        np.testing.assert_array_equal(algo.best_gnn_vec(),
                                      algo.learner.actor.numpy())
        torch.testing.assert_close(logits, algo.learner.policy_logits())
