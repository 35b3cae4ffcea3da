"""The port's multi-workload EGRL (``ZooEGRL``), its zero-shot scores
(``evaluate_gnn_on`` / ``evaluate_gnn_zoo``) and ``launch/train_zoo``
against the JAX package's.  One "ea" generation over a 2-bucket zoo is
held against the same generation composed from the JAX functions on the
same populations and the same draws (Gumbel noise and EA draws taken
from JAX keys); "egrl", "pg" and "worst" aggregation run on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs its files in parallel workers, and
# the port's small CPU ops lose more to thread hand-offs than they gain
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import boltzmann as jbz  # noqa: E402
from repro.core import egrl as jegrl  # noqa: E402
from repro.core import gnn as jgnn  # noqa: E402
from repro.graphs import bucketed as jbucketed  # noqa: E402
from repro.graphs import zoo as jzoo  # noqa: E402
from repro.launch import train_zoo as jtrain_zoo  # noqa: E402
from repro.memsim import batch as jmb  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import egrl  # noqa: E402
from repro_torch.core.egrl import (EGRLConfig, ZooEGRL,  # noqa: E402
                                   ZooGenerationDraws)
from repro_torch.graphs import zoo  # noqa: E402
from repro_torch.launch import train_zoo  # noqa: E402
from test_torch_ea import _jax_evolve, jax_evolve_draws  # noqa: E402
from test_torch_egrl import _gumbel_sample  # noqa: E402

SMALL = ["resnet50", "mobilenet_v2", "tiny_gpt"]
TOL = 1e-6


def _graphs(names=SMALL):
    return [zoo.WORKLOADS[n]() for n in names]


def test_ea_generation_matches_jax():
    cfg = EGRLConfig(pop_size=10, seed=3)
    algo = ZooEGRL(_graphs(), cfg, mode="ea", buckets="auto", device="cpu")
    bz = algo.zoo
    assert bz.n_buckets == 2 and algo.n_eff == 57 + 2 * 123
    jz = jbucketed.build_bucketed_zoo([jzoo.WORKLOADS[n]() for n in SMALL],
                                      "auto")
    n_g, n_b, n_eff = algo.n_g, algo.n_b, algo.n_eff
    gnn_pop = jnp.asarray(convert.gnn_to_jax(algo.gnn_pop))
    bz_pop = jnp.asarray(convert.boltzmann_to_jax(algo.bz_pop))

    # ---- the JAX generation (core/egrl.py:690-798), composed
    template = jgnn.init_gnn(jax.random.PRNGKey(0), bz.n_features)
    logits = jax.jit(jgnn.population_logits_bucketed,
                     static_argnames="backend")(template, jz.buckets,
                                                gnn_pop, backend="jnp")
    keys = jax.random.split(jax.random.PRNGKey(11), 2 + bz.n_buckets)
    kb, ke = keys[0], keys[1]
    maps_g, gum_g = zip(*(_gumbel_sample(jax.random.split(k, n_g), lg)
                          for k, lg in zip(keys[2:], logits)))
    bz_logits = jbz.boltzmann_logits(jbz.from_flat(bz_pop, n_eff))
    maps_bf, gum_b = _gumbel_sample(jax.random.split(kb, n_b), bz_logits)
    offs = np.cumsum([0] + [b.n_graphs * b.n_max for b in jz.buckets])
    maps = [np.concatenate([mg, maps_bf[:, offs[k]:offs[k + 1]].reshape(
        n_b, b.n_graphs, b.n_max, 2)]) for k, (mg, b) in
        enumerate(zip(maps_g, jz.buckets))]
    res = jmb.evaluate_population_bucketed(
        jz, [jnp.asarray(m) for m in maps], cfg.reward_scale)
    reward = np.asarray(res["reward"])                         # (P, G)
    fit = np.asarray(jmb.aggregate_rewards(res["reward"], "mean"))
    grid = jnp.concatenate([lg.reshape(n_g, -1, 2, 3) for lg in logits], 1)
    next_g, next_b = _jax_evolve(
        ke, gnn_pop, jnp.asarray(fit[:n_g]), bz_pop, jnp.asarray(fit[n_g:]),
        grid, n_nodes=n_eff, e_g=algo.e_g, e_b=algo.e_b,
        tournament_k=cfg.tournament_k, crossover_prob=cfg.crossover_prob,
        mut_prob=cfg.mut_prob, mut_frac=cfg.mut_frac, mut_std=cfg.mut_std)

    # ---- one port generation on those draws
    draws = ZooGenerationDraws(
        tuple(torch.as_tensor(g) for g in gum_g), torch.as_tensor(gum_b),
        jax_evolve_draws(ke, n_g=n_g, n_b=n_b, e_g=algo.e_g, e_b=algo.e_b,
                         genome_size=algo.genome_size, n_nodes=n_eff,
                         tournament_k=cfg.tournament_k))
    tlogits = algo.population_logits(algo.gnn_pop)
    for a, b in zip(tlogits, logits):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=0)
    rec = algo.generation(draws)
    assert rec["steps"] == algo.steps == cfg.pop_size * 3
    assert rec["gen_best_fitness"] == pytest.approx(float(fit.max()), rel=TOL)
    assert rec["gen_mean_fitness"] == pytest.approx(float(fit.mean()),
                                                    rel=TOL)
    assert rec["valid_frac"] == float(np.asarray(res["valid"]).mean())
    assert set(rec["best_reward_per_graph"]) == set(SMALL)
    for gi, name in enumerate(bz.names):
        k, s, n = bz.graph_bucket[gi], bz.graph_slot[gi], algo.n_nodes[gi]
        best = int(np.argmax(reward[:, gi]))
        assert algo.best_reward[gi] == pytest.approx(float(reward[best, gi]),
                                                     rel=TOL)
        np.testing.assert_array_equal(algo.best_mapping[gi],
                                      maps[k][best, s, :n])
    np.testing.assert_allclose(algo.gnn_pop.numpy(), np.asarray(next_g),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(algo.bz_pop.numpy(), np.asarray(next_b),
                               atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(algo.best_gnn_vec(), np.asarray(next_g)[0])


@pytest.mark.parametrize("mode,agg,gens", [("egrl", "mean", 3),
                                           ("pg", "mean", 25),
                                           ("ea", "worst", 3)])
def test_modes_run_on_cpu(mode, agg, gens):
    """Two buckets.  "egrl" / "pg": every rollout row of every graph
    lands in its buffer of the bank; ZooSAC trains one step per row once
    a buffer holds a batch (24); "egrl" migrates the actor into the last
    GNN row.  "worst": the fitness of a row is its weakest graph's
    reward, so no row's fitness exceeds any graph's best."""
    cfg = EGRLConfig(pop_size=10, seed=0)
    algo = ZooEGRL(_graphs(), cfg, mode=mode, fitness_agg=agg, device="cpu")
    hist = [algo.generation() for _ in range(gens)]
    rows = algo.n_g + algo.n_b + (cfg.pg_rollouts if mode != "ea" else 0)
    assert algo.steps == gens * rows * 3
    best = np.array([h for h in hist[-1]["best_reward_per_graph"].values()])
    np.testing.assert_array_equal(best, algo.best_reward)
    if agg == "worst":
        assert algo.best_fitness <= best.min() + 1e-6
        assert algo.learner is None and algo.bank is None
    else:
        assert algo.best_fitness <= best.mean() + 1e-6
    for gi, m in enumerate(algo.best_mapping):
        assert m.shape == (algo.n_nodes[gi], 2)
    if mode == "ea":
        return
    assert all(len(b) == gens * rows for b in algo.bank.buffers)
    trained = [h for h in hist if "critic_loss" in h]
    assert len(trained) == sum(k * rows >= 24 for k in range(1, gens + 1))
    assert trained
    assert algo.learner.opt_a["t"] == rows * len(trained)
    assert all(np.isfinite([h["critic_loss"], h["actor_loss"],
                            h["entropy"]]).all() for h in trained)
    if mode == "egrl":
        assert torch.equal(algo.gnn_pop[algo.n_g - 1], algo.learner.actor)
    else:
        assert (algo.n_g, algo.n_b) == (0, 0)
        np.testing.assert_array_equal(algo.best_gnn_vec(),
                                      algo.learner.actor.numpy())


@pytest.fixture(scope="module")
def genome():
    template = jgnn.init_gnn(jax.random.PRNGKey(5), 19)
    return np.asarray(jgnn.flatten_params(template))


def test_evaluate_gnn_on_matches_jax(genome, monkeypatch):
    monkeypatch.setenv("REPRO_GAT_BACKEND", "jnp")
    name, samples, seed = "resnet101", 8, 2
    jg = jzoo.WORKLOADS[name]()
    want = jegrl.evaluate_gnn_on(jg, genome, samples=samples, seed=seed)
    logits = jgnn.gnn_forward(
        jgnn.unflatten_params(jgnn.init_gnn(jax.random.PRNGKey(0), 19),
                              jnp.asarray(genome)),
        jnp.asarray(jg.features()), jnp.asarray(jg.adjacency()))
    keys = jax.random.split(jax.random.PRNGKey(seed), samples)
    _, gum = _gumbel_sample(keys, jnp.broadcast_to(
        logits, (samples,) + logits.shape))
    got = egrl.evaluate_gnn_on(zoo.WORKLOADS[name](), genome,
                               gumbel=torch.as_tensor(gum), device="cpu")
    assert got == pytest.approx(want, rel=TOL)
    assert got > 0
    # seeded draws of its own: a speedup of the same kind
    assert egrl.evaluate_gnn_on(zoo.WORKLOADS[name](), genome,
                                device="cpu") > 0


def test_evaluate_gnn_zoo_matches_jax(genome, monkeypatch):
    monkeypatch.setenv("REPRO_GAT_BACKEND", "jnp")
    names, samples, seed = ["resnet101", "mobilenet_v2", "resnet50"], 4, 1
    want = jegrl.evaluate_gnn_zoo([jzoo.WORKLOADS[n]() for n in names],
                                  genome, samples=samples, seed=seed)
    jz = jbucketed.build_bucketed_zoo([jzoo.WORKLOADS[n]() for n in names])
    params = jgnn.unflatten_params(
        jgnn.init_gnn(jax.random.PRNGKey(0), 19), jnp.asarray(genome))
    keys = jax.random.split(jax.random.PRNGKey(seed), samples)
    gumbel = []
    for lg in jgnn.gnn_forward_bucketed(params, jz.buckets):
        _, gum = _gumbel_sample(keys, jnp.broadcast_to(
            lg, (samples,) + lg.shape))
        gumbel.append(torch.as_tensor(gum))
    got = egrl.evaluate_gnn_zoo(_graphs(names), genome, gumbel=gumbel,
                                device="cpu")
    assert list(got) == names
    for n in names:
        assert got[n] == pytest.approx(want[n], rel=TOL), n


def test_train_zoo_report_has_jax_keys(tmp_path, monkeypatch, capsys):
    """The JAX launcher's report built around the port's ZooEGRL (so both
    schemas are filled from one run) has the port's keys and values."""
    kw = dict(steps=20, mode="ea", agg="worst", seed=0, buckets="auto")
    report, algo = train_zoo.train_zoo(["resnet50", "mobilenet_v2"],
                                       ["tiny_gpt"], device="cpu", log=None,
                                       **kw)

    class PortZooEGRL(ZooEGRL):
        def __init__(self, graphs, cfg, **k):
            super().__init__([zoo.WORKLOADS[g.name]() for g in graphs], cfg,
                             device="cpu", **k)

    monkeypatch.setattr(jtrain_zoo, "ZooEGRL", PortZooEGRL)
    monkeypatch.setattr(
        jtrain_zoo, "evaluate_gnn_zoo", lambda graphs, vec, seed: (
            egrl.evaluate_gnn_zoo([zoo.WORKLOADS[g.name]() for g in graphs],
                                  vec, seed=seed, device="cpu")))
    want, _ = jtrain_zoo.train_zoo(["resnet50", "mobilenet_v2"],
                                   ["tiny_gpt"], log=None, **kw)
    assert report == want
    assert set(report) == {"train", "mode", "agg", "env_steps",
                           "best_fitness", "buckets", "pad_waste_frac",
                           "train_best_speedup", "zero_shot_speedup"}
    assert report["env_steps"] == algo.steps >= 20
    # the CLI writes the report and prints the CSV lines
    out = train_zoo.main(["--train", "resnet50", "--holdout", "mobilenet_v2",
                          "--steps", "20", "--mode", "ea", "--device", "cpu",
                          "--out", str(tmp_path), "--quiet"])
    lines = capsys.readouterr().out.splitlines()
    assert lines == [f"train,resnet50,"
                     f"{out['train_best_speedup']['resnet50']:.3f}",
                     f"zero_shot,mobilenet_v2,"
                     f"{out['zero_shot_speedup']['mobilenet_v2']:.3f}"]
    assert (tmp_path / "zoo_resnet50_ea.json").exists()


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_zoo.main(["--train", "resnet50", "--steps", "20"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ZooEGRL(_graphs(["resnet50"]), EGRLConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        egrl.evaluate_gnn_zoo(_graphs(["resnet50"]), np.zeros(1))
    with pytest.raises(ValueError, match="REPRO_FITNESS_AGG"):
        ZooEGRL(_graphs(["resnet50"]), EGRLConfig(), fitness_agg="median",
                device="cpu")
    with pytest.raises(ValueError, match="egrl, ea, pg"):
        ZooEGRL(_graphs(["resnet50"]), EGRLConfig(), mode="sac",
                device="cpu")
