"""The port's population sharding (``launch.mesh``,
``distributed.population``, ``core.ea.evolve_sharded`` and the sharded
``EGRL`` / ``ZooEGRL``) against the JAX package's.

The JAX resolver runs in a subprocess with 8 forced host devices; the
port's gets ``["cpu"] * 8``.  The sharded EA step over S = 1-4 CPU
"devices" is held against JAX's single-device ``evolve`` (its padded
form where S pads) on JAX's draws, and bit for bit against the port's
own ``evolve``; sharded ``EGRL`` / ``ZooEGRL`` against unsharded ones."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs its files in parallel workers, and
# the port's small CPU ops lose more to thread hand-offs than they gain
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.core import ea  # noqa: E402
from repro_torch.core.egrl import EGRL, EGRLConfig, ZooEGRL  # noqa: E402
from repro_torch.distributed.population import (  # noqa: E402
    PopSharding, RowShards, resolve_pop_sharding)
from repro_torch.graphs import zoo  # noqa: E402
from repro_torch.launch.mesh import (make_mesh, make_pop_mesh,  # noqa: E402
                                     make_pop_model_mesh)
from test_torch_ea import (CFG, _jax_evolve, _populations,  # noqa: E402
                           _t, jax_evolve_draws)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TOL = 1e-6
ENV_KNOBS = ("REPRO_POP_SHARDS", "REPRO_MODEL_SHARDS",
             "REPRO_BUCKET_DISPATCH", "REPRO_ZOO_BUCKETS")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ENV_KNOBS:
        monkeypatch.delenv(k, raising=False)


# ------------------------------------------------------------- policy
GRID = [(n_g, n_b, req, model)
        for n_g, n_b in [(12, 4), (51, 13), (48, 16), (6, 2), (3, 2),
                         (16, 4), (5, 3), (1, 1), (0, 4), (0, 0)]
        for req in ["auto", "off", 1, 3, 5, 9, 12, "bogus"]
        for model in [None, "auto", 2, 4]]


def _outcome(fn):
    try:
        s = fn()
    except ValueError as e:
        return ["error", str(e)]
    return [s.n_shards, list(s.padded(0, 0) if s.n_g_pad is None
                             else (s.n_g_pad, s.n_b_pad)), s.model_shards,
            s.active]


def test_resolve_pop_sharding_matches_jax():
    """n_shards, the padded rows, model_shards and the errors, over
    "auto", "off", 1, 3, 5, 9, 12 (> 8 devices), an unknown value and
    pure PG, with the model axis off, "auto", 2 and 4."""
    code = f"""
import json
from repro.distributed.population import resolve_pop_sharding
out = []
for n_g, n_b, req, model in {GRID!r}:
    try:
        s = resolve_pop_sharding(n_g, n_b, req, model_shards=model)
        out.append([s.n_shards, [s.n_g_pad, s.n_b_pad] if s.n_g_pad
                    is not None else [0, 0], s.model_shards, s.active])
    except ValueError as e:
        out.append(["error", str(e)])
print(json.dumps(out))
"""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    for k in ENV_KNOBS:
        env.pop(k, None)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    for (n_g, n_b, req, model), w in zip(GRID, want):
        got = _outcome(lambda: resolve_pop_sharding(
            n_g, n_b, req, model_shards=model, devices=["cpu"] * 8))
        assert got == w, (n_g, n_b, req, model)
    assert sum(w[0] == "error" for w in want) > 0
    assert sum(w[-1] is True for w in want if w[0] != "error") > 0


def test_meshes_and_placement():
    devs = ["cpu"] * 8
    assert make_pop_mesh(devices=devs).shape == {"pop": 8}
    assert make_pop_mesh(3, devs).shape == {"pop": 3}
    assert make_pop_model_mesh(2, 4, devs).shape == {"pop": 2, "model": 4}
    assert make_mesh((2, 2), ("a", "b"), devs).shape == {"a": 2, "b": 2}
    for bad in (lambda: make_pop_mesh(9, devs),
                lambda: make_pop_model_mesh(4, 4, devs),
                lambda: make_mesh((3, 3), ("a", "b"), devs)):
        with pytest.raises(ValueError, match="requests .* but only 8"):
            bad()
    with pytest.raises(ValueError, match="REPRO_POP_SHARDS=2 but only 1"):
        resolve_pop_sharding(12, 4, 2, devices=["cpu"])
    # rows split in order, one fresh block per shard; padding by the
    # caller; wide = each pop block over its grid row
    s = resolve_pop_sharding(5, 3, 2, model_shards=2, devices=devs[:4])
    assert s.padded(5, 3) == (8, 4) and s.mesh.shape == {"pop": 2,
                                                         "model": 2}
    x = torch.arange(8 * 3, dtype=torch.float32).view(8, 3)
    rs = s.put(x)
    assert [p.shape[0] for p in rs.parts] == [4, 4]
    assert rs.offsets == [0, 4, 8] and rs.shape == (8, 3)
    assert all(p.data_ptr() != x.data_ptr() for p in rs.parts)
    assert s.put(rs) is rs
    np.testing.assert_array_equal(rs.cat("cpu"), x)
    wide = s.put_wide(rs)
    assert [[p.shape[0] for p in w.parts] for w in wide] == [[2, 2], [2, 2]]
    np.testing.assert_array_equal(torch.cat([w.cat("cpu") for w in wide]),
                                  x)
    rs.write(3, torch.full((2, 3), -1.0))
    y = x.clone()
    y[3:5] = -1.0
    np.testing.assert_array_equal(rs.cat("cpu"), y)
    off = resolve_pop_sharding(5, 3, "off", devices=devs)
    assert not off.active and off.put(x) is x


# ------------------------------------------------------ sharded EA step
def _sharding(S, n_g, n_b):
    pad = lambda n: -(-n // S) * S if n else 0    # noqa: E731
    return PopSharding(make_pop_mesh(S, ["cpu"] * S), S, pad(n_g), pad(n_b))


def _pad(x, rows, fill=0.0):
    out = np.full((rows,) + x.shape[1:], fill, x.dtype)
    out[:x.shape[0]] = x
    return out


@pytest.mark.parametrize("S", [1, 2, 3, 4])
@pytest.mark.parametrize("n_g,n_b,e_g,e_b", [
    (16, 4, 3, 1),      # the EGRLConfig split: S = 3 pads to 18 / 6
    (6, 3, 2, 0),       # no Boltzmann elite
    (0, 4, 0, 2),       # Boltzmann only
])
def test_evolve_sharded_matches_evolve_and_jax(S, n_g, n_b, e_g, e_b):
    n_nodes, width = 57, 999
    rng = np.random.default_rng(7 * S + n_g)
    gnn_pop, fit_g, bz_pop, fit_b, logits = _populations(rng, n_g, n_b,
                                                         n_nodes, width)
    sh = _sharding(S, n_g, n_b)
    rg, rb = sh.padded(n_g, n_b)
    # padding rows: garbage genomes at -inf fitness
    pg, pb = _pad(gnn_pop, rg, 3.0), _pad(bz_pop, rb, 3.0)
    fg, fb = _pad(fit_g, rg, -np.inf), _pad(fit_b, rb, -np.inf)
    pl = _pad(logits, rg, 1.0)
    key = jax.random.PRNGKey(S + 100)
    draws = jax_evolve_draws(key, n_g=n_g, n_b=n_b, e_g=e_g, e_b=e_b,
                             genome_size=width, n_nodes=n_nodes,
                             tournament_k=CFG["tournament_k"])
    kw = dict(n_nodes=n_nodes, e_g=e_g, e_b=e_b,
              **{k: v for k, v in CFG.items() if k != "tournament_k"})
    sg, sb = ea.evolve_sharded(sh, _t(pg), _t(fg), _t(pb), _t(fb), _t(pl),
                               draws, n_g=n_g, n_b=n_b, **kw)
    assert [p.shape[0] for p in sg.parts] == [rg // S] * S
    sg, sb = sg.cat("cpu"), sb.cat("cpu")
    # bit for bit the port's own step, padded form and unpadded form
    tg, tb = ea.evolve(_t(pg), _t(fg), _t(pb), _t(fb), _t(pl), draws,
                       n_g=n_g, n_b=n_b, **kw)
    assert torch.equal(sg, tg) and torch.equal(sb, tb)
    ug, ub = ea.evolve(_t(gnn_pop), _t(fit_g), _t(bz_pop), _t(fit_b),
                       _t(logits), draws, **kw)
    assert torch.equal(sg[:n_g], ug) and torch.equal(sb[:n_b], ub)
    # padding rows hold copies of the last real row
    if rg > n_g:
        assert torch.equal(sg[n_g:], ug[-1:].expand(rg - n_g, -1))
    if rb > n_b:
        assert torch.equal(sb[n_b:], ub[-1:].expand(rb - n_b, -1))
    # JAX's single-device step, its padded form where S pads
    jg, jb = _jax_evolve(key, jnp.asarray(pg), jnp.asarray(fg),
                         jnp.asarray(pb), jnp.asarray(fb), jnp.asarray(pl),
                         n_g=n_g, n_b=n_b, **CFG, n_nodes=n_nodes, e_g=e_g,
                         e_b=e_b)
    jg, jb = np.asarray(jg)[:n_g], np.asarray(jb)[:n_b]
    np.testing.assert_array_equal(sg[:e_g].numpy(), jg[:e_g])
    np.testing.assert_array_equal(sb[:e_b].numpy(), jb[:e_b])
    np.testing.assert_allclose(sg[:n_g].numpy(), jg, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(sb[:n_b].numpy(), jb, atol=TOL, rtol=TOL)


def test_evolve_sharded_needs_dividing_rows():
    sh = PopSharding(make_pop_mesh(3, ["cpu"] * 3), 3)
    draws = ea.EvolveDraws(None, None)
    with pytest.raises(ValueError, match="not divisible"):
        ea.evolve_sharded(sh, RowShards([torch.zeros(2, 4)] * 3),
                          torch.zeros(6), torch.zeros(4, 8), torch.zeros(4),
                          torch.zeros(6, 1, 2, 3), draws, n_nodes=1, e_g=1,
                          e_b=1, crossover_prob=0.7, mut_prob=0.9,
                          mut_frac=0.1, mut_std=0.1)
    with pytest.raises(ValueError, match="active PopSharding"):
        ea.evolve_sharded(PopSharding(None, 1), None, None, None, None,
                          None, draws, n_nodes=1, e_g=1, e_b=1,
                          crossover_prob=0.7, mut_prob=0.9, mut_frac=0.1,
                          mut_std=0.1)


# ------------------------------------------------- EGRL and ZooEGRL
def _real(pop, n):
    return (pop.cat("cpu") if isinstance(pop, RowShards) else pop)[:n]


def _same_run(a, b, bucketed):
    """Two runs' trajectories: rewards, fitness, best mappings, replay
    contents and both populations, all bit-equal (the largest logit
    difference printed)."""
    assert [{k: v for k, v in h.items()} for h in a.history] == \
        [{k: v for k, v in h.items()} for h in b.history]
    assert np.array_equal(np.asarray(a.best_reward),
                          np.asarray(b.best_reward))
    if bucketed:
        for x, y in zip(a.best_mapping, b.best_mapping):
            assert np.array_equal(x, y)
        if a.bank is not None:
            for x, y in zip(a.bank.buffers, b.bank.buffers):
                assert x.size == y.size
                assert np.array_equal(x.actions[:x.size],
                                      y.actions[:y.size])
                assert np.array_equal(x.rewards[:x.size],
                                      y.rewards[:y.size])
        la = a.population_logits(_real(a.gnn_pop, a.n_g))
        lb = b.population_logits(_real(b.gnn_pop, b.n_g))
        diff = max(float((x - y).abs().max()) for x, y in zip(la, lb))
    else:
        assert np.array_equal(a.best_mapping, b.best_mapping)
        n = a.buffer.size
        assert n == b.buffer.size and n == a.steps
        assert np.array_equal(a.buffer.actions[:n], b.buffer.actions[:n])
        assert np.array_equal(a.buffer.rewards[:n], b.buffer.rewards[:n])
        from repro_torch.core import gnn
        diff = float((gnn.population_logits(_real(a.gnn_pop, a.n_g),
                                            a.feats, a.adj)
                      - gnn.population_logits(_real(b.gnn_pop, b.n_g),
                                              b.feats, b.adj)).abs().max())
    print(f"largest logit difference, sharded vs unsharded: {diff}")
    for pa, pb, n in ((a.gnn_pop, b.gnn_pop, a.n_g),
                      (a.bz_pop, b.bz_pop, a.n_b)):
        assert torch.equal(_real(pa, n), _real(pb, n))


@pytest.mark.parametrize("mode", ["ea", "egrl"])
def test_sharded_egrl_matches_unsharded(mode):
    cfg = EGRLConfig(pop_size=10, seed=4)
    base = EGRL(zoo.resnet50(), cfg, mode=mode, device="cpu", pop_shards=1)
    assert not base.pop_sharding.active
    runs = {S: EGRL(zoo.resnet50(), cfg, mode=mode, device="cpu",
                    pop_shards=S, devices=["cpu"] * S) for S in (2, 3)}
    assert runs[3].pop_sharding.padded(8, 2) == (9, 3)
    for _ in range(3):
        base.generation()
        for r in runs.values():
            r.generation()
    for S, r in runs.items():
        assert r.pop_sharding.n_shards == S
        assert [p.shape[0] for p in r.gnn_pop.parts] == [r.n_g_pad // S] * S
        _same_run(r, base, bucketed=False)
        np.testing.assert_array_equal(r.best_gnn_vec(), base.best_gnn_vec())
        assert torch.equal(r.best_policy_logits(), base.best_policy_logits())
        if mode == "egrl":
            # migration wrote the actor into the last real GNN row
            assert torch.equal(_real(r.gnn_pop, r.n_g)[-1], r.learner.actor)


@pytest.mark.parametrize("mode", ["ea", "egrl"])
def test_sharded_zoo_egrl_matches_unsharded(mode):
    graphs = [zoo.resnet50(), zoo.mobilenet_v2(), zoo.tiny_gpt()]
    cfg = EGRLConfig(pop_size=8, elites=2, boltzmann_frac=0.25, seed=2)

    def make(**kw):
        return ZooEGRL(graphs, cfg, mode=mode, buckets="auto", device="cpu",
                       **kw)
    base = make(pop_shards="off")
    runs = [make(pop_shards=S, devices=["cpu"] * S) for S in (2, 3)]
    assert all(r.dispatch is None for r in runs)
    for _ in range(2):
        for r in [base] + runs:
            r.generation()
    for r in runs:
        _same_run(r, base, bucketed=True)


def test_wide_layout_on_a_2d_mesh_matches_unsharded(monkeypatch):
    """pop 2 x model 2: the big bucket's forward splits each pop block
    over its grid row; the trajectory is the unsharded one."""
    graphs = [zoo.resnet50(), zoo.mobilenet_v2(), zoo.tiny_gpt()]
    cfg = EGRLConfig(pop_size=8, elites=2, boltzmann_frac=0.25, seed=0)
    base = ZooEGRL(graphs, cfg, mode="ea", device="cpu", pop_shards="off")
    monkeypatch.setenv("REPRO_MODEL_SHARDS", "2")
    wide = ZooEGRL(graphs, cfg, mode="ea", device="cpu", pop_shards=2,
                   devices=["cpu"] * 4)
    assert wide.pop_sharding.mesh.shape == {"pop": 2, "model": 2}
    assert wide.pop_sharding.padded(6, 2) == (8, 4)
    assert any(wide._wide_bucket) and not all(wide._wide_bucket)
    for _ in range(2):
        base.generation()
        wide.generation()
    _same_run(wide, base, bucketed=True)


def test_warm_start_and_migration_on_a_sharded_population():
    cfg = EGRLConfig(pop_size=10, seed=5)
    g = zoo.resnet50()
    base = EGRL(g, cfg, mode="egrl", device="cpu", pop_shards="off")
    shard = EGRL(g, cfg, mode="egrl", device="cpu", pop_shards=3,
                 devices=["cpu"] * 3)
    vec = np.random.default_rng(0).standard_normal(
        base.genome_size).astype(np.float32) * 0.1
    for drv in (base, shard):
        drv.warm_start(vec, gnn_frac=0.5)
    pad_g = shard.gnn_pop.cat("cpu")[shard.n_g:]
    assert torch.equal(_real(shard.gnn_pop, shard.n_g), base.gnn_pop)
    assert torch.equal(_real(shard.bz_pop, shard.n_b), base.bz_pop)
    np.testing.assert_array_equal(shard.best_gnn_vec(), vec)
    for _ in range(2):
        base.generation()
        shard.generation()
    _same_run(shard, base, bucketed=False)
    # migration lands on the shard holding row n_g - 1 (the last real
    # row: 8 GNN genomes over 3 shards of 3 rows -> shard 2, row 1)
    assert shard.n_g == 8 and shard.gnn_pop.offsets == [0, 3, 6, 9]
    assert torch.equal(shard.gnn_pop.block(2)[1], shard.learner.actor)
    assert pad_g.shape[0] == 1


def test_generation_spans():
    """The spans of ``EGRL`` and ``ZooEGRL`` as JAX emits them: rollout.gnn (rows, and in
    the zoo dispatch), rollout.boltzmann and evaluate under
    generation."""
    from repro_torch import obs
    cfg = EGRLConfig(pop_size=6, boltzmann_frac=0.34, elites=2, seed=1)
    with obs.override(mode="mem"):
        EGRL(zoo.resnet50(), cfg, mode="ea", device="cpu", pop_shards=2,
             devices=["cpu"] * 2).generation()
        ZooEGRL([zoo.resnet50(), zoo.tiny_gpt()], cfg, mode="ea",
                device="cpu", dispatch="async").generation()
        spans = [e for e in obs.events() if e.get("type") == "span"]
    by_name = {}
    for e in spans:
        by_name.setdefault(e["name"], []).append(e["attrs"])
    assert [a["rows"] for a in by_name["rollout.gnn"]] == [4, 4]
    assert by_name["rollout.gnn"][1]["dispatch"] is True
    assert [a["rows"] for a in by_name["rollout.boltzmann"]] == [2, 2]
    assert len(by_name["evaluate"]) == 2 and len(by_name["generation"]) == 2
