"""The port's placement service (``serving/placement_service.py``),
its warm start (``ZooEGRL.prior_logits`` / ``warm_start``) and
``launch/serve_placements`` against the JAX package's, on the CPU at
small sizes (pop 4, budgets 1-2, classes 128 and 256).

Held to JAX: size classes; prior logits (1e-5) and the warm start on
JAX's draws (1e-6); ``_warm_logits`` given the same prior; the canonical
geometry's simulator results against JAX's ``w_max = n_class`` batch
(tiers bit for bit, latency 1e-6); the exact-cache hit/miss sequence and
hashes with ``nn`` off; the compiler fallback mapping; a directory the
JAX service persisted, served with 0 evaluator calls.  Within the port:
placements are deterministic in "off" and "step" and "thread:2" gives
"off"'s placements; faults fail alone; never worse than the compiler."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs its files in parallel workers, and
# the port's small CPU ops lose more to thread hand-offs than they gain
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import egrl as jegrl  # noqa: E402
from repro.core import gnn as jgnn  # noqa: E402
from repro.graphs import extract as jextract  # noqa: E402
from repro.memsim import batch as jmb  # noqa: E402
from repro.memsim import compiler as jcompiler  # noqa: E402
from repro.serving import placement_service as jps  # noqa: E402
from repro_torch.core.egrl import EGRLConfig, ZooEGRL  # noqa: E402
from repro_torch.graphs.extract import extract_for  # noqa: E402
from repro_torch.launch import serve_placements  # noqa: E402
from repro_torch.memsim import batch as mb  # noqa: E402
from repro_torch.memsim import compiler, simulator as sim  # noqa: E402
from repro_torch.serving.placement_service import (  # noqa: E402
    PlacementRequest, PlacementService, size_class)

# classes 128 (seamless, 68 nodes) and 256 (the rest, 142-202 nodes)
ARCHS = ["seamless-m4t-medium", "qwen3-0.6b", "mamba2-780m",
         "zamba2-1.2b", "granite-3-8b"]
SHAPES = ["decode_32k", "prefill_32k"]


def _svc(**kw):
    kw.setdefault("pop_size", 4)
    kw.setdefault("budget", 1)
    return PlacementService(seed=0, device="cpu", **kw)


def _stream(n=16, seed=0, archs=ARCHS):
    rng = np.random.default_rng(seed)
    return [PlacementRequest(i, archs[rng.integers(len(archs))],
                             SHAPES[rng.integers(len(SHAPES))])
            for i in range(n)]


def _by_id(results):
    return {r.request_id: r for r in results}


def _jax_canonical(n_class, graphs, batch_max=4):
    """JAX's canonical batch of ``graphs`` (placement_service.py:689)."""
    svc = jps.PlacementService(seed=0, batch=batch_max)
    return svc._canonical_batch(n_class, graphs)


def test_size_classes_equal_jax():
    for n in list(range(1, 70)) + [127, 128, 129, 255, 256, 257, 632, 1043]:
        assert size_class(n) == jps.size_class(n)
    assert [size_class(extract_for(a, s).n) for a in ARCHS for s in SHAPES] \
        == [jps.size_class(jextract.extract_for(a, s).n)
            for a in ARCHS for s in SHAPES]


def test_canonical_geometry_equals_jax_per_graph():
    """The port pads the ring to the batch's own width (a power of two),
    JAX to the class; every per-graph simulator result agrees."""
    rng = np.random.default_rng(0)
    for n_class, archs in ((128, ["seamless-m4t-medium"]),
                           (256, ["qwen3-0.6b", "granite-3-8b"])):
        graphs = [extract_for(a, "decode_32k") for a in archs]
        jgraphs = [jextract.extract_for(a, "decode_32k") for a in archs]
        _, batch = _svc()._canonical_batch(n_class, graphs)
        _, jb = _jax_canonical(n_class, jgraphs)
        assert batch.n_max == jb.n_max == n_class
        assert batch.w_max < jb.w_max == n_class
        assert batch.names == jb.names
        np.testing.assert_array_equal(batch.ref_latency.numpy(),
                                      np.asarray(jb.ref_latency))
        maps = rng.integers(0, 3, (3, 4, n_class, 2)).astype(np.int32)
        got = mb.evaluate_population_zoo(batch, torch.as_tensor(maps))
        want = jmb.evaluate_population_zoo(jb, jnp.asarray(maps))
        for k in ("eps", "valid"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
        for gi in range(4):
            n = batch.sizes[gi]
            np.testing.assert_array_equal(
                got["rectified"][:, gi, :n].numpy(),
                np.asarray(want["rectified"])[:, gi, :n])
        for k in ("latency", "reward", "speedup"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6)


@pytest.fixture(scope="module")
def warm_setup():
    """The JAX and port drivers over one class-128 canonical batch, and a
    JAX-initialised genome as the prior."""
    graphs = [extract_for("seamless-m4t-medium", s) for s in SHAPES]
    jgraphs = [jextract.extract_for("seamless-m4t-medium", s)
               for s in SHAPES]
    filled, batch = _svc()._canonical_batch(128, graphs)
    jfilled, jb = _jax_canonical(128, jgraphs)
    drv = ZooEGRL(filled, EGRLConfig(pop_size=4, seed=5), mode="ea",
                  zoo=batch, device="cpu")
    jdrv = jegrl.ZooEGRL(jfilled, jegrl.EGRLConfig(pop_size=4, seed=5),
                         mode="ea", zoo=jb)
    vec = np.asarray(jgnn.flatten_params(jgnn.init_gnn(
        jax.random.PRNGKey(7), batch.n_features)))
    return drv, jdrv, vec, graphs, jgraphs


def test_prior_logits_equal_jax(warm_setup):
    drv, jdrv, vec, _, _ = warm_setup
    got = drv.prior_logits(vec).numpy()
    want = np.asarray(jdrv.prior_logits(vec))
    assert got.shape == want.shape == (4 * 128, 2, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_warm_start_on_jax_draws_equals_jax(warm_setup):
    drv, jdrv, vec, _, _ = warm_setup
    logits = np.asarray(jdrv.prior_logits(vec))
    # JAX's draws, replayed from its key (core/egrl.py:326-341)
    key = jdrv.key
    n_seed = max(1, int(round(0.5 * jdrv.n_g)))
    gnn_noise, bz_noise = [], []
    for _ in range(n_seed - 1):
        key, k = jax.random.split(key)
        gnn_noise.append(np.asarray(jax.random.normal(k, vec.shape)))
    for _ in range(jdrv.n_b):
        key, k = jax.random.split(key)
        bz_noise.append(np.asarray(jax.random.normal(k, logits.shape[:2])))
    drv.gnn_pop = torch.tensor(np.array(jdrv.gnn_pop))
    drv.bz_pop = torch.tensor(np.array(jdrv.bz_pop))
    jdrv.warm_start(vec, logits=logits)
    drv.warm_start(vec, logits=logits,
                   gnn_noise=torch.as_tensor(np.stack(gnn_noise)),
                   bz_noise=torch.as_tensor(np.stack(bz_noise)))
    assert np.array_equal(drv.gnn_pop[0].numpy(), vec)
    np.testing.assert_allclose(drv.gnn_pop.numpy(),
                               np.asarray(jdrv.gnn_pop), rtol=0, atol=1e-6)
    np.testing.assert_allclose(drv.bz_pop.numpy(), np.asarray(jdrv.bz_pop),
                               rtol=0, atol=1e-6)
    # drawn from the driver's generator, the prior's logits by default
    drv.warm_start(vec)
    assert np.array_equal(drv.gnn_pop[0].numpy(), vec)
    np.testing.assert_allclose(drv.bz_pop.numpy()[:, :4 * 128 * 6],
                               np.tile(logits.reshape(1, -1),
                                       (drv.n_b, 1)), atol=1e-5)


def test_warm_logits_equal_jax(warm_setup):
    drv, jdrv, vec, graphs, jgraphs = warm_setup
    svc, jsvc = _svc(), jps.PlacementService(seed=0)
    items = [(g.canonical_hash(), g) for g in graphs]
    jitems = [(g.canonical_hash(), g) for g in jgraphs]
    assert [h for h, _ in items] == [h for h, _ in jitems]
    rng = np.random.default_rng(1)
    seeds = {items[1][0]: rng.integers(0, 3, (graphs[1].n, 2))}
    jsvc._prior_vec = vec
    want = jsvc._warm_logits(jdrv, 128, jitems, seeds, vec)
    got = svc._warm_logits(drv, 128, items, seeds, vec, True)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    seeded = np.abs(want) == 4.0
    assert seeded.any() and np.array_equal(got[seeded], want[seeded])
    jsvc._prior_vec = None
    np.testing.assert_array_equal(
        svc._warm_logits(drv, 128, items, seeds, vec, False),
        jsvc._warm_logits(jdrv, 128, jitems, seeds, vec))


def _fake_refine(jsvc, rng):
    """A JAX ``_refine_class`` that compiles nothing: a random mapping
    per graph, served as a compiler answer."""
    def refine(n_class, items):
        return {h: {"mapping": rng.integers(0, 3, (g.n, 2)).astype(np.int32),
                    "speedup": 1.0, "latency_ms": 1.0,
                    "ref_latency_ms": 1.0, "source": "compiler"}
                for h, g in items}
    jsvc._refine_class = refine


def test_hit_miss_sequence_and_hashes_equal_jax():
    """With ``nn`` off, which requests hit the exact cache does not depend
    on any random draw: the port's sequence is JAX's."""
    reqs = _stream(16, seed=3) + [PlacementRequest(99, "nope", "train_4k"),
                                  PlacementRequest(98, "qwen3-0.6b",
                                                   "long_500k")]
    jsvc = jps.PlacementService(seed=0, nn="off")
    _fake_refine(jsvc, np.random.default_rng(0))
    want = _by_id(jsvc.run(reqs))
    svc = _svc(nn="off")
    got = _by_id(svc.run(reqs))
    assert sorted(got) == sorted(want)
    for i in want:
        assert (got[i].status, got[i].cache_hit, got[i].graph_hash) == \
            (want[i].status, want[i].cache_hit, want[i].graph_hash), i
        assert (got[i].error is None) == (want[i].error is None)
    assert got[99].error == want[99].error
    st, jst = svc.stats(), jsvc.stats()
    # (the JAX stub does not count evaluator calls)
    for k in ("served", "hits", "misses", "failed", "cache_size", "ticks"):
        assert st[k] == jst[k], k


def test_compiler_fallback_equals_jax():
    svc = _svc(budget=1)
    res = svc.run([PlacementRequest(0, "seamless-m4t-medium", "decode_32k"),
                   PlacementRequest(1, "qwen3-0.6b", "decode_32k")])
    for r in res:
        entry = svc._cache[r.graph_hash]
        g = jextract.extract_for(r.arch, r.shape)
        cmap, ref = jcompiler.compiler_reference(g)
        if r.source == "compiler":
            np.testing.assert_array_equal(r.mapping, np.asarray(cmap))
            assert r.speedup == 1.0
        assert entry["ref_latency_ms"] == pytest.approx(ref * 1e3, rel=1e-6)


def _placements(results):
    return {r.graph_hash: (r.source, r.speedup, r.latency_ms,
                           r.mapping.tobytes())
            for r in results if r.ok}


@pytest.fixture(scope="module")
def off_run():
    reqs = _stream(18, seed=1)
    svc = _svc(budget=2)
    return reqs, svc.run(reqs), svc


def test_off_and_step_runs_are_deterministic(off_run):
    reqs, first, svc = off_run
    for slots in ("off", "step"):
        again = _svc(budget=2, slots=slots).run(reqs)
        assert _placements(again) == _placements(first)
        if slots == "off":
            assert [(r.request_id, r.cache_hit) for r in again] == \
                [(r.request_id, r.cache_hit) for r in first]
    assert sorted(r.request_id for r in first) == list(range(len(reqs)))
    assert {size_class(extract_for(r.arch, r.shape).n) for r in first} \
        == {128, 256}
    assert svc.evaluator_calls >= 3


def test_thread_two_equals_off(off_run):
    reqs, first, _ = off_run
    svc = _svc(budget=2, slots="thread:2")
    got = svc.run(reqs)
    assert _placements(got) == _placements(first)
    assert sorted((r.request_id, r.cache_hit) for r in got) == \
        sorted((r.request_id, r.cache_hit) for r in first)
    assert svc.stats()["queued"] == 0 and not svc._slots


def test_served_never_worse_than_the_compiler(off_run):
    """Each served mapping, re-evaluated by the plain simulator, gives
    the reported latency and a speedup of at least 1.0 over the compiler
    reference's latency; the service's counters account for every
    simulator and GAT call it made.  (A compiler fallback is the
    rectified heuristic mapping, which the rectifier does not always
    leave as it is: on qwen3-0.6b prefill_32k it moves 0.32 of the bytes
    again, in the JAX package too, so its "valid" flag is not checked.)"""
    _, results, svc = off_run
    for r in results:
        g = extract_for(r.arch, r.shape)
        _, ref = compiler.compiler_reference(g, "cpu")
        res = sim.evaluate(sim.build_sim_graph(g, "cpu"),
                           torch.as_tensor(r.mapping), ref)
        lat = float(res["latency"])
        assert lat * 1e3 == pytest.approx(r.latency_ms, rel=1e-6)
        assert ref / lat >= 1.0 - 1e-7 and r.speedup >= 1.0
        assert r.source == "compiler" or bool(res["valid"])
    c = svc.metrics.snapshot()["counters"]
    gens = sum(v for k, v in c.items() if k.startswith("generations"))
    assert gens == 2 * svc.evaluator_calls
    assert c["prior_forwards"] >= 1          # every batch after the first
    assert c["compiler_refs"] >= 4 * svc.evaluator_calls


def test_fault_isolation():
    svc = _svc()
    bad = extract_for("mamba2-780m", "decode_32k").canonical_hash()
    orig = svc._refine_class

    def flaky(n_class, items):
        if any(h == bad for h, _ in items):
            raise RuntimeError("simulated evaluator crash")
        return orig(n_class, items)

    svc._refine_class = flaky
    assert svc.submit(PlacementRequest(0, "qwen3-0.6b", "decode_32k")) is None
    assert svc.submit(PlacementRequest(1, "mamba2-780m", "decode_32k")) \
        is None
    res = _by_id(svc.run_until_drained())
    assert res[0].ok and not res[1].ok
    assert "simulated evaluator crash" in res[1].error
    assert bad not in svc._cache and svc.stats()["faults"] >= 1
    bad_arch = svc.submit(PlacementRequest(2, "no-such-arch", "decode_32k"))
    assert not bad_arch.ok and "unknown arch" in bad_arch.error
    svc._refine_class = orig
    after = _by_id(svc.run([PlacementRequest(3, "qwen3-0.6b", "decode_32k"),
                            PlacementRequest(4, "mamba2-780m",
                                             "decode_32k")]))
    assert after[3].cache_hit and after[4].ok and not after[4].cache_hit


def test_neighbour_is_rescored_and_seeds_refinement():
    """A one-node variant of a cached graph is re-scored on its class
    geometry; not beating the compiler, it seeds the refinement."""
    svc = _svc()
    [base] = svc.run([PlacementRequest(0, "qwen3-0.6b", "decode_32k")])
    g = extract_for("qwen3-0.6b", "decode_32k")
    nodes = list(g.nodes)
    nodes[5] = dataclasses.replace(nodes[5],
                                   weight_bytes=nodes[5].weight_bytes * 3)
    near = dataclasses.replace(g, nodes=nodes)
    r = svc.submit(PlacementRequest(1, "near", "decode_32k"), graph=near)
    assert svc.metrics.counter("nn_rescored").value == 1
    if r is None:
        assert near.canonical_hash() in svc._nbr_seeds
        [done] = svc.run_until_drained()
        assert done.ok and done.speedup >= 1.0
    else:
        assert r.nn_hit and r.speedup > 1.0


def test_jax_persisted_directory_served_by_the_port(tmp_path):
    d = str(tmp_path / "svc")
    reqs = _stream(10, seed=2)
    jsvc = jps.PlacementService(seed=0, persist=d)
    _fake_refine(jsvc, np.random.default_rng(4))
    want = _by_id(jsvc.run(reqs))
    prior = np.asarray(jgnn.flatten_params(jgnn.init_gnn(
        jax.random.PRNGKey(3), 19)))
    jsvc._prior_vec = prior
    jsvc.persist()

    svc = _svc(persist=d)
    got = _by_id(svc.run(reqs))
    assert svc.evaluator_calls == 0
    for i, r in got.items():
        assert r.cache_hit and r.graph_hash == want[i].graph_hash
        np.testing.assert_array_equal(r.mapping, want[i].mapping)
    assert np.array_equal(svc._prior_vec, prior)
    # a graph it has not seen refines, warm-started from the JAX prior
    new = svc.run([PlacementRequest(100, "granite-3-8b", "train_4k")])
    assert new[0].ok and not new[0].cache_hit and svc.evaluator_calls == 1
    assert svc.metrics.counter("prior_forwards").value == 1
    # the port's own directory restores with its prior, and in the JAX
    # service, which answers the stream from it
    again = _svc(persist=d)
    assert again.evaluator_calls == 0 and len(again._cache) == len(svc._cache)
    assert np.array_equal(again._prior_vec, svc._prior_vec)
    jagain = jps.PlacementService(seed=0, persist=d)
    jgot = _by_id(jagain.run(reqs))
    assert jagain.evaluator_calls == 0
    for i, r in jgot.items():
        assert r.cache_hit
        np.testing.assert_array_equal(r.mapping, got[i].mapping)


def test_serve_placements_summary():
    reqs = serve_placements.synthetic_stream(6, seed=0, archs=ARCHS[:2])
    jreqs = __import__("repro.launch.serve_placements",
                       fromlist=["x"]).synthetic_stream(6, seed=0,
                                                        archs=ARCHS[:2])
    assert reqs == [PlacementRequest(r.request_id, r.arch, r.shape)
                    for r in jreqs]
    results, summary, svc = serve_placements.serve(
        reqs, pop_size=4, budget=1, device="cpu", log=None)
    assert summary["ok"] == summary["requests"] == 6
    assert summary["cache_hits"] == svc.stats()["hits"]
    assert summary["evaluator_calls"] == svc.evaluator_calls
    assert summary["mean_speedup"] >= 1.0
