"""The port's bucket dispatcher and bucket-count autotune
(``distributed.dispatch``) against the JAX package's: the LPT packing,
the time model, the K that ``autotune_bucket_k`` chooses from the same
probe times at 1 and 4 devices, the policy gating, an "async"
``ZooEGRL`` bit-equal to the serial one, and ``measure()``."""
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

from repro.distributed import dispatch as jdispatch  # noqa: E402
from repro.graphs import zoo as jzoo  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core.egrl import EGRLConfig, ZooEGRL  # noqa: E402
from repro_torch.distributed import dispatch  # noqa: E402
from repro_torch.graphs import bucketed, zoo  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ENV_KNOBS = ("REPRO_POP_SHARDS", "REPRO_MODEL_SHARDS",
             "REPRO_BUCKET_DISPATCH", "REPRO_ZOO_BUCKETS")
GRAPHS = ["resnet50", "mobilenet_v2", "tiny_gpt", "bert"]


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ENV_KNOBS:
        monkeypatch.delenv(k, raising=False)


def test_lpt_and_time_model_match_jax():
    rng = np.random.default_rng(3)
    for _ in range(40):
        costs = list(np.round(rng.uniform(0.1, 9.0, rng.integers(1, 9)), 1))
        for bins in (1, 2, 3, 4, 8):
            assert dispatch._lpt_assign(costs, bins) == \
                jdispatch._lpt_assign(costs, bins)
            assert dispatch._lpt_makespan(costs, bins) == \
                jdispatch._lpt_makespan(costs, bins)
    for pts in ([(4, 64, 0.5 + 2e-6 * 4 * 64 ** 2),
                 (4, 128, 0.5 + 2e-6 * 4 * 128 ** 2),
                 (8, 256, 0.5 + 2e-6 * 8 * 256 ** 2)],
                [(4, 64, 3.0)],                        # one point
                [(2, 100, 5.0), (2, 1000, 1.0)],       # degenerate slope
                [(3, 57, 0.71), (2, 123, 0.93), (2, 1043, 9.4)]):
        model = dispatch.fit_time_model(pts)
        assert model == jdispatch.fit_time_model(pts)
        for g, n in ((1, 57), (7, 1043), (3, 388)):
            assert dispatch.predict_bucket_ms(model, g, n) == \
                jdispatch.predict_bucket_ms(model, g, n)


def _fake_probe(z, **kw):
    """Probe ms from a fixed model of the bucket's (G, N_max)."""
    return {k: 0.6 + 1.5e-6 * b.n_graphs * b.n_max ** 2
            for k, b in enumerate(z.buckets)}


def test_autotune_chooses_jax_k_at_1_and_4_devices(monkeypatch):
    monkeypatch.setattr(dispatch, "_probe_bucket_ms", _fake_probe)
    monkeypatch.setattr(dispatch, "_AUTOTUNE_CACHE", {})
    monkeypatch.setattr(dispatch, "_AUTOTUNE_REPORT", {})
    monkeypatch.setattr(jdispatch, "_probe_bucket_ms", _fake_probe)
    monkeypatch.setattr(jdispatch, "_AUTOTUNE_CACHE", {})
    graphs = [zoo.WORKLOADS[n]() for n in GRAPHS]
    # JAX at 4 devices: a subprocess with 4 forced host devices
    code = f"""
import jax
from repro.distributed import dispatch
from repro.graphs import zoo
def probe(z, **kw):
    return {{k: 0.6 + 1.5e-6 * b.n_graphs * b.n_max ** 2
            for k, b in enumerate(z.buckets)}}
dispatch._probe_bucket_ms = probe
assert len(jax.devices()) == 4
print(dispatch.autotune_bucket_k([zoo.WORKLOADS[n]() for n in {GRAPHS!r}]))
"""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    want4 = json.loads(res.stdout.strip().splitlines()[-1])
    import jax
    assert len(jax.devices()) == 1
    want1 = jdispatch.autotune_bucket_k(
        [jzoo.WORKLOADS[n]() for n in GRAPHS])
    with obs.override(mode="mem"):
        got1 = dispatch.autotune_bucket_k(graphs, device="cpu")
        got4 = dispatch.autotune_bucket_k(graphs, device="cpu",
                                          devices=["cpu"] * 4)
        spans = [e for e in obs.events() if e.get("name") ==
                 "bucket_autotune"]
    assert (got1, got4) == (want1, want4)
    assert len(spans) == 2 and spans[1]["attrs"]["chosen_k"] == got4
    assert {"predicted_ms", "c0", "n_dev"} <= set(spans[0]["attrs"])
    # cached: the probe does not run again
    monkeypatch.setattr(dispatch, "_probe_bucket_ms", None)
    assert dispatch.autotune_bucket_k(graphs, device="cpu") == got1
    rep = dispatch.autotune_report(graphs, device="cpu", devices=["cpu"] * 4)
    assert rep["chosen_k"] == got4 and rep["n_dev"] == 4
    assert sorted(rep["probe_ms"]) == list(range(len(rep["probe_buckets"])))


def test_dispatch_gating(monkeypatch):
    zb = bucketed.build_bucketed_zoo(
        [zoo.resnet50(), zoo.mobilenet_v2(), zoo.tiny_gpt()], device="cpu")
    assert zb.n_buckets >= 2
    assert dispatch.resolve_dispatch_policy() == "auto"
    assert not dispatch.BucketDispatcher(zb, policy="auto").active
    assert not dispatch.BucketDispatcher(zb, policy="off",
                                         devices=["cpu"] * 4).active
    assert dispatch.BucketDispatcher(zb, policy="auto",
                                     devices=["cpu"] * 2).active
    d = dispatch.BucketDispatcher(zb, policy="async")
    assert d.active and d.device_map() == {k: 0 for k in
                                           range(zb.n_buckets)}
    d = dispatch.BucketDispatcher(zb, policy="async", devices=["cpu"] * 3)
    assert sorted(d.device_map()) == list(range(zb.n_buckets))
    assert set(d.device_map().values()) <= {0, 1, 2}
    assert d.time_model() is None
    single = bucketed.build_bucketed_zoo([zoo.resnet50()], "off",
                                         device="cpu")
    assert not dispatch.BucketDispatcher(single, policy="async").active
    for bad in ("sideways", "on"):
        with pytest.raises(ValueError, match="REPRO_BUCKET_DISPATCH"):
            dispatch.BucketDispatcher(zb, policy=bad)
        with pytest.raises(ValueError, match="REPRO_BUCKET_DISPATCH"):
            jdispatch.resolve_dispatch_policy(bad)
    monkeypatch.setenv("REPRO_BUCKET_DISPATCH", "async")
    assert dispatch.BucketDispatcher(zb).active
    with pytest.raises(ValueError, match="not of the search's device type"):
        dispatch.BucketDispatcher(zb, policy="async",
                                  devices=["cpu", "cuda:0"])


@pytest.mark.parametrize("mode", ["ea", "egrl"])
def test_async_zoo_generation_bit_equal_to_serial(mode):
    graphs = [zoo.resnet50(), zoo.mobilenet_v2(), zoo.tiny_gpt()]
    cfg = EGRLConfig(pop_size=6, boltzmann_frac=0.34, elites=2, seed=0)
    serial = ZooEGRL(graphs, cfg, mode=mode, device="cpu", pop_shards="off",
                     dispatch="off", devices=["cpu"] * 3)
    asyncd = ZooEGRL(graphs, cfg, mode=mode, device="cpu", pop_shards="off",
                     dispatch="async", devices=["cpu"] * 3)
    auto = ZooEGRL(graphs, cfg, mode=mode, device="cpu", dispatch="auto")
    assert serial.dispatch is None and auto.dispatch is None
    assert asyncd.dispatch is not None and asyncd.zoo.n_buckets >= 2
    # sharding and dispatch are either/or
    both = ZooEGRL(graphs, cfg, mode=mode, device="cpu", pop_shards=2,
                   dispatch="async", devices=["cpu"] * 2)
    assert both.pop_sharding.active and both.dispatch is None
    for _ in range(3):
        assert serial.generation() == asyncd.generation()
    assert np.array_equal(serial.best_reward, asyncd.best_reward)
    for a, b in zip(serial.best_mapping, asyncd.best_mapping):
        assert np.array_equal(a, b)
    assert torch.equal(serial.gnn_pop, asyncd.gnn_pop)
    assert torch.equal(serial.bz_pop, asyncd.bz_pop)


def test_measure_fills_the_time_model_and_reassigns():
    graphs = [zoo.resnet50(), zoo.mobilenet_v2(), zoo.tiny_gpt()]
    zb = bucketed.build_bucketed_zoo(graphs, device="cpu")
    d = dispatch.BucketDispatcher(zb, policy="async", devices=["cpu"] * 2)
    proxy = d.device_map()
    pop = torch.zeros((3, 87040))
    with obs.override(mode="mem"):
        ms = d.measure(pop, reps=1)
    assert sorted(ms) == list(range(zb.n_buckets))
    assert all(v > 0.0 for v in ms.values())
    assert d.time_model() == ms
    assert d.device_map() == dict(enumerate(dispatch._lpt_assign(
        [ms[k] for k in range(zb.n_buckets)], 2)))
    assert sorted(d.device_map()) == sorted(proxy)
    for k, v in ms.items():
        assert obs.gauge(f"dispatch.bucket{k}_ms").value == v
