"""The port's flight recorder (``repro_torch.obs``) against the JAX
package's on the same calls: metrics snapshots, histogram edges, counts
and quantiles, span trees (nesting, exact durations on a fake clock,
child sums, error attributes), mode gating, JSONL output, the logger's
event, and span trees kept per thread.  Also: the counters stay exact
under concurrent increments, and ``profile_block`` writes a Chrome trace
with ``torch.profiler``."""
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs its files in parallel workers, and
# the port's small CPU ops lose more to thread hand-offs than they gain
torch.set_num_threads(1)

from _fake_clock import FakeClock  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro_torch import obs  # noqa: E402


@pytest.fixture(autouse=True)
def _isolate_obs_state():
    """Tests that configure the global state must not leak it."""
    prev, jprev = obs._STATE, jobs._STATE
    yield
    for mod, p in ((obs, prev), (jobs, jprev)):
        if mod._STATE is not p and mod._STATE is not None:
            mod._STATE.close()
        mod._STATE = p


def _metric_calls(mod):
    """The same metric calls on one package's registry; returns it."""
    r = mod.MetricsRegistry()
    rng = np.random.default_rng(0)
    r.counter("served").inc(3)
    r.counter("served").inc()
    r.counter("hits", path="a").inc(2)
    r.gauge("occupancy").set(7.5)
    for v in rng.lognormal(mean=1.0, sigma=3.0, size=200):
        r.histogram("wall_ms", path="hit").observe(float(v))
    for v in (0.5, 1.0, 10.0, 10.1, 100.0, 1000.0):
        r.histogram("edges", edges=(1.0, 10.0, 100.0)).observe(v)
    r.histogram("empty")
    return r


def test_metrics_equal_jax():
    mine, ref = _metric_calls(obs), _metric_calls(jobs)
    assert mine.snapshot() == ref.snapshot()
    for name, labels in (("wall_ms", {"path": "hit"}), ("edges", {})):
        h, rh = mine.histogram(name, **labels), ref.histogram(name, **labels)
        assert h.edges == rh.edges and h.counts == rh.counts
        for q in (0.0, 0.1, 0.25, 0.5, 0.9, 0.99, 1.0):
            assert h.quantile(q) == rh.quantile(q)
    assert obs.log_edges() == jobs.log_edges()
    assert obs.log_edges(1.0, 1e3, 3) == jobs.log_edges(1.0, 1e3, 3)


def _span_calls(mod, clock):
    """One nested span tree with attributes, an error and an event."""
    with mod.override(mode="mem", clock=clock):
        with mod.span("submit", request_id=1) as sp:
            clock.advance(0.25)
            with mod.span("extract"):
                clock.advance(0.5)
            with mod.span("hash") as h:
                clock.advance(0.125)
                h.set(n=3)
            sp.set(outcome="miss")
        with pytest.raises(RuntimeError):
            with mod.span("tick"):
                with mod.span("refine_class", n_class=256):
                    clock.advance(1.0)
                    raise RuntimeError("poisoned")
        mod.emit_event({"type": "log", "msg": "hello"})
        mod.get_logger("t").info("line", k=1)
        return mod.drain()


def test_span_tree_equals_jax():
    mine = _span_calls(obs, FakeClock())
    ref = _span_calls(jobs, FakeClock())
    assert mine == ref
    spans = {e["name"]: e for e in mine if e.get("type") == "span"}
    assert spans["submit"]["dur_ms"] == 875.0
    assert spans["extract"]["parent"] == spans["submit"]["id"]
    kids = sum(e["dur_ms"] for e in mine if e.get("type") == "span"
               and e["parent"] == spans["submit"]["id"])
    assert kids <= spans["submit"]["dur_ms"]
    assert spans["refine_class"]["attrs"]["error"] == \
        "RuntimeError: poisoned"
    assert spans["tick"]["attrs"]["error"] == "RuntimeError: poisoned"


def test_mode_gating_and_jsonl_equal_jax(tmp_path, monkeypatch):
    for mod, name in ((obs, "mine"), (jobs, "ref")):
        with mod.override(mode="off"):
            assert mod.span("x") is mod.NOOP_SPAN
            mod.emit_event({"type": "log"})
            assert mod.drain() == [] and not mod.enabled()
        path = tmp_path / f"{name}.jsonl"
        with mod.override(mode="jsonl", path=str(path), clock=FakeClock()):
            with mod.span("a", k=np.float32(1.5)):
                with mod.span("b"):
                    pass
            ring = mod.events()
        lines = [json.loads(x) for x in path.read_text().splitlines()]
        assert lines == json.loads(json.dumps(ring, default=float))
    assert (tmp_path / "mine.jsonl").read_text() == \
        (tmp_path / "ref.jsonl").read_text()
    monkeypatch.setenv("REPRO_OBS", "verbose")
    with pytest.raises(ValueError, match="REPRO_OBS"):
        obs.reset()


def test_spans_root_per_thread():
    """A worker thread's spans root on their own thread, never under the
    main thread's open span, in both packages."""
    out = {}
    for mod in (obs, jobs):
        with mod.override(mode="mem"):
            with mod.span("main"):
                t = threading.Thread(target=lambda: mod.span("w").__enter__()
                                     .__exit__(None, None, None))
                t.start()
                t.join(10)
                assert not t.is_alive()
            out[mod] = {e["name"]: e["parent"] for e in mod.drain()}
    assert out[obs] == out[jobs] == {"w": None, "main": None}


def test_counters_exact_under_threads():
    import sys
    r = obs.MetricsRegistry()
    c, h = r.counter("n"), r.histogram("h")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                c.inc()
                h.observe(1.0)
        ts = [threading.Thread(target=work) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert c.value == 16000 and h.count == 16000 and sum(h.counts) == 16000


def test_profile_block_writes_a_torch_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_OBS_PROFILE", str(tmp_path / "prof"))
    monkeypatch.setattr(obs, "_PROFILED", False)
    with obs.profile_block():
        torch.ones(8).sum()
    traces = list((tmp_path / "prof").glob("*.json"))
    assert len(traces) == 1
    assert "traceEvents" in json.loads(traces[0].read_text())
    with obs.profile_block():          # only the first block is traced
        pass
    assert len(list((tmp_path / "prof").glob("*.json"))) == 1
