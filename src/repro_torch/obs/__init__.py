"""Flight recorder: process-wide metrics registry + span tracer for the
EGRL loop and the placement service.  Dependency-free (stdlib only;
torch is imported lazily inside the optional profiler hook).

Copied from ``src/repro/obs/__init__.py``; ``profile_block`` brackets
its block with ``torch.profiler`` instead of ``jax.profiler``.

Mode (``REPRO_OBS``, parsed fail-loud via utils/envpolicy.py):

- ``off``  (default) — spans are the shared no-op singleton: no event,
  no allocation, no clock read.  METRICS stay live (plain int adds) so
  ``PlacementService.stats()`` and the bench summaries — which are
  rebased on obs counters — are correct in every mode.
- ``mem``  — events stream into a bounded in-memory ring
  (``drain()`` / ``events()``).
- ``jsonl`` — the ring PLUS an append-mode, flush-per-event JSONL file
  at ``REPRO_OBS_PATH`` (default ``obs_trace.jsonl``), consumed by
  tools/trace_report.py.

``REPRO_OBS_PROFILE=<dir>`` additionally brackets the FIRST EGRL
generation of the process with a ``torch.profiler`` window and writes
its Chrome trace into ``<dir>`` (one generation keeps the device trace
small; failures degrade to a warning — profiling must never take the
training loop down).

Span taxonomy and event schema: docs/observability.md.

Usage::

    from repro_torch import obs
    with obs.span("evolve", n_class=256) as sp:
        ...
        sp.set(generations=4)
    obs.counter("hits").inc()
    obs.histogram("wall_ms", path="hit").observe(3.2)

Tests and benches swap state explicitly: ``override(mode=..., path=...,
clock=...)`` is a context manager restoring the previous state (the
bench_serve overhead A/B uses it to alternate off/jsonl on one warmed
service); ``configure`` rebuilds in place; ``reset`` drops back to the
environment policy.
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Callable, List, Optional

from repro_torch.obs.log import Logger, get_logger, set_quiet    # noqa: F401
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                     MetricsRegistry, log_edges)
from repro_torch.obs.trace import (NOOP_SPAN, JsonlSink,         # noqa: F401
                                   RingSink, Span, Tracer)
from repro_torch.utils.envpolicy import env_policy

DEFAULT_PATH = "obs_trace.jsonl"
MODES = ("off", "mem", "jsonl")


class ObsState:
    """One (mode, sinks, tracer) configuration.  Swapped wholesale by
    configure/override/reset so a mode change can never leave a stale
    sink list behind."""

    def __init__(self, mode: str, path: str,
                 clock: Optional[Callable[[], float]] = None,
                 ring_size: int = 16384):
        self.mode = mode
        self.path = path
        self.ring = RingSink(ring_size)
        self.jsonl: Optional[JsonlSink] = None
        sinks = [self.ring]
        if mode == "jsonl":
            self.jsonl = JsonlSink(path)
            sinks.append(self.jsonl)
        self.tracer = Tracer(sinks) if clock is None else Tracer(sinks, clock)

    def close(self) -> None:
        if self.jsonl is not None:
            self.jsonl.close()


_STATE: Optional[ObsState] = None
# process-wide metrics: ALWAYS live, independent of the trace mode (see
# the module docstring); components needing isolated series (each
# PlacementService) hold their own MetricsRegistry
_REGISTRY = MetricsRegistry()


def _state() -> ObsState:
    global _STATE
    if _STATE is None:
        m = env_policy("REPRO_OBS", choices=MODES, default="off")
        _STATE = ObsState(m, os.environ.get("REPRO_OBS_PATH", DEFAULT_PATH))
    return _STATE


def configure(mode: Optional[str] = None, path: Optional[str] = None,
              clock: Optional[Callable[[], float]] = None) -> ObsState:
    """Rebuild the global obs state with explicit values (unspecified
    fields keep their current resolution).  Closes the previous JSONL
    sink; the ring starts empty."""
    global _STATE
    cur = _state()
    cur.close()
    _STATE = ObsState(mode if mode is not None else cur.mode,
                      path if path is not None else cur.path, clock)
    return _STATE


def reset() -> ObsState:
    """Drop the state and re-read ``REPRO_OBS`` / ``REPRO_OBS_PATH``
    from the environment (fail-loud immediately on a bad value)."""
    global _STATE
    if _STATE is not None:
        _STATE.close()
    _STATE = None
    return _state()


@contextmanager
def override(mode: Optional[str] = None, path: Optional[str] = None,
             clock: Optional[Callable[[], float]] = None):
    """Temporarily swap mode/path/clock; the previous state (and its
    still-open sinks) is restored on exit, the temporary one closed."""
    global _STATE
    prev = _state()
    tmp = ObsState(mode if mode is not None else prev.mode,
                   path if path is not None else prev.path, clock)
    _STATE = tmp
    try:
        yield tmp
    finally:
        tmp.close()
        _STATE = prev


def mode() -> str:
    return _state().mode


def enabled() -> bool:
    return _state().mode != "off"


def span(name: str, **attrs):
    """A context-manager span, or the no-op singleton when tracing is
    off — the one mode check on the hot path."""
    st = _state()
    if st.mode == "off":
        return NOOP_SPAN
    return st.tracer.span(name, **attrs)


def emit_event(event: dict) -> None:
    """Emit a non-span event (log lines, metrics snapshots) into the
    current sinks; dropped silently when off."""
    st = _state()
    if st.mode == "off":
        return
    event.setdefault("ts", round(st.tracer.now(), 6))
    st.tracer.emit(event)


def drain() -> List[dict]:
    """Empty and return the in-memory ring."""
    return _state().ring.drain()


def events() -> List[dict]:
    """Peek the in-memory ring without draining."""
    return _state().ring.peek()


def registry() -> MetricsRegistry:
    return _REGISTRY


def counter(name: str, **labels) -> Counter:
    return _REGISTRY.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return _REGISTRY.gauge(name, **labels)


def histogram(name: str, edges=None, **labels) -> Histogram:
    return _REGISTRY.histogram(name, edges=edges, **labels)


def emit_metrics(reg: Optional[MetricsRegistry] = None) -> None:
    """Emit a ``metrics`` snapshot event of ``reg`` (default: the
    process-wide registry); no-op when off."""
    emit_event({"type": "metrics",
                "snapshot": (reg if reg is not None else _REGISTRY).snapshot()})


_PROFILED = False


@contextmanager
def profile_block():
    """``REPRO_OBS_PROFILE=<dir>``: bracket the wrapped block — the
    FIRST EGRL generation of the process — with a torch.profiler window
    (CPU and, where there is a card, CUDA activity) and write its Chrome
    trace to ``<dir>/generation_<pid>.json``.  Without the env var (or
    after the first use) this is a no-op; a profiler failure logs a
    warning and the block runs untraced."""
    global _PROFILED
    outdir = os.environ.get("REPRO_OBS_PROFILE")
    if not outdir or _PROFILED:
        yield
        return
    _PROFILED = True
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    try:
        prof = profile(activities=acts)
        prof.start()
    except Exception as e:
        get_logger("obs").warning(
            f"REPRO_OBS_PROFILE: could not start torch profiler: {e}")
        yield
        return
    try:
        yield
    finally:
        try:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.stop()
            os.makedirs(outdir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(outdir, f"generation_{os.getpid()}.json"))
        except Exception as e:
            get_logger("obs").warning(
                f"REPRO_OBS_PROFILE: could not write torch profiler "
                f"trace: {e}")
