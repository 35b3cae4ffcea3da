"""Span tracer: context-manager spans with parent/child nesting,
monotonic-clock durations and structured attributes.

- **Nesting** is a per-thread stack on the tracer (``threading.local``)
  — spans opened on a worker thread (the placement service's
  ``slots=thread`` refinement) form their own root-level subtree
  and can never pop a span belonging to another thread.  Span ids are
  allocated under a lock so they stay unique across threads, and sink
  fan-out is serialized so concurrent closes never tear a JSONL line.
- **The clock is injectable** (any ``() -> float`` in seconds;
  default ``time.perf_counter``), so tests drive a ``FakeClock`` and
  assert EXACT durations instead of sleeping.
- **Exceptions close spans**: ``__exit__`` records the exception as an
  ``error`` attribute and re-raises, so a fault mid-batch leaves a
  complete, attributed trace (the placement-service fault-isolation
  path depends on this — see tests/test_obs.py).
- **Sinks** receive one dict per CLOSED span (children before parents,
  ids link the tree): an in-memory ring always, plus a flush-per-line
  JSONL file in ``jsonl`` mode so a crashed process still leaves a
  readable trace.

Event schema (see docs/observability.md):

    {"type": "span", "name": ..., "id": int, "parent": int|null,
     "ts": seconds-since-tracer-epoch, "dur_ms": float, "attrs": {...}}

The off-mode hot path never reaches this module: ``repro_torch.obs.span``
returns the shared ``NOOP_SPAN`` singleton — no allocation, no clock
read, no sink touch.

Copied from ``src/repro/obs/trace.py`` (stdlib only).
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Callable, List, Optional


def _json_default(o):
    # numpy scalars and other non-JSON attrs degrade to str, never raise
    try:
        return float(o)
    except Exception:
        return str(o)


class RingSink:
    """Bounded in-memory event ring (every non-off mode feeds it).
    ``drain()`` empties it — tests and in-process reporting use the
    ring as ground truth without touching the filesystem."""

    def __init__(self, maxlen: int = 16384):
        self._ring: deque = deque(maxlen=maxlen)

    def emit(self, event: dict) -> None:
        self._ring.append(event)

    def drain(self) -> List[dict]:
        out = list(self._ring)
        self._ring.clear()
        return out

    def peek(self) -> List[dict]:
        return list(self._ring)


class JsonlSink:
    """Append events as JSON lines, one flush per event, so a crashed
    or killed process still leaves every closed span on disk."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a")

    def emit(self, event: dict) -> None:
        self._f.write(json.dumps(event, default=_json_default) + "\n")
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class _NoopSpan:
    """The entire off-mode span surface: a shared, attribute-free
    singleton whose methods do nothing.  ``repro_torch.obs.span`` hands it
    back without allocating, so instrumentation left in place costs one
    mode check per call site when tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


NOOP_SPAN = _NoopSpan()


class Span:
    """One timed region.  Use as a context manager; ``set(**attrs)``
    attaches attributes at any point before close (e.g. outcomes known
    only at the end of the block)."""
    __slots__ = ("_tracer", "name", "id", "parent", "attrs", "_t0")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.id: Optional[int] = None
        self.parent: Optional[int] = None
        self._t0 = 0.0

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        self._tracer._open(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is not None:
            self.attrs["error"] = f"{exc_type.__name__}: {exc}"
        self._tracer._close(self)
        return False


class Tracer:
    """Span factory + open-span stack + sink fan-out.  ``clock`` is any
    monotonic ``() -> float`` in seconds; the tracer's first reading
    becomes the trace epoch (``ts`` fields are relative to it)."""

    def __init__(self, sinks, clock: Callable[[], float] = time.perf_counter):
        self.sinks = list(sinks)
        self.clock = clock
        self.epoch = clock()
        self._next_id = 0
        self._lock = threading.Lock()      # id allocation + sink fan-out
        self._local = threading.local()    # per-thread open-span stack

    @property
    def _stack(self) -> List[Span]:
        """The CALLING thread's open-span stack (lazily created) — a
        worker thread's spans nest among themselves and root at
        ``parent=null``, never under another thread's open span."""
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def now(self) -> float:
        """Seconds since the trace epoch."""
        return self.clock() - self.epoch

    def emit(self, event: dict) -> None:
        with self._lock:
            for s in self.sinks:
                s.emit(event)

    def _open(self, span: Span) -> None:
        with self._lock:
            span.id = self._next_id
            self._next_id += 1
        stack = self._stack
        span.parent = stack[-1].id if stack else None
        stack.append(span)
        span._t0 = self.clock()       # last: exclude bookkeeping from dur

    def _close(self, span: Span) -> None:
        t1 = self.clock()
        # tolerate out-of-order closes (a leaked span) without wedging;
        # the stack is thread-local, so this can only pop spans the
        # CLOSING thread itself leaked open
        stack = self._stack
        while stack and stack[-1] is not span:
            stack.pop()
        if stack:
            stack.pop()
        self.emit({"type": "span", "name": span.name, "id": span.id,
                   "parent": span.parent,
                   "ts": round(span._t0 - self.epoch, 6),
                   "dur_ms": round((t1 - span._t0) * 1e3, 6),
                   "attrs": span.attrs})
