"""Counters, gauges and fixed-bucket histograms for the flight
recorder (see ``repro_torch.obs``).

Design constraints, in order:

- **Always-on.**  Metrics are plain Python int/float adds into
  pre-allocated slots — cheap enough to run unconditionally, so
  service bookkeeping (``PlacementService.stats()``, bench summaries)
  can be REBASED on them and stay correct whatever ``REPRO_OBS`` says.
  Only event *emission* (spans, logs) is mode-gated.
- **Fixed log-spaced buckets.**  Histograms never store samples: a
  bucket increment per observation, with edges fixed at construction
  (default: 4 buckets per decade spanning 1 us .. 100 s, in ms).
  Quantiles are upper-edge estimates — exact to bucket resolution,
  which is ~78% spacing at 4/decade, plenty for "where did the
  12-second miss batch go" questions and immune to outlier storms.
- **Label support.**  A registry key is (kind, name, sorted labels),
  so ``histogram("wall_ms", path="hit")`` and ``path="miss"`` are
  distinct series; ``snapshot()`` renders them Prometheus-style
  (``wall_ms{path=hit}``).

Copied from ``src/repro/obs/metrics.py``, with one change: counters and
histograms update under a lock, since the placement service's refinement
threads count into them beside the main thread (``+=`` is a
read-modify-write the interpreter lock does not make atomic).
"""
from __future__ import annotations

import math
import threading
from bisect import bisect_left
from typing import Dict, Optional, Sequence, Tuple


def log_edges(lo: float = 1e-3, hi: float = 1e5,
              per_decade: int = 4) -> Tuple[float, ...]:
    """Log-spaced bucket edges: ``per_decade`` buckets per factor of 10
    from ``lo`` to ``hi`` inclusive.  The default covers 1 us .. 100 s
    when observations are in milliseconds."""
    n = round(math.log10(hi / lo) * per_decade)
    return tuple(lo * 10 ** (i / per_decade) for i in range(n + 1))


DEFAULT_EDGES = log_edges()

_LOCK = threading.Lock()      # counter and histogram updates


class Counter:
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name, self.labels, self.value = name, labels, 0

    def inc(self, n: int = 1) -> None:
        with _LOCK:
            self.value += n


class Gauge:
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name, self.labels, self.value = name, labels, 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-edge histogram: bucket ``i`` holds observations in
    ``(edges[i-1], edges[i]]`` (boundary values land at their own
    edge); the trailing slot is the ``> edges[-1]`` overflow."""
    __slots__ = ("name", "labels", "edges", "counts", "count", "total",
                 "vmin", "vmax")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...],
                 edges: Optional[Sequence[float]] = None):
        self.name, self.labels = name, labels
        self.edges = tuple(edges) if edges is not None else DEFAULT_EDGES
        self.counts = [0] * (len(self.edges) + 1)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        with _LOCK:
            self.counts[bisect_left(self.edges, v)] += 1
            self.count += 1
            self.total += v
            if v < self.vmin:
                self.vmin = v
            if v > self.vmax:
                self.vmax = v

    def quantile(self, q: float) -> float:
        """Upper-edge estimate of the ``q``-quantile (q in [0, 1]):
        the smallest bucket edge covering at least ``q`` of the
        observations.  Overflow resolves to the exact max."""
        if not self.count:
            return 0.0
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= target and c:
                return self.edges[i] if i < len(self.edges) else self.vmax
        return self.vmax

    def summary(self) -> Dict[str, float]:
        if not self.count:
            return {"count": 0}
        return {"count": self.count, "sum": round(self.total, 6),
                "min": round(self.vmin, 6), "max": round(self.vmax, 6),
                "p50": round(self.quantile(0.50), 6),
                "p99": round(self.quantile(0.99), 6)}


def _series(name: str, labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


class MetricsRegistry:
    """Get-or-create registry of named metric series.  One process-wide
    instance lives in ``repro_torch.obs``; components that need isolated
    counting (each ``PlacementService``) hold their own."""

    def __init__(self):
        self._metrics: Dict[tuple, object] = {}

    def _get(self, cls, name: str, labels: dict, **kw):
        key = (cls.__name__, name, tuple(sorted(labels.items())))
        m = self._metrics.get(key)
        if m is None:
            m = self._metrics[key] = cls(name, key[2], **kw)
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str,
                  edges: Optional[Sequence[float]] = None,
                  **labels) -> Histogram:
        h = self._get(Histogram, name, labels, edges=edges)
        return h

    def snapshot(self) -> dict:
        """JSON-ready view of every series (the ``metrics`` event
        payload; also what ``trace_report`` renders)."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for m in self._metrics.values():
            s = _series(m.name, m.labels)
            if isinstance(m, Counter):
                out["counters"][s] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][s] = m.value
            else:
                out["histograms"][s] = m.summary()
        return out
