"""Process-global metrics registry: counters, gauges, log-bucket
histograms.

One registry per process (module-level :data:`REGISTRY`); fabric
components create named instruments at import/construction time and the
``fab.metrics`` RPC (registered by every Engine) serves one uniform
snapshot.  This supersedes the ad-hoc per-component ``stats()`` dicts —
those remain as *views* for callers that hold the object, but the wire
export is the registry.

Instruments are keyed ``name{label=value,...}``; labels are optional and
should stay low-cardinality (service names, not request ids).
Histograms bucket by powers of two of the observed value (milliseconds
by convention, suffix the name ``_ms``), which keeps the export tiny at
any volume.
"""
from __future__ import annotations

import math
import threading
from typing import Any, Callable, Dict, Optional


def _key(name: str, labels: Dict[str, Any]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic counter."""

    __slots__ = ("key", "_v", "_lock")

    def __init__(self, key: str):
        self.key = key
        self._v = 0  #: guarded-by _lock
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._v


class Gauge:
    """Last-written value, or a live callback."""

    __slots__ = ("key", "_v", "_fn")

    def __init__(self, key: str, fn: Optional[Callable[[], float]] = None):
        self.key = key
        self._v = 0.0
        self._fn = fn

    def set(self, v: float) -> None:
        self._v = float(v)

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:
                return self._v
        return self._v


class Histogram:
    """Log2-bucketed histogram: bucket k counts observations in
    ``(2^(k-1), 2^k]`` (bucket 0 holds v ≤ 1)."""

    __slots__ = ("key", "_lock", "count", "sum", "max", "buckets")

    def __init__(self, key: str):
        self.key = key
        self._lock = threading.Lock()
        self.count = 0  #: guarded-by _lock
        self.sum = 0.0  #: guarded-by _lock
        self.max = 0.0  #: guarded-by _lock
        self.buckets: Dict[int, int] = {}  #: guarded-by _lock

    def observe(self, v: float) -> None:
        v = float(v)
        k = 0 if v <= 1.0 else math.ceil(math.log2(v))
        with self._lock:
            self.count += 1
            self.sum += v
            if v > self.max:
                self.max = v
            self.buckets[k] = self.buckets.get(k, 0) + 1

    def quantile(self, q: float) -> float:
        """Upper bucket bound at quantile ``q`` (coarse by design)."""
        with self._lock:
            if not self.count:
                return 0.0
            target = q * self.count
            acc = 0
            for k in sorted(self.buckets):
                acc += self.buckets[k]
                if acc >= target:
                    return float(2 ** k)
            return float(2 ** max(self.buckets))

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "count": self.count,
                "sum": round(self.sum, 3),
                "avg": round(self.sum / self.count, 3) if self.count else 0.0,
                "max": round(self.max, 3),
                "buckets": {f"le_{2 ** k}": n
                            for k, n in sorted(self.buckets.items())},
            }


class MetricsRegistry:
    """Name → instrument table.  Instrument getters are idempotent: the
    same key always returns the same object, so module-level and
    per-instance callers share one counter."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}  #: guarded-by _lock
        self._gauges: Dict[str, Gauge] = {}  #: guarded-by _lock
        self._histograms: Dict[str, Histogram] = {}  #: guarded-by _lock

    def counter(self, name: str, **labels: Any) -> Counter:
        key = _key(name, labels)
        with self._lock:
            c = self._counters.get(key)
            if c is None:
                c = self._counters[key] = Counter(key)
            return c

    def gauge(self, name: str, fn: Optional[Callable[[], float]] = None,
              **labels: Any) -> Gauge:
        key = _key(name, labels)
        with self._lock:
            g = self._gauges.get(key)
            if g is None or fn is not None:
                g = self._gauges[key] = Gauge(key, fn)
            return g

    def histogram(self, name: str, **labels: Any) -> Histogram:
        key = _key(name, labels)
        with self._lock:
            h = self._histograms.get(key)
            if h is None:
                h = self._histograms[key] = Histogram(key)
            return h

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
        return {
            "counters": {k: c.value for k, c in sorted(counters.items())},
            "gauges": {k: round(g.value, 4) for k, g in sorted(gauges.items())},
            "histograms": {k: h.snapshot() for k, h in sorted(hists.items())},
        }


REGISTRY = MetricsRegistry()

# module-level conveniences bound to the process-global registry
counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
snapshot = REGISTRY.snapshot
