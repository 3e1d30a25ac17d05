"""Counters, gauges, and histograms for the federation telemetry layer.

The registry is deliberately tiny: metrics are plain Python floats mutated
from host-side dispatch boundaries (never from device code), so
there is no locking, no background thread, and no device traffic.  A
``snapshot()`` is a plain ``dict`` ready for ``json.dumps`` — the benches
fold it into ``BENCH_*.json`` and the exporters embed it in the JSONL log.

Histograms use power-of-two buckets keyed by exponent: an observation ``v``
lands in bucket ``e`` where ``2**(e-1) < v <= 2**e`` (exact powers of two
land in their own exponent).  Non-positive observations land in the
``"-inf"`` bucket.  This gives stable, machine-independent bucket edges for
byte counts, staleness, latencies, and token counts alike.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_METRIC",
    "NullMetric",
    "NullRegistry",
    "runtime_metrics",
]


class Counter:
    """Monotonically increasing value (``inc`` only)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += float(n)


class Gauge:
    """Last-write-wins value (``set`` only)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


def _bucket_exponent(v: float) -> str:
    """Bucket key for ``v``: smallest ``e`` with ``v <= 2**e`` (or ``-inf``)."""
    if v <= 0.0:
        return "-inf"
    m, e = math.frexp(v)  # v == m * 2**e with 0.5 <= m < 1
    if m == 0.5:  # exact power of two: 2**(e-1)
        e -= 1
    return str(e)


class Histogram:
    """Power-of-two-bucketed distribution with count/sum/min/max."""

    __slots__ = ("count", "total", "vmin", "vmax", "buckets")

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.buckets: Dict[str, int] = {}

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        key = _bucket_exponent(v)
        self.buckets[key] = self.buckets.get(key, 0) + 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.vmin if self.count else None,
            "max": self.vmax if self.count else None,
            "mean": self.mean,
            "buckets": dict(self.buckets),
        }


class MetricsRegistry:
    """Name → metric store.  Getter methods create on first use.

    A name is bound to one metric kind for the registry's lifetime;
    asking for the same name as a different kind raises.
    """

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def _check_unique(self, name: str, kind: dict) -> None:
        for store in (self._counters, self._gauges, self._histograms):
            if store is not kind and name in store:
                raise ValueError(f"metric name {name!r} already bound to another kind")

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            self._check_unique(name, self._counters)
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            self._check_unique(name, self._gauges)
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            self._check_unique(name, self._histograms)
            h = self._histograms[name] = Histogram()
        return h

    def snapshot(self) -> dict:
        return {
            "counters": {k: c.value for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value for k, g in sorted(self._gauges.items())},
            "histograms": {
                k: h.snapshot() for k, h in sorted(self._histograms.items())
            },
        }

    def reset(self) -> None:
        self._counters.clear()
        self._gauges.clear()
        self._histograms.clear()


class NullMetric:
    """Accepts every mutation and does nothing.  Shared singleton."""

    __slots__ = ()

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


NULL_METRIC = NullMetric()


class NullRegistry:
    """Registry facade whose metrics are all the shared no-op metric."""

    __slots__ = ()

    def counter(self, name: str) -> NullMetric:
        return NULL_METRIC

    def gauge(self, name: str) -> NullMetric:
        return NULL_METRIC

    def histogram(self, name: str) -> NullMetric:
        return NULL_METRIC

    def snapshot(self) -> dict:
        return {"counters": {}, "gauges": {}, "histograms": {}}

    def reset(self) -> None:
        pass


# Process-wide registry for runtime-level signals that are not tied to one
# runner/engine instance.  The JAX package counts its jitted-program builds
# here; the port compiles no programs, so nothing writes to it yet and its
# snapshot is empty.
runtime_metrics = MetricsRegistry()
