"""The ``Telemetry`` facade injected into engines, and its no-op twin.

Engines take ``telemetry=None`` and normalize via :func:`ensure`:

    self.tel = ensure(telemetry)
    ...
    if self.tel.enabled:
        self.tel.metrics.counter("fl.rounds").inc()
    with self.tel.span("round", track="server") as args:
        ...

``NullTelemetry`` makes the disabled path bit-identical and near-free: its
tracer never reads the clock, its metrics are a shared do-nothing object,
and ``span()`` is a no-op context manager — no branches on values, no
device sync, no allocation beyond the context-manager frame.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

from .exporters import write_jsonl, write_perfetto
from .metrics import MetricsRegistry, NullRegistry, runtime_metrics
from .tracer import NULL_TRACER, NullTracer, Tracer, _null_span

__all__ = ["NULL_TELEMETRY", "NullTelemetry", "Telemetry", "ensure"]


class Telemetry:
    """A tracer + metrics registry + export helpers for one run."""

    enabled = True

    def __init__(self, run_id: str = "run", meta: Optional[Dict[str, Any]] = None):
        self.run_id = run_id
        self.meta: Dict[str, Any] = dict(meta) if meta else {}
        self.tracer = Tracer()
        self.metrics = MetricsRegistry()

    # convenience passthroughs so call sites read `tel.span(...)`
    def span(self, name: str, **kw: Any):
        return self.tracer.span(name, **kw)

    def instant(self, name: str, **kw: Any) -> None:
        self.tracer.instant(name, **kw)

    def snapshot(self) -> dict:
        """Registry snapshot plus the process-wide runtime counters."""
        snap = self.metrics.snapshot()
        snap["runtime"] = runtime_metrics.snapshot()
        return snap

    def export_jsonl(self, path: str) -> int:
        return write_jsonl(
            path,
            self.tracer.events,
            run_id=self.run_id,
            meta=self.meta,
            metrics_snapshot=self.snapshot(),
        )

    def export_perfetto(self, path: str) -> int:
        return write_perfetto(path, self.tracer.events)


class NullTelemetry:
    """Disabled telemetry: every operation is a no-op."""

    __slots__ = ()

    enabled = False
    run_id = ""
    meta: Dict[str, Any] = {}
    tracer: NullTracer = NULL_TRACER
    metrics = NullRegistry()

    span = _null_span

    def instant(self, name: str, **_kw: Any) -> None:
        pass

    def snapshot(self) -> dict:
        return {}

    def export_jsonl(self, path: str) -> int:
        raise RuntimeError("telemetry is disabled; nothing to export")

    def export_perfetto(self, path: str) -> int:
        raise RuntimeError("telemetry is disabled; nothing to export")


NULL_TELEMETRY = NullTelemetry()


def ensure(telemetry: Union[Telemetry, NullTelemetry, None]):
    """Normalize an optional telemetry argument to a usable object."""
    return NULL_TELEMETRY if telemetry is None else telemetry
