"""Federation-wide observability: tracing, metrics, and trace export (a
copy of ``repro.obs``, which imports no JAX either; the port keeps its own).

``docs/observability.md`` is the API guide, the metric-name catalog and the
Perfetto how-to for both packages. One difference: the port has no compile
memo, so nothing counts into ``runtime_metrics`` (the JAX runner's
``jit.*`` counters and ``jit.*_traces`` gauges have no counterpart); the
registry stays, empty, so snapshots keep their ``"runtime"`` key.
"""
from .exporters import (
    SCHEMA_VERSION,
    SchemaError,
    validate_event,
    validate_jsonl,
    write_jsonl,
    write_perfetto,
)
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NullRegistry,
    runtime_metrics,
)
from .telemetry import NULL_TELEMETRY, NullTelemetry, Telemetry, ensure
from .tracer import NULL_TRACER, NullTracer, Tracer, VIRTUAL, WALL, check_spans

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_TELEMETRY",
    "NULL_TRACER",
    "NullRegistry",
    "NullTelemetry",
    "NullTracer",
    "SCHEMA_VERSION",
    "SchemaError",
    "Telemetry",
    "Tracer",
    "VIRTUAL",
    "WALL",
    "check_spans",
    "ensure",
    "runtime_metrics",
    "validate_event",
    "validate_jsonl",
    "write_jsonl",
    "write_perfetto",
]
