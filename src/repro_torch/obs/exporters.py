"""Exporters: structured JSONL event log + Perfetto/Chrome trace writer.

JSONL layout (one JSON object per line):

- line 1: ``{"type": "manifest", "schema": 1, "run_id": ..., "meta": {...}}``
- span / instant events as recorded by the tracer (see SCHEMA below)
- last line: ``{"type": "metrics", "snapshot": {...}}`` — the registry
  snapshot at export time.

The Perfetto writer emits the Chrome ``traceEvents`` JSON format that both
``chrome://tracing`` and https://ui.perfetto.dev load directly.  The two
clock domains become two processes — pid 1 ``wall`` (host seconds) and
pid 2 ``virtual`` (simulated federation seconds) — with one thread per
track, so an async run shows client lanes against the virtual clock next
to the host-side round loop.
"""
from __future__ import annotations

import json
from typing import IO, Any, Dict, Iterable, List, Union

from .tracer import VIRTUAL, WALL

__all__ = [
    "SCHEMA_VERSION",
    "SchemaError",
    "validate_event",
    "validate_jsonl",
    "write_jsonl",
    "write_perfetto",
]

SCHEMA_VERSION = 1

# type -> required field name -> allowed python types
_FIELDS: Dict[str, Dict[str, tuple]] = {
    "manifest": {"schema": (int,), "run_id": (str,), "meta": (dict,)},
    "metrics": {"snapshot": (dict,)},
    "span": {
        "name": (str,),
        "cat": (str,),
        "track": (str,),
        "clock": (str,),
        "ts": (int, float),
        "dur": (int, float),
        "args": (dict,),
    },
    "instant": {
        "name": (str,),
        "cat": (str,),
        "track": (str,),
        "clock": (str,),
        "ts": (int, float),
        "args": (dict,),
    },
}


class SchemaError(ValueError):
    """A JSONL line failed event-schema validation."""


def validate_event(obj: Any) -> str:
    """Validate one decoded event; returns its type or raises SchemaError."""
    if not isinstance(obj, dict):
        raise SchemaError(f"event must be an object, got {type(obj).__name__}")
    etype = obj.get("type")
    fields = _FIELDS.get(etype)
    if fields is None:
        raise SchemaError(f"unknown event type {etype!r}")
    for name, kinds in fields.items():
        if name not in obj:
            raise SchemaError(f"{etype} event missing field {name!r}")
        if not isinstance(obj[name], kinds) or isinstance(obj[name], bool):
            raise SchemaError(
                f"{etype} field {name!r} has type {type(obj[name]).__name__}"
            )
    if etype in ("span", "instant"):
        if obj["clock"] not in (WALL, VIRTUAL):
            raise SchemaError(f"unknown clock {obj['clock']!r}")
        if obj["ts"] < 0 or obj.get("dur", 0) < 0:
            raise SchemaError(f"{etype} {obj['name']!r} has negative ts/dur")
    return etype


def validate_jsonl(path: str) -> Dict[str, int]:
    """Validate a JSONL export; returns event-type counts or raises.

    Requires a leading manifest line and at least one metrics line.
    """
    counts: Dict[str, int] = {}
    with open(path, "r", encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                raise SchemaError(f"{path}:{lineno}: invalid JSON: {e}") from e
            try:
                etype = validate_event(obj)
            except SchemaError as e:
                raise SchemaError(f"{path}:{lineno}: {e}") from e
            if lineno == 1 and etype != "manifest":
                raise SchemaError(f"{path}: first line must be the manifest")
            counts[etype] = counts.get(etype, 0) + 1
    if counts.get("manifest", 0) != 1:
        raise SchemaError(f"{path}: expected exactly one manifest line")
    if counts.get("metrics", 0) < 1:
        raise SchemaError(f"{path}: missing metrics snapshot line")
    return counts


def write_jsonl(
    path: str,
    events: Iterable[dict],
    *,
    run_id: str = "run",
    meta: Union[Dict[str, Any], None] = None,
    metrics_snapshot: Union[Dict[str, Any], None] = None,
) -> int:
    """Write manifest + events + metrics snapshot; returns line count."""
    n = 0
    with open(path, "w", encoding="utf-8") as fh:
        manifest = {
            "type": "manifest",
            "schema": SCHEMA_VERSION,
            "run_id": run_id,
            "meta": dict(meta) if meta else {},
        }
        fh.write(json.dumps(manifest, sort_keys=True) + "\n")
        n += 1
        for ev in events:
            fh.write(json.dumps(ev, sort_keys=True, default=str) + "\n")
            n += 1
        snap = {
            "type": "metrics",
            "snapshot": metrics_snapshot if metrics_snapshot is not None else {},
        }
        fh.write(json.dumps(snap, sort_keys=True) + "\n")
        n += 1
    return n


_CLOCK_PIDS = {WALL: 1, VIRTUAL: 2}
_CLOCK_LABELS = {WALL: "wall clock (host s)", VIRTUAL: "virtual clock (sim s)"}


def _perfetto_events(events: Iterable[dict]) -> List[dict]:
    out: List[dict] = []
    tids: Dict[tuple, int] = {}
    for ev in events:
        etype = ev.get("type")
        if etype not in ("span", "instant"):
            continue
        pid = _CLOCK_PIDS[ev["clock"]]
        key = (pid, ev["track"])
        tid = tids.get(key)
        if tid is None:
            tid = tids[key] = len([k for k in tids if k[0] == pid]) + 1
            out.append(
                {
                    "ph": "M",
                    "name": "thread_name",
                    "pid": pid,
                    "tid": tid,
                    "args": {"name": ev["track"]},
                }
            )
        base = {
            "name": ev["name"],
            "cat": ev["cat"],
            "pid": pid,
            "tid": tid,
            "ts": ev["ts"] * 1e6,  # trace format wants microseconds
            "args": ev["args"],
        }
        if etype == "span":
            base["ph"] = "X"
            base["dur"] = ev["dur"] * 1e6
        else:
            base["ph"] = "i"
            base["s"] = "t"
        out.append(base)
    for clock, pid in _CLOCK_PIDS.items():
        out.append(
            {
                "ph": "M",
                "name": "process_name",
                "pid": pid,
                "tid": 0,
                "args": {"name": _CLOCK_LABELS[clock]},
            }
        )
    return out


def write_perfetto(path: str, events: Iterable[dict]) -> int:
    """Write a Chrome/Perfetto ``trace.json``; returns trace-event count."""
    trace_events = _perfetto_events(events)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(
            {"traceEvents": trace_events, "displayTimeUnit": "ms"},
            fh,
            sort_keys=True,
            default=str,
        )
    return len(trace_events)
