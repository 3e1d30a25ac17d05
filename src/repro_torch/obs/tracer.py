"""Span/event tracer recording on host wall-clock and virtual clocks.

Two clock domains:

- ``WALL`` — host ``time.perf_counter`` seconds relative to the tracer's
  epoch (its construction time).  Live code paths open wall spans with the
  ``span()`` context manager.
- ``VIRTUAL`` — the async engine's simulated clock (seconds of modeled
  federation time).  Virtual spans are reconstructed *retroactively* when a
  completion event pops off the scheduler heap, via ``add_span``, because
  the virtual timeline is only known once the event fires.

Every event carries a ``track`` (a timeline row: ``"host"``, ``"server"``,
``"client/3"``, ``"serve"``, ...).  Well-formedness — spans on one
``(clock, track)`` row must nest or be disjoint, never partially overlap —
is checked by :func:`check_spans` and enforced in tests.

All recording is host-side Python appending to a list; nothing here touches
tensors or forces a device sync.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

__all__ = [
    "NULL_TRACER",
    "NullTracer",
    "Tracer",
    "VIRTUAL",
    "WALL",
    "check_spans",
]

WALL = "wall"
VIRTUAL = "virtual"
_CLOCKS = (WALL, VIRTUAL)


class Tracer:
    def __init__(self) -> None:
        self.epoch = time.perf_counter()
        self.events: List[dict] = []

    # -- clocks ----------------------------------------------------------
    def now(self) -> float:
        """Wall seconds since the tracer epoch."""
        return time.perf_counter() - self.epoch

    # -- recording -------------------------------------------------------
    def add_span(
        self,
        name: str,
        *,
        start: float,
        end: float,
        clock: str = WALL,
        cat: str = "host",
        track: str = "host",
        args: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Record a closed span ``[start, end]`` on ``clock``/``track``."""
        if clock not in _CLOCKS:
            raise ValueError(f"unknown clock {clock!r}")
        self.events.append(
            {
                "type": "span",
                "name": name,
                "cat": cat,
                "track": track,
                "clock": clock,
                "ts": float(start),
                "dur": max(0.0, float(end) - float(start)),
                "args": dict(args) if args else {},
            }
        )

    def instant(
        self,
        name: str,
        *,
        ts: Optional[float] = None,
        clock: str = WALL,
        cat: str = "host",
        track: str = "host",
        args: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Record a point event (defaults to wall-now)."""
        if clock not in _CLOCKS:
            raise ValueError(f"unknown clock {clock!r}")
        self.events.append(
            {
                "type": "instant",
                "name": name,
                "cat": cat,
                "track": track,
                "clock": clock,
                "ts": self.now() if ts is None else float(ts),
                "args": dict(args) if args else {},
            }
        )

    @contextmanager
    def span(
        self,
        name: str,
        *,
        cat: str = "host",
        track: str = "host",
        args: Optional[Dict[str, Any]] = None,
    ) -> Iterator[Dict[str, Any]]:
        """Live wall-clock span around a host-side block.

        Yields the span's ``args`` dict so the body can attach results
        (loss, byte counts, step counts) before the span closes.
        """
        span_args: Dict[str, Any] = dict(args) if args else {}
        start = self.now()
        try:
            yield span_args
        finally:
            self.add_span(
                name,
                start=start,
                end=self.now(),
                clock=WALL,
                cat=cat,
                track=track,
                args=span_args,
            )


@contextmanager
def _null_span(*_a: Any, **_k: Any) -> Iterator[Dict[str, Any]]:
    yield {}


class NullTracer:
    """No-op tracer: records nothing, never reads the clock."""

    __slots__ = ()

    epoch = 0.0
    events: List[dict] = []  # intentionally shared and always empty

    def now(self) -> float:
        return 0.0

    def add_span(self, name: str, **_kw: Any) -> None:
        pass

    def instant(self, name: str, **_kw: Any) -> None:
        pass

    span = _null_span


NULL_TRACER = NullTracer()


def check_spans(events: List[dict]) -> None:
    """Raise ``ValueError`` unless spans per ``(clock, track)`` nest cleanly.

    Spans on one timeline row must be either disjoint or strictly nested
    (one fully contains the other) — a partial overlap means an unclosed or
    mis-attributed span.  Used by the test suite as the well-formedness
    oracle for every engine's trace.
    """
    rows: Dict[tuple, List[dict]] = {}
    for ev in events:
        if ev.get("type") != "span":
            continue
        rows.setdefault((ev["clock"], ev["track"]), []).append(ev)
    for (clock, track), spans in rows.items():
        # sort by start asc, then end desc so a container precedes its children
        spans = sorted(spans, key=lambda s: (s["ts"], -(s["ts"] + s["dur"])))
        stack: List[tuple] = []  # (start, end, name)
        for s in spans:
            start, end = s["ts"], s["ts"] + s["dur"]
            while stack and start >= stack[-1][1]:
                stack.pop()
            if stack and end > stack[-1][1]:
                raise ValueError(
                    f"span {s['name']!r} [{start}, {end}] partially overlaps "
                    f"{stack[-1][2]!r} [{stack[-1][0]}, {stack[-1][1]}] "
                    f"on {clock}/{track}"
                )
            stack.append((start, end, s["name"]))
