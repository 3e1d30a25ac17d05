"""Slot-based continuous-batching scheduler (pure Python; port of
``repro.serve.scheduler``).

The engine owns a fixed pool of cache slots; requests queue FIFO and are
admitted into freed slots between decode segments. Admission happens
in *groups*: the longest FIFO-prefix run of requests sharing a prefill shape
signature (prompt length + extras shapes), so each group is one batched
prefill call. The scheduler only does bookkeeping — all device state lives in
the engine — and enforces the slot invariants (no double-assign, no
double-release) by raising rather than corrupting a tenant's cache rows.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Tuple

from repro_torch.obs import ensure
from repro_torch.serve.requests import Request


def _signature(req: Request):
    shape_of = lambda v: tuple(getattr(v, "shape", (len(v),)))
    extras = req.extras or {}
    return (shape_of(req.tokens), tuple(sorted((k, shape_of(v)) for k, v in extras.items())))


class SlotScheduler:
    def __init__(self, num_slots: int, telemetry=None):
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        self.num_slots = num_slots
        self.tel = ensure(telemetry)
        self._free = deque(range(num_slots))
        self._busy: Dict[int, Request] = {}
        self._queue: deque = deque()

    @property
    def queued(self) -> int:
        return len(self._queue)

    @property
    def active(self) -> int:
        return len(self._busy)

    @property
    def free(self) -> int:
        return len(self._free)

    def enqueue(self, req: Request) -> None:
        self._queue.append(req)
        if self.tel.enabled:
            self._gauges()

    def _gauges(self) -> None:
        m = self.tel.metrics
        m.gauge("serve.queue_depth").set(float(len(self._queue)))
        m.gauge("serve.slots_free").set(float(len(self._free)))

    def admissions(self) -> List[Tuple[List[int], List[Request]]]:
        """Assign queued requests to free slots; returns [(slots, requests)].

        Groups are FIFO-prefix runs with equal shape signatures; a new
        signature starts a new group (its own prefill shape). Stops when
        either the queue or the free pool is exhausted.
        """
        groups: List[Tuple[List[int], List[Request]]] = []
        while self._free and self._queue:
            sig = _signature(self._queue[0])
            slots: List[int] = []
            reqs: List[Request] = []
            while self._free and self._queue and _signature(self._queue[0]) == sig:
                req = self._queue.popleft()
                slot = self._free.popleft()
                if slot in self._busy:
                    raise RuntimeError(f"slot {slot} double-assigned")
                self._busy[slot] = req
                slots.append(slot)
                reqs.append(req)
            groups.append((slots, reqs))
        if groups and self.tel.enabled:
            self.tel.metrics.counter("serve.admission_groups").inc(len(groups))
            self._gauges()
        return groups

    def release(self, slot: int) -> Request:
        if slot not in self._busy:
            raise RuntimeError(f"release of slot {slot} which is not busy")
        req = self._busy.pop(slot)
        self._free.append(slot)
        if self.tel.enabled:
            self._gauges()
        return req
