"""Thin federation control plane: launch / pause / checkpoint / resume
(port of ``repro.federated.service``).

:class:`FederationService` hosts one or more federations (each a
:class:`Federation` wrapping a :class:`repro_torch.core.fibecfed.FibecFed`
runner) in a single process and drives them cooperatively — one round per
running federation per :meth:`FederationService.tick`, round-robin — so two
tenants can share one card without threads. Per-round metrics stream
through each runner's ``repro_torch.obs`` telemetry (the runner already spans/meters its rounds; the service adds a
``service_round`` instant on its own track carrying the federation name).

Fault tolerance is delegated to :mod:`repro_torch.checkpoint.federation`: a
federation launched with ``ckpt_every=k`` snapshots its full run state
(runner + service bookkeeping) every k rounds and at completion, each
snapshot crash-consistent (manifest-last commit). ``launch(...,
resume=True)`` restores the newest complete snapshot into a freshly
constructed runner and continues as if the process had never died —
replaying nothing, losing nothing past the last snapshot. With
``ckpt_every=0`` no checkpoint I/O happens at all and the run is an exact
no-op relative to driving the runner by hand
(``tests/test_torch_service.py``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from repro_torch.checkpoint.federation import (
    latest_run_checkpoint,
    restore_runner,
    save_run_checkpoint,
)

# federation lifecycle states
CREATED = "created"
RUNNING = "running"
PAUSED = "paused"
COMPLETED = "completed"


class Federation:
    """One named FL run under service control.

    Owns the service-level bookkeeping the runner does not: the next round
    index, the per-round stats history, whether ``init_phase`` has run, and
    the checkpoint schedule. All of it rides in each snapshot's ``extra``
    block, so a resumed federation continues its history seamlessly.
    """

    def __init__(
        self,
        name: str,
        runner: Any,
        *,
        rounds: Optional[int] = None,
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 0,
        keep: int = 3,
    ):
        if ckpt_every < 0:
            raise ValueError("ckpt_every must be >= 0")
        if ckpt_every > 0 and not ckpt_dir:
            raise ValueError("ckpt_every > 0 requires a ckpt_dir")
        self.name = name
        self.runner = runner
        self.rounds = int(runner.fl.rounds if rounds is None else rounds)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = int(ckpt_every)
        self.keep = int(keep)
        self.state = CREATED
        self.next_round = 0
        self.initialized = False
        self.history: List[Dict[str, float]] = []

    # -- lifecycle ---------------------------------------------------------

    def try_resume(self) -> bool:
        """Restore the newest complete snapshot, if any. Returns whether one
        was found. The runner must be freshly constructed (same config)."""
        if not self.ckpt_dir:
            return False
        path = latest_run_checkpoint(self.ckpt_dir)
        if path is None:
            return False
        extra = restore_runner(self.runner, path)
        self.next_round = int(extra["next_round"])
        self.initialized = bool(extra["initialized"])
        self.history = list(extra["history"])
        self.state = COMPLETED if self.next_round >= self.rounds else CREATED
        return True

    def step(self) -> Optional[Dict[str, float]]:
        """Run one round (plus ``init_phase`` before the first); checkpoint
        on schedule. Returns the round's stats, or None if already done."""
        if self.state == COMPLETED or self.next_round >= self.rounds:
            self.state = COMPLETED
            return None
        if not self.initialized:
            self.runner.init_phase()
            self.initialized = True
        t = self.next_round
        stats = self.runner.run_round(t)
        self.next_round = t + 1
        record = {"round": float(t), **stats}
        self.history.append(record)
        tel = self.runner.tel
        if tel.enabled:
            tel.instant(
                "service_round",
                cat="service",
                track=f"federation/{self.name}",
                args={"round": t, "loss": stats.get("loss")},
            )
        done = self.next_round >= self.rounds
        if done:
            self.state = COMPLETED
        if self.ckpt_every and (done or self.next_round % self.ckpt_every == 0):
            self.checkpoint()
        return record

    def checkpoint(self) -> str:
        """Snapshot now (regardless of schedule). Returns the snapshot path."""
        if not self.ckpt_dir:
            raise ValueError(f"federation {self.name!r} has no ckpt_dir")
        return save_run_checkpoint(
            self.ckpt_dir,
            self.runner,
            self.next_round,
            keep=self.keep,
            extra={
                "name": self.name,
                "rounds": self.rounds,
                "next_round": self.next_round,
                "initialized": self.initialized,
                "history": self.history,
            },
        )

    def status(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "state": self.state,
            "engine": self.runner.engine,
            "next_round": self.next_round,
            "rounds": self.rounds,
            "last_loss": (
                self.history[-1].get("loss") if self.history else None
            ),
            "ckpt_dir": self.ckpt_dir,
        }


class FederationService:
    """Round-robin host for concurrent federations in one process."""

    def __init__(self):
        self._federations: Dict[str, Federation] = {}

    def launch(
        self,
        name: str,
        runner: Any,
        *,
        rounds: Optional[int] = None,
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 0,
        keep: int = 3,
        resume: bool = False,
    ) -> Federation:
        """Register a federation and mark it running.

        ``resume=True`` restores the newest complete snapshot under
        ``ckpt_dir`` into ``runner`` (which must be freshly constructed
        with the run's original configuration) before starting; with no
        snapshot present it simply starts from round 0.
        """
        if name in self._federations:
            raise ValueError(f"federation {name!r} already exists")
        fed = Federation(
            name,
            runner,
            rounds=rounds,
            ckpt_dir=ckpt_dir,
            ckpt_every=ckpt_every,
            keep=keep,
        )
        if resume:
            if not ckpt_dir:
                raise ValueError("resume=True requires a ckpt_dir")
            fed.try_resume()
        if fed.state != COMPLETED:
            fed.state = RUNNING
        self._federations[name] = fed
        return fed

    def _get(self, name: str) -> Federation:
        try:
            return self._federations[name]
        except KeyError:
            raise KeyError(f"no federation named {name!r}") from None

    def pause(self, name: str) -> None:
        fed = self._get(name)
        if fed.state == RUNNING:
            fed.state = PAUSED

    def resume(self, name: str) -> None:
        """Un-pause (the counterpart of :meth:`pause`; restoring from disk
        is ``launch(resume=True)``)."""
        fed = self._get(name)
        if fed.state == PAUSED:
            fed.state = RUNNING

    def checkpoint(self, name: str) -> str:
        return self._get(name).checkpoint()

    def status(self, name: Optional[str] = None):
        if name is not None:
            return self._get(name).status()
        return {n: f.status() for n, f in self._federations.items()}

    # -- drive -------------------------------------------------------------

    def tick(self) -> int:
        """One scheduling pass: one round for every RUNNING federation (in
        launch order). Returns the number of rounds executed."""
        ran = 0
        for fed in list(self._federations.values()):
            if fed.state != RUNNING:
                continue
            if fed.step() is not None:
                ran += 1
        return ran

    def run(self, max_steps: Optional[int] = None) -> int:
        """Tick until every federation is done (or ``max_steps`` rounds ran
        in total). Returns the total rounds executed."""
        total = 0
        while True:
            budget = None if max_steps is None else max_steps - total
            if budget is not None and budget <= 0:
                return total
            ran = self.tick()
            if ran == 0:
                return total
            total += ran


__all__ = [
    "Federation",
    "FederationService",
    "CREATED",
    "RUNNING",
    "PAUSED",
    "COMPLETED",
]
