"""Device-heterogeneity scenarios for the async FL scheduler (virtual time);
a copy of ``repro.federated.hetero``.

Real FL cohorts are heterogeneous in *system* terms on top of non-IID data:
devices differ in compute speed, links add latency, phones drop off chargers
mid-round, and availability comes in bursts (overnight charging windows).
The synchronous engines barrier every round on the slowest chosen client, so
their measured rounds/sec only transfers to deployments when devices are
homogeneous. This module models the system axis so the event-driven
scheduler (:mod:`repro_torch.federated.async_agg`) can replay a round sequence on
a *virtual clock* and measure wall-clock-to-target under skew.

The model, deliberately minimal and fully deterministic given a seed:

* every client ``i`` has a static speed multiplier ``speed[i]`` (1.0 = the
  reference device; 4.0 = a 4x-slower straggler), assigned by partitioning a
  seeded permutation of the client ids into a slow and a fast group;
* a local round of ``n`` curriculum steps costs
  ``n * step_time * speed[i] * jitter`` virtual seconds, with ``jitter`` a
  lognormal draw (sigma ``jitter_sigma``; exactly 1.0 when sigma is 0 — no
  RNG is consumed, keeping the homogeneous scenario bit-deterministic);
* each pull/push transfer adds ``comm_latency`` virtual seconds;
* a dispatched client drops with probability ``dropout_prob`` (it never
  reports back; the scheduler replaces it);
* with ``burst_period > 0`` clients only *start* at burst boundaries
  (``ceil(clock / period) * period``) — arrivals are bunched, not Poisson.

:class:`ScenarioPreset` is a frozen spec; presets compose with
:meth:`ScenarioPreset.compose` (elementwise worst case of each axis) or are
tweaked with :meth:`ScenarioPreset.with_`. :meth:`ScenarioPreset.bind`
freezes per-client assignments + an RNG stream into a :class:`BoundScenario`
that the scheduler queries. ``SCENARIOS`` is the named registry accepted by
``FibecFed(engine="async", scenario=...)``.

``sync_round_time`` prices a *synchronous* round under the same scenario
(the max over the cohort of per-client time — the barrier), which is what
makes sync-vs-async virtual wall-clock comparisons apples-to-apples.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Union

import numpy as np


# FibecFed binds its scenario with seed = runner_seed + this offset, keeping
# scenario randomness off the cohort-sampling stream; benchmarks re-bind with
# the same offset to price the synchronous barrier under identical speeds.
SCENARIO_SEED_OFFSET = 0x5EED


@dataclasses.dataclass(frozen=True)
class ScenarioPreset:
    """Composable spec of one system-heterogeneity regime.

    All fields are virtual-time or probability knobs; ``1.0`` speed and all
    zeros elsewhere is the homogeneous scenario in which the async engine
    must reduce exactly to the synchronous ones.

    Fields (all keyword-constructible; ``with_`` tweaks a copy):

    * ``name`` — registry key (``SCENARIOS``) and compose label;
    * ``slow_fraction`` — fraction of clients assigned to the slow group
      (a seeded permutation picks which);
    * ``slow_factor`` — the slow group's speed multiplier (>= 1.0; 4.0 =
      a 4x straggler);
    * ``jitter_sigma`` — lognormal sigma on per-dispatch compute time
      (0 = deterministic, consumes no RNG);
    * ``dropout_prob`` — probability a dispatched client never reports
      back (i.i.d. per dispatch, in [0, 1));
    * ``comm_latency`` — virtual seconds per transfer (a round trip pays
      it twice: pull + push);
    * ``burst_period`` — > 0 aligns dispatch starts to multiples of this
      period (bunched arrivals, e.g. overnight charging windows);
    * ``step_time`` — virtual seconds per curriculum step on the
      reference (speed 1.0) device;
    * ``slow_rank_fraction`` — the slow group's LoRA rank budget as a
      fraction of the server rank (resource-adaptive rank, AFLoRA-style):
      a constrained device trains/ships only the first
      ``max(1, round(fraction * server_rank))`` rank components;
    * ``bandwidth_factor`` — the slow group's per-transfer latency
      multiplier (>= 1; a 2.0 device pays double ``comm_latency`` per
      pull/push).
    """

    name: str = "uniform"
    slow_fraction: float = 0.0  # fraction of clients in the slow group
    slow_factor: float = 1.0  # slow group's speed multiplier (>= 1)
    jitter_sigma: float = 0.0  # lognormal sigma on per-dispatch compute time
    dropout_prob: float = 0.0  # P(dispatched client never completes)
    comm_latency: float = 0.0  # virtual seconds per transfer (pull or push)
    burst_period: float = 0.0  # > 0: dispatches wait for the next burst tick
    step_time: float = 1.0  # virtual seconds per curriculum step (speed 1.0)
    slow_rank_fraction: float = 1.0  # slow group's LoRA rank / server rank
    bandwidth_factor: float = 1.0  # slow group's comm-latency multiplier

    def __post_init__(self):
        if self.slow_factor < 1.0:
            raise ValueError("slow_factor is a slowdown; must be >= 1.0")
        if not 0.0 <= self.slow_fraction <= 1.0:
            raise ValueError("slow_fraction must be in [0, 1]")
        if not 0.0 <= self.dropout_prob < 1.0:
            raise ValueError("dropout_prob must be in [0, 1)")
        if not 0.0 < self.slow_rank_fraction <= 1.0:
            raise ValueError("slow_rank_fraction must be in (0, 1]")
        if self.bandwidth_factor < 1.0:
            raise ValueError("bandwidth_factor is a slowdown; must be >= 1.0")

    def with_(self, **overrides) -> "ScenarioPreset":
        """A tweaked copy (e.g. ``STRAGGLER.with_(slow_factor=8.0)``)."""
        return dataclasses.replace(self, **overrides)

    def compose(self, other: "ScenarioPreset", name: Optional[str] = None) -> "ScenarioPreset":
        """Elementwise worst case of two presets — skew, drops, jitter and
        latency all stack, which is how real deployments misbehave."""
        return ScenarioPreset(
            name=name or f"{self.name}+{other.name}",
            slow_fraction=max(self.slow_fraction, other.slow_fraction),
            slow_factor=max(self.slow_factor, other.slow_factor),
            jitter_sigma=max(self.jitter_sigma, other.jitter_sigma),
            dropout_prob=max(self.dropout_prob, other.dropout_prob),
            comm_latency=max(self.comm_latency, other.comm_latency),
            burst_period=max(self.burst_period, other.burst_period),
            step_time=max(self.step_time, other.step_time),
            slow_rank_fraction=min(self.slow_rank_fraction, other.slow_rank_fraction),
            bandwidth_factor=max(self.bandwidth_factor, other.bandwidth_factor),
        )

    @property
    def _constrains_slow_group(self) -> bool:
        return (
            self.slow_factor > 1.0
            or self.slow_rank_fraction < 1.0
            or self.bandwidth_factor > 1.0
        )

    def bind(self, num_clients: int, seed: int = 0) -> "BoundScenario":
        """Freeze per-client speed assignments and the scenario RNG stream."""
        rng = np.random.default_rng(seed)
        speed = np.ones(num_clients, np.float64)
        rank_fraction = np.ones(num_clients, np.float64)
        bandwidth = np.ones(num_clients, np.float64)
        n_slow = int(round(self.slow_fraction * num_clients))
        # one permutation assigns every slow-group axis (speed, rank budget,
        # link bandwidth) — constrained devices are the same devices, which
        # is the regime rank adaptation is for. Drawn only when some axis is
        # actually constrained, so inert presets consume no RNG.
        if n_slow and self._constrains_slow_group:
            slow_ids = rng.permutation(num_clients)[:n_slow]
            speed[slow_ids] = self.slow_factor
            rank_fraction[slow_ids] = self.slow_rank_fraction
            bandwidth[slow_ids] = self.bandwidth_factor
        return BoundScenario(
            preset=self, speed=speed, rng=rng,
            rank_fraction=rank_fraction, bandwidth=bandwidth,
        )


@dataclasses.dataclass
class BoundScenario:
    """A preset bound to a concrete client population + RNG stream.

    The scheduler owns one of these; all randomness (jitter, dropout) comes
    from ``rng``, which is independent of the runner's client-sampling RNG so
    heterogeneity never perturbs cohort selection equivalence.
    """

    preset: ScenarioPreset
    speed: np.ndarray  # (num_clients,) multiplier, 1.0 = reference device
    rng: np.random.Generator
    # per-client resource axes; all-ones = the unconstrained fleet
    rank_fraction: Optional[np.ndarray] = None  # LoRA rank / server rank
    bandwidth: Optional[np.ndarray] = None  # comm-latency multiplier

    def __post_init__(self):
        if self.rank_fraction is None:
            self.rank_fraction = np.ones_like(self.speed)
        if self.bandwidth is None:
            self.bandwidth = np.ones_like(self.speed)

    def client_ranks(self, server_rank: int, min_rank: int = 1) -> np.ndarray:
        """Per-client LoRA ranks under the resource budget: each client
        trains/ships the first ``max(min_rank, round(fraction * server_rank))``
        rank components; the unconstrained fleet gets ``server_rank``
        everywhere (the exact no-op)."""
        ranks = np.round(self.rank_fraction * server_rank).astype(np.int64)
        return np.clip(ranks, min_rank, server_rank)

    def rel_speed(self, client: int) -> float:
        """Slowdown of ``client`` relative to the *fastest* bound client
        (>= 1.0; exactly 1.0 for every client of a homogeneous fleet).

        This is the signal the async engine's step-count adaptation paces
        against (``AsyncAggConfig(adapt_steps=True)``): a device with
        ``rel_speed`` r trains ``ceil(n / r)`` of its selected curriculum
        batches per pull, so heterogeneity in compute translates into
        heterogeneity in work instead of heterogeneity in latency.
        """
        return float(self.speed[client] / self.speed.min())

    def compute_time(self, client: int, n_steps: int) -> float:
        """Virtual seconds of local training for ``n_steps`` real steps."""
        base = n_steps * self.preset.step_time * float(self.speed[client])
        if self.preset.jitter_sigma > 0.0:
            base *= float(self.rng.lognormal(0.0, self.preset.jitter_sigma))
        return base

    def comm_leg_time(self, client: int) -> float:
        """One transfer leg (pull *or* push) in virtual seconds — half the
        round trip's comm budget. The tracer uses this to decompose a
        completion's round trip into pull / compute / push spans."""
        return self.preset.comm_latency * float(self.bandwidth[client])

    def round_trip_time(self, client: int, n_steps: int) -> float:
        """Pull + local training + push, in virtual seconds. A bandwidth-
        constrained client pays its per-transfer multiplier on both legs."""
        comm = 2.0 * self.comm_leg_time(client)
        return comm + self.compute_time(client, n_steps)

    def is_dropped(self, client: int) -> bool:
        del client  # drops are i.i.d. per dispatch, not per identity
        if self.preset.dropout_prob <= 0.0:
            return False  # consume no RNG in drop-free scenarios
        return bool(self.rng.random() < self.preset.dropout_prob)

    def dispatch_time(self, clock: float) -> float:
        """When a client dispatched "now" actually starts (burst arrival)."""
        period = self.preset.burst_period
        if period <= 0.0:
            return clock
        return math.ceil(clock / period - 1e-12) * period


def sync_round_time(
    bound: BoundScenario, chosen: Sequence[int], n_steps: Sequence[int]
) -> float:
    """Virtual duration of one *synchronous* round under ``bound``: the
    barrier waits for the slowest cohort member's full round trip."""
    return max(
        bound.round_trip_time(int(c), int(s)) for c, s in zip(chosen, n_steps)
    )


# ---------------------------------------------------------------------------
# Named presets
# ---------------------------------------------------------------------------

UNIFORM = ScenarioPreset(name="uniform")
# a quarter of the fleet is 4x slower — the acceptance regime for the async
# engine's wall-clock win (>= 4x skew)
STRAGGLER = ScenarioPreset(name="straggler", slow_fraction=0.25, slow_factor=4.0)
DROPOUT = ScenarioPreset(name="dropout", dropout_prob=0.1, jitter_sigma=0.1)
BURSTY = ScenarioPreset(name="bursty", burst_period=8.0, jitter_sigma=0.2)
# the everything-at-once phone fleet: skew + drops + jitter + slow links
MOBILE = STRAGGLER.compose(DROPOUT, name="mobile").with_(
    jitter_sigma=0.3, dropout_prob=0.15, comm_latency=0.5
)
# resource-constrained stragglers: slow devices also carry half the LoRA
# rank budget and a 2x-slower link — the regime where per-client rank
# adaptation and compressed uploads actually earn their keep
CONSTRAINED = STRAGGLER.with_(
    name="constrained", comm_latency=0.5, slow_rank_fraction=0.5,
    bandwidth_factor=2.0,
)

SCENARIOS: Dict[str, ScenarioPreset] = {
    p.name: p for p in (UNIFORM, STRAGGLER, DROPOUT, BURSTY, MOBILE, CONSTRAINED)
}


def get_scenario(scenario: Union[str, ScenarioPreset, None]) -> ScenarioPreset:
    """Resolve a scenario argument: name, preset instance, or None (uniform)."""
    if scenario is None:
        return UNIFORM
    if isinstance(scenario, ScenarioPreset):
        return scenario
    if scenario in SCENARIOS:
        return SCENARIOS[scenario]
    raise ValueError(
        f"unknown scenario {scenario!r}; known: {sorted(SCENARIOS)} "
        "(or pass a ScenarioPreset)"
    )
