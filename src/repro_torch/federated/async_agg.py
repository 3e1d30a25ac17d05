"""Event-driven async aggregation: buffered, staleness-weighted GAL FedAvg
(a copy of ``repro.federated.async_agg``).

The synchronous engines (loop / vectorized / sharded) barrier every round on
the slowest chosen client. This module removes the barrier FedBuff-style
(Nguyen et al., "Federated Learning with Buffered Asynchronous Aggregation"):

* the **scheduler** (:class:`AsyncScheduler`) runs a virtual clock over a
  priority queue of per-client completion events. It tops the in-flight set
  up to a target concurrency at the start of each merge cycle (and whenever
  the event queue drains, e.g. after a run of drops) — deliberately NOT on
  every completion, which is what keeps the degenerate configuration's RNG
  consumption identical to the synchronous engines' one cohort draw per
  round. Each dispatched client pulls the *current* global GAL LoRA
  (recording its version), trains its curriculum steps locally, and reports
  back after a scenario-dependent virtual latency
  (:mod:`repro_torch.federated.hetero`: speed skew, jitter, drops, bursts);
* the **server** buffers completed updates. Once any ``buffer_size`` (K)
  clients have reported, it merges their GAL-selected LoRA layers into the
  global with weights ``n_i * (1 + staleness_i) ** -staleness_power``
  (normalized over the buffer), where ``staleness_i`` is the number of
  merges the global has absorbed since client ``i`` pulled. Stragglers keep
  training against the version they pulled — their updates land late,
  downweighted, instead of stalling everyone;
* the global is **double-buffered** (:class:`DoubleBufferedGlobal`): merges
  publish a fresh front buffer while the previous version stays alive for
  in-flight clients that pulled it, mirroring the real system where the
  server cannot overwrite a tensor a straggler is still training against.

Clients in flight or awaiting aggregation are excluded from re-dispatch, so
one client never holds two pending updates (this is also what keeps the
per-client local round free to update its LoRA and optimizer state in place).

On top of the FedBuff core sit four **adaptive policies**, each a knob on
:class:`AsyncAggConfig` and each an exact no-op at its default:

* **delta merges** (``merge_mode="delta"``) — FedAsync-style (Xie et al.):
  clients report *deltas* against the version they pulled, and the server
  applies ``global += eta(tau) * sum_i w_i * delta_i`` with an *absolute*
  per-update learning rate ``eta(tau_i) = server_lr * (1 + tau_i) **
  -staleness_power`` (:func:`delta_weights`). Unlike the buffered value
  merge, a stale buffer genuinely moves the global less — the right regime
  when staleness is heavy. At ``server_lr=1`` and staleness 0 it reduces
  exactly to the buffered FedAvg;
* **staleness cutoff** (``staleness_cutoff=b``) — updates strictly older
  than ``b`` merges are discarded at flush time (their clients become
  dispatchable again; an update *exactly at* the bound still merges);
* **adaptive buffer size** (``adapt_buffer=True``) — the flush threshold K
  tracks the observed completion rate (:func:`adapted_buffer_size`): a
  window where most dispatches drop shrinks K so the server stops waiting
  for completions that are not coming, a healthy window restores it;
* **wall-clock-aware cohort sampling** (``sampling_bias>0``) — dispatch
  prefers fast clients early in the curriculum ramp and folds stragglers in
  as the ramp completes (:func:`cohort_weights`), so early merges follow
  the fast cohort's cadence and slow devices mostly see the late,
  full-data curriculum.

Client-side **step-count adaptation** (``adapt_steps=True``) lives with the
runner (it needs the curriculum), but its policy function is here too
(:func:`adapted_step_count`): a device ``r`` times slower than the fastest
trains ``ceil(n/r)`` of its selected curriculum batches per pull — the
easiest prefix, preserving curriculum order — so stragglers report back on
the fast cohort's cadence instead of arriving hopelessly stale.

Degenerate configuration = synchronous FedAvg: under the homogeneous
scenario with ``buffer_size == concurrency == cohort size``, every wave
pulls the same version (staleness 0), the buffer flushes exactly once per
wave with sample-count weights, and the merge reproduces the synchronous
engines' round — CI enforces allclose equivalence against ``engine="loop"``
in ``tests/test_torch_async.py``. Every adaptive policy reduces to
this baseline when disabled (and the enabled policies are themselves inert
in degenerate conditions: ``adapt_steps`` under uniform speeds, a cutoff
nothing exceeds, ``adapt_buffer`` with no drops).

The scheduler is deliberately decoupled from FibecFed: it knows nothing
about torch or LoRA trees, only ``plan``/``train`` callbacks and opaque update
payloads, so its event logic (drop handling, buffer flushes, staleness
bookkeeping) is unit-testable without a model
(``tests/test_torch_async.py`` drives it with stub callbacks).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, Generic, List, Optional, Sequence, Set, TypeVar

import numpy as np

from repro_torch.federated.compress import CompressionConfig
from repro_torch.federated.hetero import BoundScenario
from repro_torch.obs import VIRTUAL, ensure
from repro_torch.utils.tree import host_array

T = TypeVar("T")


MERGE_MODES = ("buffered", "delta")
PACE_MODES = ("scenario", "observed")
SERVER_LR_KINDS = ("constant", "inv_sqrt", "exp")


def resolve_server_lr(spec: Any, t: int) -> float:
    """Evaluate a ``server_lr`` spec at merge index ``t`` (published merges).

    ``spec`` is a plain float (constant — the exact pre-schedule behavior),
    a callable ``t -> eta``, or a ``(kind, base, decay)`` tuple with kind
    ``"constant"`` (``base``), ``"inv_sqrt"`` (``base / sqrt(1 + decay*t)``,
    the classic asynchronous-SGD staleness-robust decay), or ``"exp"``
    (``base * exp(-decay * t)``). A float spec returns itself unchanged, so
    the constant path is bit-identical to the unscheduled server lr.
    """
    if callable(spec):
        return float(spec(t))
    if isinstance(spec, (tuple, list)):
        kind, base, decay = spec
        if kind == "constant":
            return float(base)
        if kind == "inv_sqrt":
            return float(base / np.sqrt(1.0 + decay * t))
        if kind == "exp":
            return float(base * np.exp(-decay * t))
        raise ValueError(f"unknown server_lr schedule kind {kind!r}")
    return float(spec)


def _validate_server_lr(spec: Any) -> None:
    if callable(spec):
        return
    if isinstance(spec, (tuple, list)):
        if len(spec) != 3:
            raise ValueError(
                "server_lr schedule spec must be (kind, base, decay)"
            )
        kind, base, decay = spec
        if kind not in SERVER_LR_KINDS:
            raise ValueError(
                f"server_lr schedule kind must be one of {SERVER_LR_KINDS}, "
                f"got {kind!r}"
            )
        if base <= 0.0:
            raise ValueError("server_lr schedule base must be > 0")
        if decay < 0.0:
            raise ValueError("server_lr schedule decay must be >= 0")
        return
    if spec <= 0.0:
        raise ValueError("server_lr must be > 0")


@dataclasses.dataclass(frozen=True)
class AsyncAggConfig:
    """Server- and client-side knobs of the async aggregator.

    Core FedBuff knobs:

    ``buffer_size`` (K) — completions per merge; ``concurrency`` (M) — target
    clients in flight. Both default to the cohort size
    (``FibecFedConfig.devices_per_round``), the synchronous-equivalent
    configuration. ``staleness_power`` is the exponent a of the FedBuff-style
    discount ``s(tau) = (1 + tau) ** -a`` (0.5 in the FedBuff paper; 0
    disables staleness weighting entirely).

    Merge mode:

    ``merge_mode`` — ``"buffered"`` (default) merges client *values* with
    weights renormalized to 1 over the buffer: a stale update loses
    influence to fresher buffer-mates, but with K=1 every flush has weight
    1.0 regardless of staleness (the discount is relative). ``"delta"``
    merges client *deltas* (FedAsync-style) with the absolute per-update
    rate ``server_lr * (1 + tau) ** -staleness_power`` on top of the FedAvg
    sample weights, NOT renormalized — a stale flush genuinely moves the
    global less. ``server_lr`` is eta, the server learning rate of the
    delta merge (ignored in buffered mode); at ``server_lr=1`` and
    staleness 0 the two modes coincide exactly. Besides a float constant,
    ``server_lr`` accepts a schedule ``eta(t)`` over published merges: a
    callable ``t -> eta`` or a ``(kind, base, decay)`` tuple
    (:func:`resolve_server_lr` — ``"constant"`` / ``"inv_sqrt"`` /
    ``"exp"``), evaluated at each flush's pre-publish version. A float (or
    ``("constant", base, 0.0)``) is bit-identical to the unscheduled rate.

    Adaptive policies (each an exact no-op at its default):

    ``staleness_cutoff`` — discard buffered updates strictly older than this
    many merges at flush time (an update exactly at the bound still
    merges); their clients become dispatchable again. ``None`` disables.
    ``predict_staleness`` — skip *dispatching* clients predicted to exceed
    the cutoff, rather than paying their round trip and discarding the
    result at flush time: a client's predicted completion time (its
    per-step completion-time EMA — the same signal as
    ``pace_mode="observed"`` — times its planned step count) divided by
    the observed merge-interval EMA estimates the staleness its update
    would arrive with. Clients with no completions yet (no EMA entry), or
    before the first flush establishes a merge cadence, are never
    skipped, so the first waves are identical with the knob on or off;
    with every client predicted over the bound the filter backs off to the
    unfiltered pool rather than stalling dispatch. Requires
    ``staleness_cutoff``; exact no-op at the default ``False``.
    ``adapt_buffer`` — adapt the flush threshold K to the observed
    completion rate after every merge (see :func:`adapted_buffer_size`),
    clipped to ``[min_buffer_size, max_buffer_size]`` (``max_buffer_size``
    ``None`` = the initial K; the policy only shrinks K below the initial
    value and recovers back to it, so a larger ``max_buffer_size`` is
    inert).
    ``adapt_steps`` — slow clients train fewer curriculum steps per pull:
    a device ``r`` times slower than the fastest trains ``ceil(n/r)`` of
    its selected batches, never below ``min_steps`` (see
    :func:`adapted_step_count`; applied by the runner, which owns the
    curriculum).
    ``pace_mode`` — where ``adapt_steps`` gets its relative-speed signal:
    ``"scenario"`` (default) reads the bound scenario's ground-truth
    ``rel_speed`` — fine in simulation, unavailable in deployment;
    ``"observed"`` paces against a per-client EMA of telemetry-observed
    per-step completion times (:meth:`AsyncScheduler.observed_rel_speed`),
    which needs no scenario knowledge and adapts to drift. Unobserved
    clients pace at 1.0 (full steps) until their first completion, so the
    first wave is identical in both modes, and under a homogeneous fleet
    the two modes coincide. Ignored unless ``adapt_steps=True``.
    ``sampling_bias`` — strength of wall-clock-aware cohort sampling: > 0
    weights dispatch toward fast clients early in the curriculum ramp,
    relaxing to uniform as the ramp completes (see :func:`cohort_weights`).
    0 preserves the synchronous engines' exact RNG consumption.
    ``compression`` — a :class:`repro_torch.federated.compress.CompressionConfig`
    applied to each client's GAL upload at completion time (the server
    merges the dequantized reconstruction; comm accounting charges the
    compressed payload). ``None`` (or ``mode="none"``) ships raw values —
    the exact no-op.
    """

    buffer_size: Optional[int] = None
    concurrency: Optional[int] = None
    staleness_power: float = 0.5
    merge_mode: str = "buffered"
    server_lr: Any = 1.0
    staleness_cutoff: Optional[int] = None
    predict_staleness: bool = False
    adapt_buffer: bool = False
    min_buffer_size: int = 1
    max_buffer_size: Optional[int] = None
    adapt_steps: bool = False
    min_steps: int = 1
    pace_mode: str = "scenario"
    sampling_bias: float = 0.0
    compression: Optional[CompressionConfig] = None

    def __post_init__(self):
        if self.compression is not None and not isinstance(
            self.compression, CompressionConfig
        ):
            raise TypeError("compression must be a CompressionConfig (or None)")
        if self.buffer_size is not None and self.buffer_size < 1:
            raise ValueError("buffer_size must be >= 1")
        if self.concurrency is not None and self.concurrency < 1:
            raise ValueError("concurrency must be >= 1")
        if self.staleness_power < 0.0:
            raise ValueError("staleness_power must be >= 0")
        if self.merge_mode not in MERGE_MODES:
            raise ValueError(
                f"merge_mode must be one of {MERGE_MODES}, got {self.merge_mode!r}"
            )
        _validate_server_lr(self.server_lr)
        if self.staleness_cutoff is not None and self.staleness_cutoff < 0:
            raise ValueError("staleness_cutoff must be >= 0")
        if self.predict_staleness and self.staleness_cutoff is None:
            raise ValueError(
                "predict_staleness requires staleness_cutoff (there is no "
                "bound to predict against)"
            )
        if self.min_buffer_size < 1:
            raise ValueError("min_buffer_size must be >= 1")
        if self.max_buffer_size is not None and (
            self.max_buffer_size < self.min_buffer_size
        ):
            raise ValueError("max_buffer_size must be >= min_buffer_size")
        if self.min_steps < 1:
            raise ValueError("min_steps must be >= 1")
        if self.pace_mode not in PACE_MODES:
            raise ValueError(
                f"pace_mode must be one of {PACE_MODES}, got {self.pace_mode!r}"
            )
        if self.sampling_bias < 0.0:
            raise ValueError("sampling_bias must be >= 0")


def staleness_weights(
    n_samples: Sequence[float], staleness: Sequence[int], power: float
) -> np.ndarray:
    """Normalized merge weights: FedAvg's sample counts x staleness discount.

    ``w_i \\propto n_i * (1 + tau_i) ** -power``, normalized to sum to 1 over
    the buffer. With every ``tau_i == 0`` this is exactly the synchronous
    engines' ``n_i / sum(n)`` FedAvg weighting (same float64 arithmetic).
    """
    n = np.asarray(n_samples, np.float64)
    tau = np.asarray(staleness, np.float64)
    if np.any(tau < 0):
        raise ValueError("staleness must be non-negative")
    w = n * (1.0 + tau) ** -power
    total = w.sum()
    if not total > 0:
        raise ValueError("merge weights sum to zero (empty or zero-sample buffer)")
    return w / total


def delta_weights(
    n_samples: Sequence[float],
    staleness: Sequence[int],
    power: float,
    server_lr: float = 1.0,
) -> np.ndarray:
    """Per-update rates of the FedAsync-style delta merge.

    ``w_i = server_lr * (n_i / sum(n)) * (1 + tau_i) ** -power`` — FedAvg's
    sample weights scaled by the server learning rate and an *absolute*
    staleness discount: unlike :func:`staleness_weights` the result is NOT
    renormalized, so a buffer of stale deltas moves the global less in
    absolute terms (with K=1 a tau-stale delta lands at
    ``server_lr * (1+tau)^-power``, not 1.0). At ``server_lr=1`` and all
    ``tau_i == 0`` this equals :func:`staleness_weights` exactly, which is
    what makes the delta merge reduce to the buffered value merge.
    """
    n = np.asarray(n_samples, np.float64)
    tau = np.asarray(staleness, np.float64)
    if np.any(tau < 0):
        raise ValueError("staleness must be non-negative")
    total = n.sum()
    if not total > 0:
        raise ValueError("merge weights sum to zero (empty or zero-sample buffer)")
    return server_lr * (n / total) * (1.0 + tau) ** -power


def adapted_buffer_size(
    base: int,
    completion_rate: float,
    min_size: int = 1,
    max_size: Optional[int] = None,
) -> int:
    """Flush threshold K adapted to the observed completion rate.

    ``clip(round(base * completion_rate), min_size, max_size)`` with
    ``max_size`` defaulting to ``base``. A window where every dispatch
    dropped (rate 0 — e.g. the whole fleet off its chargers) clamps to
    ``min_size`` rather than 0, so the server merges whatever does arrive
    instead of waiting forever; a healthy window (rate 1) restores ``base``.
    Note the policy only *shrinks* K below ``base`` and recovers back to
    it — with the rate capped at 1, a ``max_size`` above ``base`` is inert.
    """
    if not 0.0 <= completion_rate <= 1.0:
        raise ValueError("completion_rate must be in [0, 1]")
    max_size = base if max_size is None else max_size
    if min_size > max_size:
        raise ValueError(
            f"min_size {min_size} exceeds max_size {max_size}; the clip "
            "would silently ignore the floor"
        )
    return int(np.clip(int(round(base * completion_rate)), min_size, max_size))


def adapted_step_count(n_steps: int, rel_speed: float, min_steps: int = 1) -> int:
    """Per-pull step budget for a device ``rel_speed`` times slower than the
    fastest: ``max(min_steps, ceil(n_steps / rel_speed))``.

    Equalizes virtual compute time across the fleet — a 4x straggler trains
    a quarter of its selected curriculum batches (the *easiest* prefix,
    preserving curriculum order) and reports back on the fast cohort's
    cadence instead of arriving hopelessly stale. ``rel_speed <= 1`` (the
    fastest device, or a homogeneous fleet) is the identity, so the policy
    is inert exactly when there is nothing to adapt to.
    """
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    if rel_speed <= 1.0:
        return max(min_steps, n_steps)
    return max(min_steps, int(np.ceil(n_steps / rel_speed)))


def cohort_weights(speed: np.ndarray, bias: float, progress: float) -> np.ndarray:
    """Wall-clock-aware dispatch probabilities over the available clients.

    ``w_i \\propto speed_i ** (-bias * (1 - progress))`` normalized to 1,
    where ``speed_i`` is the scenario slowdown multiplier (1.0 = fastest)
    and ``progress`` the curriculum ramp progress in [0, 1]. Early in the
    ramp (progress 0) a bias of 2 makes a 4x straggler 16x less likely per
    draw than a fast client; at progress 1 the weights are exactly uniform —
    stragglers (and their data) fold in as the curriculum reaches full data,
    so no client's distribution is excluded from the converged model.
    """
    if bias < 0.0:
        raise ValueError("bias must be >= 0")
    s = np.asarray(speed, np.float64)
    if np.any(s <= 0):
        raise ValueError("speeds must be positive")
    progress = float(min(max(progress, 0.0), 1.0))
    w = s ** (-bias * (1.0 - progress))
    return w / w.sum()


class DoubleBufferedGlobal(Generic[T]):
    """Front/back buffer pair for the server's global GAL LoRA.

    ``front`` is the version served to new pulls; ``publish`` retires it to
    ``back`` (still referenced by stragglers that pulled it) and installs the
    merge result. Versions count published merges — the unit staleness is
    measured in.
    """

    def __init__(self, value: T):
        self.front: T = value
        self.back: Optional[T] = None
        self.version: int = 0

    def publish(self, new: T) -> None:
        self.back, self.front = self.front, new
        self.version += 1


@dataclasses.dataclass
class ClientUpdate:
    """One completed local round, as buffered by the server.

    The scheduler itself only reads ``client`` (re-dispatch exclusion),
    ``n_samples`` (FedAvg weight), ``n_steps`` (latency pricing) and
    ``pulled_version`` (staleness); the rest rides along to the runner's
    merge and stats.
    """

    client: int
    lora: Any  # trained client LoRA tree (GAL part merged at flush)
    delta: Any  # lora - pulled global (delta merge mode only; else None)
    losses: Any  # (S,) per-step training losses, padded steps included
    step_valid: Any  # (S,) f32 mask of real (non-padded) steps
    n_samples: int
    n_steps: int  # real curriculum steps (prices virtual latency)
    n_selected: int  # curriculum-selected batches at dispatch round
    pulled_version: int
    round_t: int  # server round at dispatch time
    # wire bytes of this completion under the runner's compression/rank
    # config: the full round trip (down + up) and the upload alone
    comm_bytes: int = 0
    upload_bytes: int = 0


@dataclasses.dataclass
class _Event:
    """One scheduled client outcome on the virtual clock.

    ``seq`` breaks time ties FIFO (dispatch order), which is what makes the
    homogeneous scenario — where a whole wave completes at the same instant —
    deterministic and equal to the synchronous engines' client order
    up to merge commutativity.
    """

    time: float
    seq: int
    kind: str  # "complete" | "drop"
    client: int
    payload: Any = None
    # virtual timeline of the dispatch, kept for the tracer and the observed-
    # pace EMA: when the server decided to dispatch, and when the client
    # actually started (>= dispatched under bursty arrivals)
    dispatched: float = 0.0
    start: float = 0.0

    def __lt__(self, other: "_Event") -> bool:
        return (self.time, self.seq) < (other.time, other.seq)


@dataclasses.dataclass
class MergeResult:
    """One buffer flush: the updates to merge and their final weights.

    ``weights`` are normalized staleness-discounted FedAvg weights in
    buffered mode, or the absolute (server-lr-scaled, NOT renormalized)
    per-delta rates in delta mode — either way the values the runner's
    fused merge program contracts the stacked updates with.
    """

    updates: List[Any]  # opaque payloads from the train callback
    weights: np.ndarray  # (K,) merge weights (see class docstring)
    staleness: np.ndarray  # (K,) int merges-behind per update
    clock: float  # virtual time of the flush
    version: int  # global version after this merge is published
    completed: int  # completions consumed by this flush
    dropped: int  # drops observed since the previous flush
    stale_dropped: int = 0  # completions discarded by the staleness cutoff
    # wire bytes of the stale-discarded completions (already on the wire
    # when the cutoff discarded them, so the runner still charges them)
    stale_dropped_bytes: int = 0
    stale_dropped_upload_bytes: int = 0


class AsyncScheduler:
    """Virtual-clock event loop driving dispatch, drops, and buffer flushes.

    ``plan(client, round_t) -> n_steps`` prices a dispatch (curriculum step
    count) without training — used for drop timing. ``train(client, round_t,
    version) -> payload`` runs the actual local round; the payload must
    expose ``n_samples`` (FedAvg weight), ``n_steps`` (latency pricing) and
    ``pulled_version`` attributes, and is otherwise opaque.

    ``rng`` is the *cohort sampling* stream. When the whole population is
    available a wave consumes it exactly like the synchronous engines' <<one
    ``choice(num_clients, k)`` per round>>, so equivalence holds seed-for-
    seed; scenario randomness lives on the BoundScenario's own stream.
    ``progress`` maps a server round to the curriculum ramp progress in
    [0, 1] (only consulted when ``cfg.sampling_bias > 0``); without one the
    scheduler assumes a completed ramp, i.e. uniform sampling.
    """

    def __init__(
        self,
        *,
        num_clients: int,
        cohort_size: int,
        scenario: BoundScenario,
        rng: np.random.Generator,
        cfg: Optional[AsyncAggConfig] = None,
        progress: Optional[Callable[[int], float]] = None,
        telemetry=None,
    ):
        cfg = cfg or AsyncAggConfig()
        self.tel = ensure(telemetry)
        self.num_clients = num_clients
        self.buffer_size = cfg.buffer_size or cohort_size
        self.concurrency = cfg.concurrency or cohort_size
        if not 1 <= self.buffer_size <= num_clients:
            raise ValueError(
                f"buffer_size must be in [1, {num_clients}], got {self.buffer_size}"
            )
        if not 1 <= self.concurrency <= num_clients:
            raise ValueError(
                f"concurrency must be in [1, {num_clients}], got {self.concurrency}"
            )
        self.staleness_power = cfg.staleness_power
        self.merge_mode = cfg.merge_mode
        self.server_lr = cfg.server_lr
        self.staleness_cutoff = cfg.staleness_cutoff
        self.predict_staleness = cfg.predict_staleness
        self.adapt_buffer = cfg.adapt_buffer
        self.base_buffer_size = self.buffer_size
        self.min_buffer_size = cfg.min_buffer_size
        self.max_buffer_size = min(
            cfg.max_buffer_size or self.buffer_size, num_clients
        )
        if self.min_buffer_size > self.max_buffer_size:
            raise ValueError(
                f"min_buffer_size {self.min_buffer_size} exceeds the "
                f"effective max buffer size {self.max_buffer_size}"
            )
        self.sampling_bias = cfg.sampling_bias
        self.progress = progress or (lambda t: 1.0)
        self.scenario = scenario
        self.rng = rng
        self.clock = 0.0
        self.version = 0
        self.in_flight: Set[int] = set()
        self.buffer: List[Any] = []
        self.last_merge_weights: Optional[np.ndarray] = None
        self.total_completed = 0
        self.total_dropped = 0
        self.total_stale_dropped = 0
        self._dropped_since_flush = 0
        self._stale_since_flush = 0
        self._stale_bytes_since_flush = 0
        self._stale_upload_bytes_since_flush = 0
        self._rate_ema: Optional[float] = None
        # merge-cadence estimate for dispatch-time staleness prediction:
        # EMA (momentum 0.5) of virtual time between successful flushes
        self._merge_interval_ema: Optional[float] = None
        self._last_flush_clock = 0.0
        self._heap: List[_Event] = []
        # plain int (not itertools.count) so checkpoint_state can snapshot it
        self._seq = 0
        self.pace_mode = cfg.pace_mode
        # per-client EMA (momentum 0.5) of observed virtual seconds per
        # curriculum step, dispatch -> report; feeds observed_rel_speed and
        # the async.completion_s telemetry histogram
        self._obs_step_time: dict = {}
        # virtual time each buffered payload arrived (tracing only), keyed
        # by payload id; entries live exactly as long as the buffer entry
        self._buffered_at: dict = {}

    def observed_rel_speed(self, client: int) -> float:
        """Slowdown of ``client`` relative to the fastest *observed* client
        (>= 1.0), from the per-step completion-time EMA — the scenario-free
        twin of ``BoundScenario.rel_speed``. A client with no completions
        yet (or an empty EMA table) reports 1.0: pace adaptation starts
        only once there is evidence, so the first wave always trains its
        full step budget.
        """
        obs = self._obs_step_time
        t = obs.get(client)
        if t is None:
            return 1.0
        return max(1.0, float(t / min(obs.values())))

    def _take_seq(self) -> int:
        seq, self._seq = self._seq, self._seq + 1
        return seq

    # -- dispatch ----------------------------------------------------------

    def _available(self) -> List[int]:
        busy = self.in_flight | {u.client for u in self.buffer}
        return [c for c in range(self.num_clients) if c not in busy]

    def predicted_staleness(self, client: int, n_steps: int) -> Optional[float]:
        """Merges the global is predicted to absorb while ``client`` runs
        ``n_steps`` — its per-step completion-time EMA times the step count,
        divided by the observed merge-interval EMA. ``None`` when there is
        no evidence yet (client never completed, or no flush has
        established a merge cadence)."""
        t_step = self._obs_step_time.get(client)
        interval = self._merge_interval_ema
        if t_step is None or interval is None or interval <= 0.0:
            return None
        return (t_step * max(1, n_steps)) / interval

    def _predict_filter(self, avail: List[int], round_t: int, plan: Callable) -> List[int]:
        """Dispatch-time staleness prediction: drop clients whose update is
        predicted to arrive past the cutoff (it would only be discarded at
        flush time after paying the full round trip). Evidence-free clients
        pass; an all-skipped pool backs off to the unfiltered one so
        dispatch never stalls."""
        keep = []
        for ci in avail:
            tau_hat = self.predicted_staleness(ci, plan(ci, round_t))
            if tau_hat is not None and tau_hat > self.staleness_cutoff:
                if self.tel.enabled:
                    self.tel.metrics.counter("async.predicted_stale_skips").inc()
                continue
            keep.append(ci)
        return keep or avail

    def _dispatch(self, round_t: int, plan: Callable, train: Callable) -> int:
        """Top the in-flight set up to ``concurrency``; returns #dispatched."""
        want = self.concurrency - len(self.in_flight)
        if want <= 0:
            return 0
        avail = self._available()
        if self.predict_staleness and avail:
            avail = self._predict_filter(avail, round_t, plan)
        count = min(want, len(avail))
        if count <= 0:
            return 0
        if self.sampling_bias > 0.0:
            # wall-clock-aware sampling: prefer fast clients while the
            # curriculum ramp is young, uniform once it completes
            p = cohort_weights(
                self.scenario.speed[np.asarray(avail)],
                self.sampling_bias,
                self.progress(round_t),
            )
            chosen = self.rng.choice(np.asarray(avail), count, replace=False, p=p)
        elif len(avail) == self.num_clients:
            # same RNG call as the synchronous engines' cohort sampling
            chosen = self.rng.choice(self.num_clients, count, replace=False)
        else:
            chosen = self.rng.choice(np.asarray(avail), count, replace=False)
        start = self.scenario.dispatch_time(self.clock)
        for ci in np.atleast_1d(chosen):
            ci = int(ci)
            self.in_flight.add(ci)
            if self.scenario.is_dropped(ci):
                # the device does the work but never reports back
                done = start + self.scenario.round_trip_time(ci, plan(ci, round_t))
                ev = _Event(
                    done, self._take_seq(), "drop", ci,
                    dispatched=self.clock, start=start,
                )
            else:
                payload = train(ci, round_t, self.version)
                done = start + self.scenario.round_trip_time(ci, payload.n_steps)
                ev = _Event(
                    done, self._take_seq(), "complete", ci, payload,
                    dispatched=self.clock, start=start,
                )
            heapq.heappush(self._heap, ev)
        return count

    # -- event loop --------------------------------------------------------

    def run_until_merge(
        self, round_t: int, plan: Callable, train: Callable
    ) -> MergeResult:
        """Advance the virtual clock until the buffer flushes once."""
        self._dispatch(round_t, plan, train)
        while True:
            if not self._heap:
                if not self._dispatch(round_t, plan, train):
                    raise RuntimeError(
                        "async scheduler stalled: no events and no "
                        "dispatchable clients (buffer_size too large for "
                        "the population?)"
                    )
                continue
            ev = heapq.heappop(self._heap)
            self.clock = max(self.clock, ev.time)
            self.in_flight.discard(ev.client)
            if ev.kind == "drop":
                self.total_dropped += 1
                self._dropped_since_flush += 1
                if self.tel.enabled:
                    self.tel.instant(
                        "drop", ts=ev.time, clock=VIRTUAL, cat="async",
                        track=f"client/{ev.client}",
                    )
                continue
            # observed pacing signal: virtual seconds per curriculum step,
            # server-dispatch to report (comm + burst wait + jitter included
            # — what a scenario-blind server would actually measure)
            n_steps = max(1, int(getattr(ev.payload, "n_steps", 1)))
            per_step = (ev.time - ev.dispatched) / n_steps
            prev = self._obs_step_time.get(ev.client)
            self._obs_step_time[ev.client] = (
                per_step if prev is None else 0.5 * prev + 0.5 * per_step
            )
            if self.tel.enabled:
                self._trace_completion(ev)
            self.buffer.append(ev.payload)
            self.total_completed += 1
            if len(self.buffer) >= self.buffer_size:
                result = self._flush()
                if result is not None:
                    return result
                # every buffered update was over the staleness cutoff — the
                # stale clients are free again; re-dispatch and keep
                # advancing the clock until fresh completions arrive
                self._dispatch(round_t, plan, train)

    def _trace_completion(self, ev: _Event) -> None:
        """Decompose a completion's round trip into virtual-clock spans.

        The scheduler only prices whole round trips, but the pieces are
        recoverable after the fact: one comm leg each side of the compute
        window, and any burst wait between the server's dispatch decision
        and the client's actual start folds into the dispatch span. Byte
        args ride on the spans so a trace's upload totals reconcile with
        the runner's wire-format comm accounting (asserted in tests).
        """
        u = ev.payload
        leg = self.scenario.comm_leg_time(ev.client)
        track = f"client/{ev.client}"
        tracer = self.tel.tracer
        down = getattr(u, "comm_bytes", 0) - getattr(u, "upload_bytes", 0)
        tracer.add_span(
            "dispatch", start=ev.dispatched, end=ev.start + leg,
            clock=VIRTUAL, cat="async", track=track,
            args={
                "round": getattr(u, "round_t", 0),
                "version": getattr(u, "pulled_version", 0),
                "download_bytes": down,
            },
        )
        tracer.add_span(
            "compute", start=ev.start + leg, end=ev.time - leg,
            clock=VIRTUAL, cat="async", track=track,
            args={"n_steps": getattr(u, "n_steps", 0)},
        )
        tracer.add_span(
            "upload", start=ev.time - leg, end=ev.time,
            clock=VIRTUAL, cat="async", track=track,
            args={"upload_bytes": getattr(u, "upload_bytes", 0)},
        )
        self._buffered_at[id(u)] = ev.time
        m = self.tel.metrics
        m.histogram("async.completion_s").observe(ev.time - ev.dispatched)
        m.counter("async.completions").inc()

    def _flush(self) -> Optional[MergeResult]:
        updates, self.buffer = self.buffer, []
        if self.tel.enabled:
            # each update waited in the server buffer from its report time
            # to this flush; stale discards are resolved below, but their
            # buffer residency is identical
            for u in updates:
                arrived = self._buffered_at.pop(id(u), self.clock)
                self.tel.tracer.add_span(
                    "buffer", start=arrived, end=self.clock,
                    clock=VIRTUAL, cat="async",
                    track=f"client/{getattr(u, 'client', '?')}",
                )
        if self.staleness_cutoff is not None:
            # strictly-older-than-the-bound updates are discarded (their
            # clients become dispatchable again); exactly-at-bound merges
            fresh = [
                u
                for u in updates
                if self.version - u.pulled_version <= self.staleness_cutoff
            ]
            n_stale = len(updates) - len(fresh)
            self.total_stale_dropped += n_stale
            self._stale_since_flush += n_stale
            fresh_set = {id(u) for u in fresh}
            for u in updates:
                if id(u) not in fresh_set:
                    # accumulate here — these payloads are discarded before
                    # the runner ever sees them (getattr: the scheduler
                    # tests use stub payloads without byte fields)
                    self._stale_bytes_since_flush += getattr(u, "comm_bytes", 0)
                    self._stale_upload_bytes_since_flush += getattr(
                        u, "upload_bytes", 0
                    )
                    if self.tel.enabled:
                        self.tel.instant(
                            "stale_drop", ts=self.clock, clock=VIRTUAL,
                            cat="async",
                            track=f"client/{getattr(u, 'client', '?')}",
                            args={
                                "staleness": self.version - u.pulled_version
                            },
                        )
            updates = fresh
            if not updates:
                return None
        staleness = np.asarray(
            [self.version - u.pulled_version for u in updates], np.int64
        )
        if self.merge_mode == "delta":
            # schedule evaluated at the published-merge index: merge t sees
            # eta(t), so a constant spec reproduces the fixed-eta run bit
            # for bit
            eta = resolve_server_lr(self.server_lr, self.version)
            weights = delta_weights(
                [u.n_samples for u in updates], staleness, self.staleness_power,
                eta,
            )
        else:
            weights = staleness_weights(
                [u.n_samples for u in updates], staleness, self.staleness_power
            )
        self.version += 1
        interval = self.clock - self._last_flush_clock
        self._last_flush_clock = self.clock
        self._merge_interval_ema = (
            interval
            if self._merge_interval_ema is None
            else 0.5 * (self._merge_interval_ema + interval)
        )
        self.last_merge_weights = weights
        dropped, self._dropped_since_flush = self._dropped_since_flush, 0
        stale_dropped, self._stale_since_flush = self._stale_since_flush, 0
        stale_bytes, self._stale_bytes_since_flush = (
            self._stale_bytes_since_flush, 0
        )
        stale_up, self._stale_upload_bytes_since_flush = (
            self._stale_upload_bytes_since_flush, 0
        )
        result = MergeResult(
            updates=updates,
            weights=weights,
            staleness=staleness,
            clock=self.clock,
            version=self.version,
            completed=len(updates),
            dropped=dropped,
            stale_dropped=stale_dropped,
            stale_dropped_bytes=stale_bytes,
            stale_dropped_upload_bytes=stale_up,
        )
        if self.adapt_buffer:
            self._adapt_buffer_size(result)
        if self.tel.enabled:
            self.tel.instant(
                "merge", ts=self.clock, clock=VIRTUAL, cat="async",
                track="server",
                args={
                    "version": self.version,
                    "merged": result.completed,
                    "dropped": result.dropped,
                    "stale_dropped": result.stale_dropped,
                },
            )
            m = self.tel.metrics
            m.counter("async.merges").inc()
            m.counter("async.dropped").inc(result.dropped)
            m.counter("async.stale_dropped").inc(result.stale_dropped)
            m.gauge("async.buffer_size").set(self.buffer_size)
            for tau in staleness:
                m.histogram("async.staleness").observe(int(tau))
        return result

    def _adapt_buffer_size(self, result: MergeResult) -> None:
        """Track the completion rate of the window since the previous flush
        (EMA over flush windows, momentum 0.5) and re-aim K at it."""
        arrived = result.completed + result.stale_dropped
        rate = arrived / max(1, arrived + result.dropped)
        self._rate_ema = (
            rate if self._rate_ema is None else 0.5 * (self._rate_ema + rate)
        )
        self.buffer_size = adapted_buffer_size(
            self.base_buffer_size,
            self._rate_ema,
            self.min_buffer_size,
            self.max_buffer_size,
        )

    # -- checkpoint / restore ----------------------------------------------

    def checkpoint_state(self):
        """``(host, arrays)`` snapshot of every bit of mutable state.

        ``host`` is JSON-able (floats survive ``repr`` round-trips exactly,
        so EMAs and virtual clocks restore bit-identically); ``arrays`` holds
        the LoRA/delta/loss tensors of every pending payload — events still
        on the heap and completions waiting in the buffer — keyed by the
        payload's position in the (deterministically sorted) heap or buffer.
        The scenario RNG state rides along: virtual latencies and drops after
        a resume consume exactly the stream the uninterrupted run would.
        ``last_merge_weights`` is reporting-only and deliberately excluded.
        The keys and the payloads' dtypes are the JAX package's, so either
        side restores the other's snapshot.
        """
        host: dict = {
            "clock": float(self.clock),
            "version": int(self.version),
            "buffer_size": int(self.buffer_size),
            "next_seq": int(self._seq),
            "total_completed": int(self.total_completed),
            "total_dropped": int(self.total_dropped),
            "total_stale_dropped": int(self.total_stale_dropped),
            "dropped_since_flush": int(self._dropped_since_flush),
            "stale_since_flush": int(self._stale_since_flush),
            "stale_bytes_since_flush": int(self._stale_bytes_since_flush),
            "stale_upload_bytes_since_flush": int(
                self._stale_upload_bytes_since_flush
            ),
            "rate_ema": self._rate_ema,
            "merge_interval_ema": self._merge_interval_ema,
            "last_flush_clock": float(self._last_flush_clock),
            "in_flight": sorted(int(c) for c in self.in_flight),
            "obs_step_time": {
                str(c): float(t) for c, t in self._obs_step_time.items()
            },
            "scenario_rng": self.scenario.rng.bit_generator.state,
        }
        arrays: dict = {}
        heap_host, heap_arrays = [], {}
        for i, ev in enumerate(sorted(self._heap)):
            entry = {
                "time": float(ev.time),
                "seq": int(ev.seq),
                "kind": ev.kind,
                "client": int(ev.client),
                "dispatched": float(ev.dispatched),
                "start": float(ev.start),
                "payload": None,
            }
            if ev.payload is not None:
                ph, pa = _pack_update(ev.payload)
                entry["payload"] = ph
                heap_arrays[str(i)] = pa
            heap_host.append(entry)
        host["heap"] = heap_host
        if heap_arrays:
            arrays["heap"] = heap_arrays
        buf_host, buf_arrays = [], {}
        for i, u in enumerate(self.buffer):
            ph, pa = _pack_update(u)
            # arrival time (buffer-residency tracing) re-keys by identity on
            # restore, so it rides with the payload rather than by id()
            ph["arrived"] = float(self._buffered_at.get(id(u), self.clock))
            buf_host.append(ph)
            buf_arrays[str(i)] = pa
        host["buffer"] = buf_host
        if buf_arrays:
            arrays["buffer"] = buf_arrays
        return host, arrays

    def restore_checkpoint_state(self, host, arrays) -> None:
        """Install a :meth:`checkpoint_state` snapshot on a fresh scheduler.

        The scheduler must have been constructed with the same configuration
        (population, scenario preset, async knobs) — this restores *state*,
        not config. Heap pop order survives the round trip because heapify
        of any permutation pops identically under the ``(time, seq)`` total
        order.
        """
        self.clock = float(host["clock"])
        self.version = int(host["version"])
        self.buffer_size = int(host["buffer_size"])
        self._seq = int(host["next_seq"])
        self.total_completed = int(host["total_completed"])
        self.total_dropped = int(host["total_dropped"])
        self.total_stale_dropped = int(host["total_stale_dropped"])
        self._dropped_since_flush = int(host["dropped_since_flush"])
        self._stale_since_flush = int(host["stale_since_flush"])
        self._stale_bytes_since_flush = int(host["stale_bytes_since_flush"])
        self._stale_upload_bytes_since_flush = int(
            host["stale_upload_bytes_since_flush"]
        )
        self._rate_ema = (
            None if host["rate_ema"] is None else float(host["rate_ema"])
        )
        self._merge_interval_ema = (
            None
            if host["merge_interval_ema"] is None
            else float(host["merge_interval_ema"])
        )
        self._last_flush_clock = float(host["last_flush_clock"])
        self.in_flight = {int(c) for c in host["in_flight"]}
        self._obs_step_time = {
            int(c): float(t) for c, t in host["obs_step_time"].items()
        }
        self.scenario.rng.bit_generator.state = host["scenario_rng"]
        heap_arrays = arrays.get("heap", {})
        events = []
        for i, e in enumerate(host["heap"]):
            payload = None
            if e["payload"] is not None:
                payload = _unpack_update(e["payload"], heap_arrays[str(i)])
            events.append(
                _Event(
                    time=float(e["time"]),
                    seq=int(e["seq"]),
                    kind=str(e["kind"]),
                    client=int(e["client"]),
                    payload=payload,
                    dispatched=float(e["dispatched"]),
                    start=float(e["start"]),
                )
            )
        heapq.heapify(events)
        self._heap = events
        buf_arrays = arrays.get("buffer", {})
        self.buffer = []
        self._buffered_at = {}
        for i, ph in enumerate(host["buffer"]):
            u = _unpack_update(ph, buf_arrays[str(i)])
            self.buffer.append(u)
            self._buffered_at[id(u)] = float(ph["arrived"])
        self.last_merge_weights = None


_UPDATE_HOST_FIELDS = (
    "client",
    "n_samples",
    "n_steps",
    "n_selected",
    "pulled_version",
    "round_t",
    "comm_bytes",
    "upload_bytes",
)


def _pack_update(u: ClientUpdate):
    """Split a :class:`ClientUpdate` into (JSON-able host fields, array
    trees): the LoRA (and delta) trees and the loss tensor as they are,
    ``step_valid`` as numpy."""
    host = {f: int(getattr(u, f)) for f in _UPDATE_HOST_FIELDS}
    host["has_delta"] = u.delta is not None
    arrays = {
        "lora": u.lora,
        "losses": u.losses,
        "step_valid": host_array(u.step_valid),
    }
    if u.delta is not None:
        arrays["delta"] = u.delta
    return host, arrays


def _unpack_update(host, arrays) -> ClientUpdate:
    """The inverse of :func:`_pack_update`: ``arrays`` as the runner placed
    them (trees and losses on its device); ``step_valid`` back to numpy."""
    return ClientUpdate(
        client=int(host["client"]),
        lora=arrays["lora"],
        delta=arrays["delta"] if host["has_delta"] else None,
        losses=arrays["losses"],
        step_valid=host_array(arrays["step_valid"]),
        n_samples=int(host["n_samples"]),
        n_steps=int(host["n_steps"]),
        n_selected=int(host["n_selected"]),
        pulled_version=int(host["pulled_version"]),
        round_t=int(host["round_t"]),
        comm_bytes=int(host["comm_bytes"]),
        upload_bytes=int(host["upload_bytes"]),
    )
