"""Curriculum data selection (paper §4.2, Appendix C, Formulas 18-22).

A numpy copy of ``repro.core.curriculum``.
Batches are sorted ascending by Fisher difficulty; round t uses the first
``B_k^t = clip(β + (1-β)·f(t)/(αT), β, 1) · n_batches`` of them. Strategies:
linear f(t)=t (paper's choice), sqrt, quadratic, exp (App. G.7), plus
``none`` (all data, no curriculum) and ``random`` (ablation G.2).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.data.pipeline import bucket_size

STRATEGIES = ("linear", "sqrt", "quadratic", "exp", "none", "random")


@dataclasses.dataclass(frozen=True)
class CurriculumSchedule:
    strategy: str = "linear"
    beta: float = 0.6  # initial fraction of data
    alpha: float = 0.8  # fraction of rounds until all data is used
    total_rounds: int = 100

    def progress(self, t: int) -> float:
        """Ramp progress in [0, 1]: 0 at t=0, 1 once the ramp completes
        (t >= αT, or always for ``none``/``random``, which start at full data)."""
        if self.strategy in ("none", "random"):
            return 1.0
        denom = max(self.alpha * self.total_rounds, 1e-9)
        if self.strategy == "linear":
            prog = t / denom
        elif self.strategy == "sqrt":
            prog = math.sqrt(t) / math.sqrt(denom)
        elif self.strategy == "quadratic":
            prog = (t * t) / (denom * denom)
        elif self.strategy == "exp":
            prog = math.expm1(t) / max(math.expm1(denom), 1e-9)
        else:
            raise ValueError(self.strategy)
        return float(min(1.0, prog))

    def fraction(self, t: int) -> float:
        if self.strategy in ("none", "random"):
            return 1.0
        return float(
            min(1.0, self.beta + (1.0 - self.beta) * self.progress(t))
        )


def num_selected_batches(schedule: CurriculumSchedule, t: int, n_batches: int) -> int:
    return max(1, min(n_batches, int(round(schedule.fraction(t) * n_batches))))


def order_batches(
    difficulty_scores: np.ndarray, strategy: str = "linear", rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """Ascending-difficulty batch order (Alg. 1 line 5); random for ablation."""
    if strategy == "random":
        rng = rng or np.random.default_rng(0)
        return rng.permutation(len(difficulty_scores))
    return np.argsort(np.asarray(difficulty_scores), kind="stable")


def selected_batch_ids(
    schedule: CurriculumSchedule, t: int, order: np.ndarray
) -> np.ndarray:
    """Formula 19: batches with rank j < B_k^t are selected for round t."""
    count = num_selected_batches(schedule, t, len(order))
    return order[:count]


def step_plan(schedule: CurriculumSchedule, t: int, orders, local_epochs: int = 1, *, max_selected=None):
    """Padded per-client step schedule of the vectorized and async engines.

    ``orders`` are the chosen clients' curriculum orders (ragged). Returns
    ``(batch_idx (k, S) int32, step_valid (k, S) f32)`` with
    ``S = local_epochs · padded``: step ``s`` of client ``i`` trains on
    batch ``batch_idx[i, s]`` iff ``step_valid[i, s]``, replaying the loop
    engine's epoch-major traversal of :func:`selected_batch_ids`. Padded
    steps keep index 0 and are no-ops.

    ``padded`` is the largest per-epoch selected count, rounded up to a
    power of two. ``max_selected`` (one entry per client, ``None`` entries
    uncapped) caps each client's per-epoch count: the async engine's
    step-count adaptation, where a capped client trains only the easiest
    ``max_selected[i]`` of its selected batches (the order is a difficulty
    sort, so truncation keeps the prefix). Caps clamp to >= 1.
    """
    sels = [selected_batch_ids(schedule, t, o) for o in orders]
    if max_selected is not None:
        sels = [s if cap is None else s[: max(1, int(cap))] for s, cap in zip(sels, max_selected)]
    padded = bucket_size(max(len(s) for s in sels))
    k, S = len(sels), local_epochs * padded
    batch_idx = np.zeros((k, S), np.int32)
    step_valid = np.zeros((k, S), np.float32)
    for i, sel in enumerate(sels):
        for e in range(local_epochs):
            lo = e * padded
            batch_idx[i, lo : lo + len(sel)] = sel
            step_valid[i, lo : lo + len(sel)] = 1.0
    return batch_idx, step_valid
