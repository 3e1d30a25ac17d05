"""Named FL baselines from the paper's comparison set, as FibecFed switch
presets (port of ``repro.federated.baselines``):

- fedavg_lora     — LoRA + FedAvg, all layers aggregated, no curriculum,
                    dense local update
- shortformer     — static length-based curriculum
- loss_curriculum — inference-loss difficulty
- random_select   — random data selection
- gal_ascending / gal_random / gal_full — layer-selection ablations
- no_sparse       — FibecFed without local-update selection
- fibecfed        — the full method
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.config import FibecFedConfig
from repro_torch.core.fibecfed import FibecFed
from repro_torch.models.model_api import ModelFns

BASELINES: Dict[str, Dict[str, Any]] = {
    "fibecfed": dict(difficulty_metric="fisher", gal_mode="importance", sparse_update=True),
    "fedavg_lora": dict(
        difficulty_metric="random", gal_mode="full", sparse_update=False, curriculum="none"
    ),
    "shortformer": dict(difficulty_metric="length", gal_mode="full", sparse_update=False),
    "loss_curriculum": dict(difficulty_metric="loss", gal_mode="full", sparse_update=False),
    "random_select": dict(difficulty_metric="random", gal_mode="full", sparse_update=False),
    "gal_ascending": dict(difficulty_metric="fisher", gal_mode="ascending", sparse_update=True),
    "gal_random": dict(difficulty_metric="fisher", gal_mode="random", sparse_update=True),
    "gal_full": dict(difficulty_metric="fisher", gal_mode="full", sparse_update=True),
    "no_curriculum": dict(
        difficulty_metric="fisher", gal_mode="importance", sparse_update=True, curriculum="none"
    ),
    "no_sparse": dict(difficulty_metric="fisher", gal_mode="importance", sparse_update=False),
}


def make_runner(name: str, model: ModelFns, loss_fn: Callable, fl: FibecFedConfig,
                client_data: Sequence[Dict[str, np.ndarray]], *, seed: int = 0,
                optimizer: str = "sgd", fused_optimizer=False, engine: str = "vectorized",
                mesh: Any = None, compression: Any = None, client_ranks: Any = None, **kw) -> FibecFed:
    """Build a :class:`FibecFed` runner from a named baseline preset.

    ``engine`` is ``"vectorized"`` (default), ``"loop"``, ``"sharded"`` or
    ``"async"``; ``mesh`` the sharded engine's client mesh
    (:func:`repro_torch.launch.mesh.make_client_mesh`; ``None``: one over the
    default process group, which the caller initialized); ``compression`` a
    :class:`repro_torch.federated.CompressionConfig` (``None`` is an exact
    no-op); ``client_ranks`` one LoRA rank per client (``None``: full rank
    everywhere, or on the async engine the scenario's rank budget). ``kw``
    goes to ``FibecFed`` as it is: the async engine's ``scenario``,
    ``async_cfg`` and ``hierarchy``, ``store`` (a
    :mod:`repro_torch.federated.store` store), ``telemetry``, ``device``,
    ``init_params`` and ``init_lora``. Returns an un-initialized runner: call
    ``init_phase()`` once, then ``run_round(t)`` per round (or drive it with
    :func:`run_experiment`, or :class:`repro_torch.federated.FederationService`).
    On the sharded engine every rank builds and drives the same runner.
    """
    preset = dict(BASELINES[name])
    curriculum = preset.pop("curriculum", None)
    if curriculum is not None:
        fl = dataclasses.replace(fl, curriculum=curriculum)
    return FibecFed(
        model, loss_fn, fl, client_data, seed=seed, optimizer=optimizer,
        fused_optimizer=fused_optimizer, engine=engine, mesh=mesh, compression=compression,
        client_ranks=client_ranks, **kw, **preset,
    )


def run_experiment(runner: FibecFed, test_data: Dict[str, np.ndarray], *,
                   rounds: Optional[int] = None, eval_every: int = 5,
                   target_accuracy: Optional[float] = None) -> Dict[str, Any]:
    """Run the tuning phase; track accuracy trajectory and time-to-target."""
    rounds = rounds if rounds is not None else runner.fl.rounds
    t_init0 = time.perf_counter()
    runner.init_phase()
    init_s = time.perf_counter() - t_init0
    history: List[Dict[str, float]] = []
    t0 = time.perf_counter()
    time_to_target = None
    for t in range(rounds):
        stats = runner.run_round(t)
        if (t + 1) % eval_every == 0 or t == rounds - 1:
            acc = runner.evaluate(test_data)
            stats["accuracy"] = acc
            stats["wall_s"] = time.perf_counter() - t0
            if target_accuracy and time_to_target is None and acc >= target_accuracy:
                time_to_target = stats["wall_s"]
        stats["round"] = t
        history.append(stats)
    return {
        "history": history,
        "final_accuracy": next(
            (h["accuracy"] for h in reversed(history) if "accuracy" in h), float("nan")
        ),
        "best_accuracy": max((h.get("accuracy", 0.0) for h in history), default=0.0),
        # tuning-phase wall only; the one-off init is reported separately
        "time_to_target_s": time_to_target,
        "init_s": init_s,
        "total_comm_bytes": float(np.sum(runner.comm_bytes_per_round)),
        "total_upload_bytes": float(np.sum(runner.comm_upload_bytes_per_round)),
        "wall_s": time.perf_counter() - t0,
    }
