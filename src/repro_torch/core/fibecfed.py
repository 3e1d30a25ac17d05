"""FibecFed, Algorithm 1 end to end, on host-simulated FL clients (port of
``repro.core.fibecfed``, loop engine).

Initialization phase (Alg. 1 lines 1-10):
  * per-device Fisher difficulty score per batch (Formulas 16-17), ascending
    sort (curriculum order);
  * per-device layer sensitivity scores (Eq. 9-10) → server aggregation
    (Eq. 11) → GAL selection with the configured fraction;
  * per-device momentum-FIM warmup → neuron masks for local update (§4.3.2).

Tuning phase (lines 11-19): sample the cohort, merge the global GAL weights
into each client's LoRA, curriculum-select batches, run masked local
SGD/AdamW, FedAvg the GAL part on the server with exact comm accounting.

The engine is the JAX package's ``"loop"`` engine, its semantic spec: one
training step per (client, batch) and host-side merge and FedAvg. Host
randomness (cohorts, ``random`` difficulty, ``gal_mode="random"``) comes from
``np.random.default_rng(seed)`` drawn in the JAX package's order, so the two
make the same decisions. The port runs on the card unless ``device`` says
otherwise; it never falls back to the CPU on its own.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.func import grad_and_value

from repro_torch.config import FibecFedConfig
from repro_torch.convert import lora_from_numpy, params_from_numpy
from repro_torch.core import curriculum as curr
from repro_torch.core import fisher as fish
from repro_torch.core import gal as galmod
from repro_torch.core import sparse as sparsemod
from repro_torch.core.curriculum import CurriculumSchedule
from repro_torch.data.pipeline import gather_batch, make_batches
from repro_torch.lora import gal_mask_tree, neuron_mask_tree
from repro_torch.models.model_api import ModelFns
from repro_torch.optim import make_optimizer
from repro_torch.train.losses import make_logits_loss
from repro_torch.utils.tree import tree_clone, tree_leaves, tree_map

ENGINES = ("loop",)

# options of the JAX runner that the port does not run yet, and the
# ROADMAP.md item that brings each
_UNPORTED = {
    "mesh": "Queue A item 13 (sharded engine)",
    "scenario": "Queue A item 9 (async engine)",
    "async_cfg": "Queue A item 9 (async engine)",
    "compression": "Queue A item 8 (compressed uploads)",
    "client_ranks": "Queue A item 8 (per-client ranks)",
    "store": "Queue A item 10 (client stores)",
    "hierarchy": "Queue A item 9 (edge aggregation)",
    "telemetry": "Queue A item 15 (telemetry)",
}
_ENGINE_ITEMS = {
    "vectorized": "Queue A item 7",
    "sharded": "Queue A item 13",
    "async": "Queue A item 9",
}


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; it is an error when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the port runs on a CUDA device and none is available; "
                "pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    return torch.device(device)


def check_ported(engine: str, fl: FibecFedConfig, **options) -> None:
    """Raise NotImplementedError for an engine or option not ported yet."""
    if engine not in ENGINES:
        item = _ENGINE_ITEMS.get(engine)
        if item is None:
            raise ValueError(f"unknown engine {engine!r}")
        raise NotImplementedError(f"engine={engine!r} is not ported yet (ROADMAP.md, {item})")
    for name, value in options.items():
        if value is not None:
            raise NotImplementedError(f"{name}= is not ported yet (ROADMAP.md, {_UNPORTED[name]})")
    if fl.gal_fraction is None or fl.sparse_ratio is None:
        raise NotImplementedError(
            "the lossless criteria (gal_fraction=None / sparse_ratio=None) are not "
            "ported yet (ROADMAP.md, Queue A item 14)"
        )


@dataclasses.dataclass
class ClientState:
    data: Dict[str, np.ndarray]
    n: int
    batches: List[np.ndarray]
    order: np.ndarray  # curriculum order over batches
    lora: Any
    opt_state: Any
    fim: Any = None  # momentum diag-FIM
    neuron_mask: Any = None  # update-mask tree (or None = dense)
    difficulty: Optional[np.ndarray] = None
    layer_scores: Optional[np.ndarray] = None


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch on ``device``; integer arrays become int64 indices."""
    return {
        k: torch.as_tensor(v, device=device).to(torch.int64)
        if np.issubdtype(v.dtype, np.integer) else torch.as_tensor(v, device=device)
        for k, v in batch.items()
    }


def _generator(device: torch.device, seed: int, stream: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + stream)


class FibecFed:
    def __init__(
        self,
        model: ModelFns,
        loss_fn: Callable,
        fl: FibecFedConfig,
        client_data: Sequence[Dict[str, np.ndarray]],
        *,
        optimizer: str = "sgd",
        fused_optimizer=False,
        difficulty_metric: str = "fisher",
        gal_mode: str = "importance",
        sparse_update: bool = True,
        engine: str = "loop",
        mesh: Any = None,
        scenario: Any = None,
        async_cfg: Any = None,
        compression: Any = None,
        client_ranks: Any = None,
        store: Any = None,
        hierarchy: Any = None,
        telemetry: Any = None,
        seed: int = 0,
        device=None,
        init_params: Any = None,
        init_lora: Any = None,
    ):
        """Build an FL runner over host-simulated clients.

        Args follow the JAX package's ``FibecFed``; those of engines and
        options not ported yet raise ``NotImplementedError``. Besides:

          device: where the model and the LoRA trees live; ``None`` is the
            CUDA device, and an error without one.
          init_params / init_lora: numpy trees (the JAX runner's ``params``
            and ``_init_lora``) to start from; by default both are drawn from
            ``torch.Generator``s seeded from ``seed``.
        """
        check_ported(
            engine, fl, mesh=mesh, scenario=scenario, async_cfg=async_cfg,
            compression=compression, client_ranks=client_ranks, store=store,
            hierarchy=hierarchy, telemetry=telemetry,
        )
        self.device = resolve_device(device)
        self.model = model
        self.cfg = model.cfg
        self.loss_fn = loss_fn
        self.fl = fl
        self.difficulty_metric = difficulty_metric
        self.gal_mode = gal_mode
        self.sparse_update = sparse_update
        self.engine = engine
        self.rng = np.random.default_rng(seed)

        if init_params is not None:
            self.params = params_from_numpy(init_params, self.cfg, self.device)
        else:
            self.params = model.init_params(_generator(self.device, seed, 0), self.device)
        if init_lora is not None:
            lora0 = lora_from_numpy(init_lora, self.device)
        else:
            lora0 = model.init_lora(_generator(self.device, seed, 1), self.device)
        self._init_lora = lora0
        self.global_lora = tree_clone(lora0)  # server copy (GAL part authoritative)

        self.optimizer_name = optimizer
        self.fused_optimizer = fused_optimizer
        self.opt_init, self.opt_update = make_optimizer(optimizer, fused=fused_optimizer)
        self.schedule = CurriculumSchedule(
            strategy=fl.curriculum,
            beta=fl.beta_initial_ratio,
            alpha=fl.alpha_full_data,
            total_rounds=fl.rounds,
        )
        self.clients: List[ClientState] = []
        for cd in client_data:
            n = len(next(iter(cd.values())))
            self.clients.append(ClientState(
                data=cd,
                n=n,
                batches=make_batches(n, fl.batch_size),
                order=np.arange(max(1, (n + fl.batch_size - 1) // fl.batch_size)),
                lora=tree_clone(lora0),
                opt_state=self.opt_init(lora0),
            ))

        self.gal_layers: Optional[np.ndarray] = None  # bool (L_logical,)
        self._gal_mask_tree = None
        self._gal_leaf_cache: Optional[List[tuple]] = None
        # bytes accounting (paper §5.6): LoRA params down + up per round,
        # wire itemsize per leaf
        self.comm_bytes_per_round: List[int] = []
        self.comm_upload_bytes_per_round: List[int] = []
        self.last_round_info: Optional[Dict[str, np.ndarray]] = None

    # ------------------------------------------------------------------
    # primitives
    # ------------------------------------------------------------------

    def _client_batch(self, client: ClientState, batch_ids: np.ndarray) -> Dict[str, torch.Tensor]:
        return to_device(gather_batch(client.data, batch_ids), self.device)

    def _train_step(self, lora, opt_state, batch, lr, mask):
        grads, loss = grad_and_value(lambda lo: self.loss_fn(self.params, lo, batch))(lora)
        new_lora, new_opt = self.opt_update(grads, opt_state, lora, lr, mask)
        return loss, new_lora, new_opt

    def _sensitivity(self, lora, batch) -> torch.Tensor:
        """Layer-sensitivity probe (Eq. 9-10) on one batch."""
        B, S = batch["tokens"].shape
        return galmod.layer_sensitivity_scores(
            self.model.forward_probe, make_logits_loss(self.cfg), self.params, lora, batch,
            gamma=self.fl.noise_budget, p=self.fl.norm_p, noise_shape=(B, S, self.cfg.d_model),
        )

    # ------------------------------------------------------------------
    # initialization phase (Alg. 1 lines 1-10)
    # ------------------------------------------------------------------

    def _batch_difficulty(self, client: ClientState) -> np.ndarray:
        metric = self.difficulty_metric
        scores = np.zeros(len(client.batches))
        for j, ids in enumerate(client.batches):
            if metric == "length":  # Shortformer/SLW-style static heuristic
                scores[j] = float(np.sum(client.data["tokens"][ids] != 0))
            elif metric == "random":
                scores[j] = self.rng.random()
            elif metric == "fisher":  # Formula 17
                batch = self._client_batch(client, ids)
                scores[j] = float(torch.sum(
                    fish.per_sample_fisher_scores(self.loss_fn, self.params, client.lora, batch)
                ))
            elif metric == "loss":  # SE/inference-loss heuristic baseline
                batch = self._client_batch(client, ids)
                with torch.no_grad():
                    scores[j] = float(self.loss_fn(self.params, client.lora, batch))
            else:
                raise ValueError(metric)
        return scores

    def _compute_difficulty(self) -> None:
        """Lines 2-5: per-batch difficulty + ascending curriculum order."""
        for client in self.clients:
            client.difficulty = self._batch_difficulty(client)
            client.order = curr.order_batches(client.difficulty, self.schedule.strategy)

    def _probe_sensitivity(self):
        """Per-client layer-sensitivity probe, aggregated server-side (Eq. 11).
        Returns ``(global_scores, fractions, ns)``."""
        scores_all, ns = [], []
        for client in self.clients:
            batch = self._client_batch(client, client.batches[int(client.order[0])])
            client.layer_scores = self._sensitivity(client.lora, batch).cpu().numpy()
            scores_all.append(client.layer_scores)
            ns.append(client.n)
        fractions = [self.fl.gal_fraction] * len(ns)
        return galmod.aggregate_layer_scores(scores_all, ns), fractions, ns

    def _select_local_masks(self) -> None:
        """Lines 8-10: momentum-FIM warmup → per-client neuron keep-masks."""
        fl = self.fl
        for client in self.clients:
            fim = None
            for e in range(fl.fim_warmup_epochs):
                ids = client.batches[int(client.order[min(e, len(client.order) - 1)])]
                batch = self._client_batch(client, ids)
                new = fish.fim_diag(self.loss_fn, self.params, client.lora, batch)
                fim = fish.fim_momentum_update(fim, new, fl.fim_momentum)
            client.fim = fim
            keep = sparsemod.select_neuron_masks(sparsemod.neuron_importance(fim), fl.sparse_ratio)
            client.neuron_mask = neuron_mask_tree(self.cfg, client.lora, keep)

    def _select_layers(self, global_scores: np.ndarray, n_star: int) -> np.ndarray:
        L = len(global_scores)
        mode = self.gal_mode
        if mode == "full":
            return np.ones(L, bool)
        if mode == "random":
            mask = np.zeros(L, bool)
            mask[self.rng.choice(L, n_star, replace=False)] = True
            return mask
        if mode == "ascending":  # ablation AO: *least* important layers
            mask = np.zeros(L, bool)
            mask[np.argsort(global_scores)[:n_star]] = True
            return mask
        if mode in ("importance", "descending"):
            return galmod.select_gal_layers(global_scores, n_star)
        raise ValueError(mode)

    def init_phase(self) -> None:
        # --- curriculum difficulty (lines 2-5) ---
        self._compute_difficulty()
        # --- layer sensitivity scores (Eq. 9-10) ---
        global_scores, fractions, ns = self._probe_sensitivity()
        # --- server: GAL selection (lines 6-7) ---
        n_star = galmod.gal_layer_count(fractions, ns, len(global_scores), self.fl.mu_global_local)
        self.gal_layers = self._select_layers(global_scores, n_star)
        self._gal_mask_tree = gal_mask_tree(self.cfg, self.global_lora, self.gal_layers)
        self._gal_leaf_cache = None
        # --- local update parameter selection (lines 8-10) ---
        if self.sparse_update:
            self._select_local_masks()

    # ------------------------------------------------------------------
    # tuning phase (Alg. 1 lines 11-19)
    # ------------------------------------------------------------------

    def _merge_global(self, client: ClientState) -> None:
        """Line 15: overwrite the GAL part of the client's LoRA."""
        client.lora = tree_map(
            # float mask arithmetic must not widen bf16 LoRA leaves
            lambda g, l, mm: (mm * g + (1.0 - mm) * l).to(l.dtype),
            self.global_lora, client.lora, self._gal_mask_tree,
        )

    def _gal_leaf_values(self) -> List[tuple]:
        """Per GAL-mask leaf: (unmasked value count, wire itemsize of the LoRA
        leaf's dtype). A mask leaf is broadcastable, one entry per layer
        slice, so each nonzero entry covers ``leaf.numel() // mask.numel()``
        values. The mask is fixed after init_phase: sum it once."""
        if self._gal_leaf_cache is None:
            self._gal_leaf_cache = [
                (int(float(torch.sum(mm))) * (leaf.numel() // mm.numel()), leaf.element_size())
                for mm, leaf in zip(tree_leaves(self._gal_mask_tree), tree_leaves(self.global_lora))
            ]
        return self._gal_leaf_cache

    def _client_upload_bytes(self) -> int:
        """Push wire bytes of one client: the unmasked GAL values, raw. The
        pull ships the same values the other way."""
        return sum(n * itemsize for n, itemsize in self._gal_leaf_values())

    def run_round(self, t: int, lr: Optional[float] = None) -> Dict[str, float]:
        fl = self.fl
        lr = fl.learning_rate if lr is None else lr
        k = min(fl.devices_per_round, len(self.clients))
        chosen = self.rng.choice(len(self.clients), k, replace=False)
        losses, updates, weights, sel_counts = [], [], [], []
        for ci in chosen:
            client = self.clients[ci]
            self._merge_global(client)
            sel = curr.selected_batch_ids(self.schedule, t, client.order)
            sel_counts.append(len(sel))
            for _ in range(fl.local_epochs):
                for j in sel:
                    batch = self._client_batch(client, client.batches[int(j)])
                    loss, client.lora, client.opt_state = self._train_step(
                        client.lora, client.opt_state, batch, lr, client.neuron_mask
                    )
                    losses.append(loss.detach())
            updates.append(client.lora)
            weights.append(client.n)
        self.last_round_info = {
            "chosen": np.asarray(chosen),
            "client_steps": np.asarray(sel_counts) * fl.local_epochs,
        }

        # --- server aggregation over GAL (line 18, FedAvg) ---
        # host weights in f64, normalized, each rounded to f32 as it scales
        # a client's leaf (the JAX package's promotion without x64)
        w = np.asarray(weights, np.float64)
        w = w / w.sum()

        def agg(g_old, mask, *client_loras):
            acc = 0
            for wi, cl in zip(w, client_loras):
                acc = acc + float(np.float32(wi)) * cl.to(torch.float32)
            return (mask * acc + (1.0 - mask) * g_old).to(g_old.dtype)

        self.global_lora = tree_map(agg, self.global_lora, self._gal_mask_tree, *updates)

        up = self._client_upload_bytes() * len(chosen)
        self.comm_bytes_per_round.append(2 * up)
        self.comm_upload_bytes_per_round.append(up)
        host_losses = [float(x) for x in losses]
        return {
            "loss": float(np.mean(host_losses)) if host_losses else float("nan"),
            "selected_batches": float(np.mean(sel_counts)),
            "comm_bytes": float(self.comm_bytes_per_round[-1]),
        }

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------

    def evaluate(self, data: Dict[str, np.ndarray], batch_size: int = 32) -> float:
        """Accuracy with the *server* model (GAL part global, the rest as
        initialized)."""
        n = len(next(iter(data.values())))
        correct, total = 0, 0
        with torch.no_grad():
            for i in range(0, n, batch_size):
                ids = np.arange(i, min(i + batch_size, n))
                batch = to_device(gather_batch(data, ids), self.device)
                logits, _ = self.model.forward(self.params, self.global_lora, batch)
                pred = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
                gold = data["label_token"][ids]
                correct += int((pred == gold).sum())
                total += len(gold)
        return correct / max(total, 1)
