"""FibecFed, Algorithm 1 end to end, on host-simulated FL clients (port of
``repro.core.fibecfed``).

Initialization phase (Alg. 1 lines 1-10):
  * per-device Fisher difficulty score per batch (Formulas 16-17), ascending
    sort (curriculum order);
  * per-device layer sensitivity scores (Eq. 9-10) → server aggregation
    (Eq. 11) → GAL selection with the configured fraction, or the lossless
    count (``gal_fraction=None``: Lanczos Hessian spectrum and Lipschitz
    margin per client, :mod:`repro_torch.core.gal`);
  * per-device momentum-FIM warmup → neuron masks for local update (§4.3.2),
    keeping the configured ρ or each client's lossless one
    (``sparse_ratio=None``).

Tuning phase (lines 11-19): sample the cohort, merge the global GAL weights
into each client's LoRA, curriculum-select batches, run masked local
SGD/AdamW, FedAvg the GAL part on the server with exact comm accounting.

Four interchangeable round engines (``engine=``), as in the JAX package:

* ``"vectorized"`` (default): client LoRA, optimizer state and masks are
  stacked along a leading client axis and each round trains the whole
  cohort per step (:mod:`repro_torch.core.engine`); the init phase scores
  all clients' batches and runs the FIM warmup over the stack.
* ``"loop"``: the semantic spec, one training step per (client, batch) and
  host-side merge and FedAvg.
* ``"sharded"``: the vectorized engine over a client mesh (``mesh=``, by
  default :func:`repro_torch.launch.mesh.make_client_mesh` over the default
  process group), one process a rank (multi-controller SPMD). Every rank
  builds the same runner and makes the same host decisions; rank r holds
  block r of the stacked client trees and trains block r of each round's
  cohort positions, and the FedAvg is an all-reduce. The stack and the
  cohort are padded to multiples of the mesh's client groups with inert
  rows (zero weight, zero valid steps). A rank reads a client's LoRA, FIM
  and neuron mask only where it owns the client;
  :meth:`FibecFed.population_state` (collective) gathers the population's
  stacked trees on every rank.
* ``"async"``: straggler-aware event-driven aggregation
  (:mod:`repro_torch.federated.async_agg`): an event queue on a virtual
  clock models per-client compute and comm latency under a heterogeneity
  ``scenario=`` (:mod:`repro_torch.federated.hetero`), each dispatched
  client runs its local round against the global version it pulled
  (:func:`repro_torch.core.engine.build_client_train_fn`), and the server
  merges any ``buffer_size`` completions into a double-buffered global with
  staleness-discounted FedAvg weights, flat or through an edge tier
  (``hierarchy=``, :mod:`repro_torch.federated.hierarchy`).
  ``async_cfg=`` layers the adaptive policies on top (delta merges with a
  server learning rate, a staleness cutoff, an adaptive buffer, per-client
  step counts, wall-clock-aware sampling). With the homogeneous scenario,
  buffer = cohort size and the policies at their defaults it reduces to the
  loop engine: the same cohorts, local steps and comm bytes, the merge
  summed by ``tensordot`` instead of the host loop.

All take ``compression=`` (a simulated compressed upload with error
feedback, kernel B3), ``client_ranks=`` (per-client LoRA ranks), ``store=``
(who owns the client states, :mod:`repro_torch.federated.store`: the
default in-memory store, or an out-of-core one that keeps an LRU hot set
resident and spills cold clients to one npz each, so that the vectorized
round runs over the fetched cohort alone) and ``telemetry=`` (a
:class:`repro_torch.obs.Telemetry`: wall-clock spans of the init phase and
its steps and of every round, the ``fl.*`` metrics and, on the async
engine, virtual-clock spans of every completion and the ``async.*``
metrics; enabling it changes no bit of a run). Host
randomness (cohorts, ``random`` difficulty, ``gal_mode="random"``) comes from
``np.random.default_rng(seed)`` drawn in the JAX package's order, so the two
make the same decisions. A runner's whole state snapshots and restores
(:meth:`FibecFed.checkpoint_state`, :meth:`FibecFed.restore_state`, written
by :mod:`repro_torch.checkpoint.federation` in the JAX package's layout), so
a run outlives its process. The port runs on the card unless ``device``
says otherwise; it never falls back to the CPU on its own.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.config import FibecFedConfig
from repro_torch.convert import lora_from_numpy, params_from_numpy
from repro_torch.core import curriculum as curr
from repro_torch.core import engine as eng
from repro_torch.core import fisher as fish
from repro_torch.core import gal as galmod
from repro_torch.core import sparse as sparsemod
from repro_torch.core.curriculum import CurriculumSchedule
from repro_torch.data.pipeline import bucket_size, gather_batch, make_batches, stack_clients, stack_cohort
from repro_torch.kernels import ops as kops
from repro_torch.lora import gal_mask_tree, lora_num_logical_layers, neuron_mask_tree, rank_mask_tree
from repro_torch.models.model_api import ModelFns
from repro_torch.models.transformer import torch_dtype
from repro_torch.obs import ensure as ensure_telemetry
from repro_torch.optim import make_optimizer
from repro_torch.train.losses import make_logits_loss
from repro_torch.utils.tree import host_array, tree_clone, tree_leaves, tree_map

ENGINES = ("vectorized", "loop", "sharded", "async")


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


def check_ported(engine: str, fl: FibecFedConfig) -> None:
    """Raise ValueError for an engine the JAX package does not have either;
    every engine and option of its runner is ported."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")


@dataclasses.dataclass
class ClientState:
    data: Dict[str, np.ndarray]
    n: int
    batches: List[np.ndarray]
    order: np.ndarray  # curriculum order over batches
    opt_state: Any  # the loop and async engines'; the vectorized engine stacks it
    fim: Any = None  # momentum diag-FIM
    neuron_mask: Any = None  # update-mask tree (or None = dense)
    difficulty: Optional[np.ndarray] = None
    layer_scores: Optional[np.ndarray] = None
    # the lossless criterion's keep fraction (gal_fraction=None or
    # sparse_ratio=None), and what it read: Ritz values and Lipschitz estimate
    lossless_fraction: float = 1.0
    lossless: Optional[Dict[str, Any]] = None
    # compression error-feedback residual (loop and async engines; the
    # vectorized engine keeps one stacked residual tree on the runner)
    ef_residual: Any = None
    # a LoRA tree of its own (loop and async engines) or a view into the
    # vectorized engine's stacked tree, taken only when read
    _lora: Any = None
    _lora_view: Optional[Callable[[], Any]] = None

    @property
    def lora(self) -> Any:
        if self._lora_view is not None:
            return self._lora_view()
        return self._lora

    @lora.setter
    def lora(self, value: Any) -> None:
        self._lora = value
        self._lora_view = None


class RemoteClientState(ClientState):
    """A sharded run's client whose stacked rows another rank holds: its host
    metadata (data, order, difficulty, layer scores, lossless fraction) is
    here, and reading its LoRA, FIM or neuron mask raises ``LookupError``
    naming the owner (:meth:`FibecFed.population_state` gathers them)."""

    owner: int = -1

    def _elsewhere(self, what: str):
        raise LookupError(f"this client's {what} lives on rank {self.owner} of the client mesh: read it there, "
                          "or gather the population's (FibecFed.population_state)")

    lora = property(lambda self: self._elsewhere("LoRA"), ClientState.lora.fset)
    fim = property(lambda self: self._elsewhere("FIM"), lambda self, v: setattr(self, "_fim", v))
    neuron_mask = property(lambda self: self._elsewhere("neuron mask"),
                           lambda self, v: setattr(self, "_neuron_mask", v))


def to_device(batch: Dict[str, np.ndarray], device, dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """A numpy batch on ``device``; integer arrays become int64 indices, and
    float arrays (a vlm's ``prefix_embeds``, an encoder-decoder's
    ``encoder_embeds``) take ``dtype``, the model's, where it is given."""
    return {
        k: torch.as_tensor(v, device=device).to(torch.int64)
        if np.issubdtype(v.dtype, np.integer) else torch.as_tensor(v, device=device, dtype=dtype)
        for k, v in batch.items()
    }


def _generator(device: torch.device, seed: int, stream: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + stream)


def _lossless_draw(device: torch.device, seed: int, ci: int) -> galmod.Draw:
    """Client ``ci``'s normal draws for the lossless criterion, from a
    ``torch.Generator`` of its own seeded from ``seed`` and ``1000 + ci``
    (the JAX runner folds ``1000 + ci`` into its key)."""
    gen = _generator(device, seed, 1000 + ci)
    return lambda j, shape: torch.randn(shape, generator=gen, device=gen.device)


def _stack_copies(tree, n: int):
    """``n`` copies of every leaf, stacked on a new leading axis."""
    return tree_map(lambda x: x[None].expand(n, *x.shape).clone(), tree)


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


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
        engine: str = "vectorized",
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

        Args follow the JAX package's ``FibecFed``. ``mesh=`` is the sharded
        engine's client mesh (:mod:`repro_torch.launch.mesh`; ``None``:
        ``make_client_mesh`` over the default process group, which the
        caller has initialized) and a ``ValueError`` on the other engines.
        ``store=`` is a :mod:`repro_torch.federated.store` store (``None``:
        an ``InMemoryStore``); with an ``OutOfCoreStore`` the vectorized
        round runs over the fetched cohort and the async engine pins clients
        in flight or buffered; the sharded engine refuses one (its stack is
        resident by construction). ``scenario=`` and ``async_cfg=``
        (:mod:`repro_torch.federated.hetero`,
        :class:`repro_torch.federated.AsyncAggConfig`) and ``hierarchy=`` (an
        edge count or :class:`repro_torch.federated.HierarchyConfig`) are the
        async engine's and a ``ValueError`` on the others. Besides:

          telemetry: a ``repro_torch.obs.Telemetry``; ``None`` installs the
            no-op recorder. The JAX runner's ``jit.*_traces`` gauges have no
            counterpart: the port compiles no programs.
          device: where the model and the LoRA trees live; ``None`` is the
            CUDA device (on the sharded engine the rank's current one, which
            the launcher sets), and an error without one. A mesh of another
            device type is a ``ValueError``.
          init_params / init_lora: numpy trees (the JAX runner's ``params``
            and ``_init_lora``) to start from; by default both are drawn from
            ``torch.Generator``s seeded from ``seed``.
        """
        check_ported(engine, fl)
        if engine != "sharded" and mesh is not None:
            raise ValueError("mesh= is only meaningful with engine='sharded'")
        if engine != "async" and (scenario is not None or async_cfg is not None):
            raise ValueError("scenario=/async_cfg= are only meaningful with engine='async'")
        if hierarchy is not None and engine != "async":
            raise ValueError("hierarchy= is only meaningful with engine='async'")
        # lazy imports: the federated package's init imports this module
        from repro_torch.federated.hierarchy import get_hierarchy
        from repro_torch.federated.store import ClientsView, InMemoryStore

        self._hierarchy = None if hierarchy is None else get_hierarchy(hierarchy)
        if engine == "sharded" and device is None and torch.cuda.is_available():
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = resolve_device(device)
        if engine == "sharded":
            from repro_torch.launch.mesh import make_client_mesh

            mesh = make_client_mesh(device_type=self.device.type) if mesh is None else mesh
            if mesh.device_type != self.device.type:
                raise ValueError(f"the client mesh is on {mesh.device_type!r} devices, the runner on "
                                 f"{self.device.type!r}")
        self.mesh = mesh
        self.tel = ensure_telemetry(telemetry)
        self.model = model
        self.cfg = model.cfg
        self._data_dtype = torch_dtype(self.cfg.dtype)  # float client data (prefix/encoder embeds)
        self.loss_fn = loss_fn
        self.fl = fl
        self.difficulty_metric = difficulty_metric
        self.gal_mode = gal_mode
        self.sparse_update = sparse_update
        self.engine = engine
        self.rng = np.random.default_rng(seed)
        self.seed = seed

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

        if engine == "async":
            from repro_torch.federated.async_agg import AsyncAggConfig, DoubleBufferedGlobal
            from repro_torch.federated.hetero import get_scenario

            self.scenario = get_scenario(scenario)
            self.async_cfg = async_cfg if async_cfg is not None else AsyncAggConfig()
            self._global = DoubleBufferedGlobal(self.global_lora)
            self._scheduler = None  # built on the first async round

        # --- compressed uploads + per-client ranks ---
        from repro_torch.federated.compress import CompressionConfig

        if engine == "async" and self.async_cfg.compression is not None:
            if compression is not None and compression != self.async_cfg.compression:
                raise ValueError("compression= conflicts with async_cfg.compression; set one")
            compression = self.async_cfg.compression
        if compression is not None and not isinstance(compression, CompressionConfig):
            raise TypeError(f"compression must be a CompressionConfig, got {type(compression)!r}")
        # mode="none" normalizes to None: the uncompressed paths, exactly
        self.compression = compression if compression is not None and compression.enabled else None
        self.client_ranks = None
        if client_ranks is None and engine == "async" and self.scenario.slow_rank_fraction < 1.0:
            # the scenario's slow group carries its rank budget, bound on the
            # scenario's own stream as the scheduler binds it
            from repro_torch.federated.hetero import SCENARIO_SEED_OFFSET

            bound = self.scenario.bind(len(client_data), seed=seed + SCENARIO_SEED_OFFSET)
            client_ranks = bound.client_ranks(self.cfg.lora_rank)
        if client_ranks is not None:
            ranks = np.asarray(client_ranks, np.int64)
            if ranks.shape != (len(client_data),):
                raise ValueError("client_ranks needs exactly one rank per client")
            if np.any(ranks < 1) or np.any(ranks > self.cfg.lora_rank):
                raise ValueError(f"client_ranks must lie in [1, {self.cfg.lora_rank}]")
            if not np.all(ranks == self.cfg.lora_rank):  # full ranks: an exact no-op
                self.client_ranks = ranks
        self._rank_mask_cache: Dict[int, Any] = {}
        self._comp_mask_cache: Dict[int, Any] = {}

        self.store = InMemoryStore() if store is None else store
        oocore = self._oocore = bool(self.store.out_of_core)
        if oocore and engine == "sharded":
            raise ValueError("engine='sharded' keeps the mesh-sharded population stack resident by "
                             "construction; use an in-memory store")
        # the in-memory vectorized and sharded engines: client trees stacked
        # on the runner and clients viewing them; every other engine and
        # store holds each client's LoRA and optimizer state apart
        stacked = self._stacked = engine in ("vectorized", "sharded") and not oocore
        # the stack's layout: C_stack rows in G blocks of rows_per_rank, this
        # rank's from row0; the sharded engine pads the stack with inert rows
        # so that it and each round's cohort (to _cohort_pad) divide by G
        C = len(client_data)
        k = min(fl.devices_per_round, C)
        G, self._rank, self._group = 1, 0, None
        if mesh is not None:
            self._group, G, self._rank = eng.mesh_group(mesh)
        self._cohort_pad = -(-k // G) * G
        self._C_stack = -(-(C + self._cohort_pad - k) // G) * G if mesh is not None else C
        self._rows_per_rank = self._C_stack // G
        self._row0 = self._rank * self._rows_per_rank

        def _make_state(ci: int) -> ClientState:
            if stacked and not self._owns(ci):
                state = _make_shell(ci, RemoteClientState)
                state.owner = ci // self._rows_per_rank
                return state
            state = _make_shell(ci)
            if not stacked:
                state.lora, state.opt_state = tree_clone(lora0), self.opt_init(lora0)
            return state

        def _make_shell(ci: int, cls=ClientState) -> ClientState:
            # also the scaffold of a spilled client: the store fills in its
            # host metadata and its trees from the client's npz
            cd = client_data[ci]
            n = len(next(iter(cd.values())))
            return cls(
                data=cd,
                n=n,
                batches=make_batches(n, fl.batch_size),
                order=np.arange(max(1, (n + fl.batch_size - 1) // fl.batch_size)),
                opt_state=None,
            )

        self.store.bind(client_data=client_data, make_state=_make_state, make_shell=_make_shell,
                        telemetry=self.tel, device=self.device)
        self.clients: Sequence[ClientState] = ClientsView(self.store)
        if stacked:
            # this rank's block of the (padded) population stack
            rows = self._local_rows()
            stack = stack_clients(client_data, fl.batch_size, pad_clients_to=self._C_stack)
            self._stack_data = to_device({k_: v[rows] for k_, v in stack.data.items()}, self.device,
                                         self._data_dtype)
            self._sample_valid = torch.as_tensor(stack.sample_valid[rows], device=self.device)
            self._stacked_lora = _stack_copies(lora0, self._rows_per_rank)
            self._stacked_opt = _stack_copies(self.opt_init(lora0), self._rows_per_rank)
            for ci in self._owned_clients():
                self.clients[ci]._lora_view = lambda i=ci - self._row0: tree_map(lambda x: x[i], self._stacked_lora)
        # built in init_phase: the stacked neuron masks, and the compression
        # state (stacked error-feedback residuals, per-client top-k count
        # masks); an out-of-core store keeps each client's own
        self._stacked_mask = None
        self._stacked_residual = None
        self._stacked_comp_mask = None

        self.gal_layers: Optional[np.ndarray] = None  # bool (L_logical,)
        self._gal_mask_tree = None
        self._gal_leaf_cache: Optional[List[tuple]] = None
        self._comm_bytes_cache: Dict[Optional[int], tuple] = {}
        # bytes accounting (paper §5.6): LoRA params down + up per round,
        # wire itemsize per leaf; the upload-only series isolates the
        # compressed push (the pull is always raw)
        self.comm_bytes_per_round: List[int] = []
        self.comm_upload_bytes_per_round: List[int] = []
        self.last_round_info: Optional[Dict[str, np.ndarray]] = None

    # ------------------------------------------------------------------
    # primitives
    # ------------------------------------------------------------------

    def _local_rows(self) -> slice:
        """This rank's rows of the population stack (all of it off a mesh)."""
        return slice(self._row0, self._row0 + self._rows_per_rank)

    def _owns(self, ci: int) -> bool:
        return self._row0 <= ci < self._row0 + self._rows_per_rank

    def _owned_clients(self) -> range:
        """The real clients whose stacked rows this rank holds."""
        return range(self._row0, min(self._row0 + self._rows_per_rank, len(self.clients)))

    def _row_client(self, i: int) -> int:
        """The client whose settings local stack row ``i`` takes: its own,
        or client 0's for an inert padding row (never trained; any finite
        mask will do)."""
        ci = self._row0 + i
        return ci if ci < len(self.clients) else 0

    def _client_batch(self, client: ClientState, batch_ids: np.ndarray) -> Dict[str, torch.Tensor]:
        return to_device(gather_batch(client.data, batch_ids), self.device, self._data_dtype)

    def _sensitivity(self, lora, batch) -> torch.Tensor:
        """Layer-sensitivity probe (Eq. 9-10) on one batch."""
        B, T = batch["tokens"].shape
        S = T + (self.cfg.num_prefix_embeddings if self.cfg.family == "vlm" else 0)
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
        if self._stacked and self.difficulty_metric in ("fisher", "loss"):
            # every client's batches, each client scored with its own LoRA
            # (a re-init after training rounds must see the trained LoRA);
            # on a mesh each rank scores its rows and all see every score
            metric = self.difficulty_metric
            diff = (eng.build_sharded_difficulty_fn(self.loss_fn, metric, self.mesh) if self.mesh is not None
                    else eng.build_difficulty_fn(self.loss_fn, metric))
            scores = diff(self.params, self._stacked_lora, self._stack_data, self._sample_valid)
            scores = scores.cpu().numpy()
            for ci, client in enumerate(self.clients):
                client.difficulty = scores[ci, : len(client.batches)]
                client.order = curr.order_batches(client.difficulty, self.schedule.strategy)
            return
        for client in self.clients:
            client.difficulty = self._batch_difficulty(client)
            client.order = curr.order_batches(client.difficulty, self.schedule.strategy)

    def _probe_sensitivity(self):
        """Per-client layer-sensitivity probe (Eq. 9-10) and, where a
        fraction is left to the lossless criterion, its estimate (costly),
        aggregated server-side (Eq. 11). Returns ``(global_scores,
        fractions, ns)``. On a mesh each client's owner probes it, and the
        scores and fractions are all-gathered (the criterion's Ritz values
        stay on the owner)."""
        fl = self.fl
        lossless = fl.gal_fraction is None or fl.sparse_ratio is None
        for ci in self._owned_clients():
            client = self.clients[ci]
            batch = self._client_batch(client, client.batches[int(client.order[0])])
            client.layer_scores = self._sensitivity(client.lora, batch).cpu().numpy()
            if lossless:
                client.lossless = galmod.lossless_criterion(
                    self.loss_fn, self.params, client.lora, batch, _lossless_draw(self.device, self.seed, ci),
                    iters=fl.lanczos_iters,
                )
                client.lossless_fraction = client.lossless["fraction"]
        if self.mesh is not None:
            self._share_probes()
        scores_all = [c.layer_scores for c in self.clients]
        ns = [c.n for c in self.clients]
        fractions = [c.lossless_fraction if fl.gal_fraction is None else fl.gal_fraction for c in self.clients]
        return galmod.aggregate_layer_scores(scores_all, ns), fractions, ns

    def _share_probes(self) -> None:
        """All-gather the owners' layer scores (f32) and lossless fractions
        (f64, as the host floats they are) over the mesh: one row a stack
        row, inert rows zero."""
        L = lora_num_logical_layers(self.cfg)
        mine = np.zeros((self._rows_per_rank, L + 1), np.float64)
        for ci in self._owned_clients():
            c = self.clients[ci]
            mine[ci - self._row0] = np.append(np.asarray(c.layer_scores, np.float64), c.lossless_fraction)
        full = eng.all_gather_rows([torch.as_tensor(mine, device=self.device)], self.mesh)[0].cpu().numpy()
        for ci, c in enumerate(self.clients):
            if not self._owns(ci):
                c.layer_scores = full[ci, :L].astype(np.float32)
                c.lossless_fraction = float(full[ci, L])

    def _select_local_masks(self) -> None:
        """Lines 8-10: momentum-FIM warmup → per-client neuron keep-masks."""
        fl = self.fl
        if self._stacked:
            # this rank's rows; an inert padding row warms up on its (invalid) batch 0
            R = self._rows_per_rank
            warm = np.zeros((R, fl.fim_warmup_epochs), np.int64)
            for ci in self._owned_clients():
                order = self.clients[ci].order
                warm[ci - self._row0] = [int(order[min(e, len(order) - 1)]) for e in range(fl.fim_warmup_epochs)]
            warm_idx = torch.as_tensor(warm, device=self.device)
            rows = torch.arange(R, device=self.device)[:, None]
            wdata = {k: v[rows, warm_idx] for k, v in self._stack_data.items()}
            warm_fn = (eng.build_sharded_fim_warmup_fn(self.loss_fn, fl.fim_momentum, self.mesh)
                       if self.mesh is not None else eng.build_fim_warmup_fn(self.loss_fn, fl.fim_momentum))
            fims = warm_fn(self.params, self._stacked_lora, wdata, self._sample_valid[rows, warm_idx])
            importance = sparsemod.neuron_importance(fims)
            if fl.sparse_ratio is not None:
                keep = sparsemod.select_neuron_masks(importance, fl.sparse_ratio)
                per_row = [tree_map(lambda x, i=i: x[i], keep) for i in range(R)]
            else:  # each client's lossless ρ
                per_row = [
                    sparsemod.select_neuron_masks(tree_map(lambda x, i=i: x[i], importance),
                                                  self.clients[self._row_client(i)].lossless_fraction)
                    for i in range(R)
                ]
            self._stacked_mask = _stack([neuron_mask_tree(self.cfg, self._init_lora, k) for k in per_row])
            for ci in self._owned_clients():
                client, i = self.clients[ci], ci - self._row0
                client.fim = tree_map(lambda x: x[i], fims)
                client.neuron_mask = tree_map(lambda x: x[i], self._stacked_mask)
            return
        for client in self.clients:
            fim = None
            for e in range(fl.fim_warmup_epochs):
                ids = client.batches[int(client.order[min(e, len(client.order) - 1)])]
                batch = self._client_batch(client, ids)
                new = fish.fim_diag(self.loss_fn, self.params, client.lora, batch)
                fim = fish.fim_momentum_update(fim, new, fl.fim_momentum)
            client.fim = fim
            rho = fl.sparse_ratio if fl.sparse_ratio is not None else client.lossless_fraction
            keep = sparsemod.select_neuron_masks(sparsemod.neuron_importance(fim), rho)
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
        with self.tel.span("init_phase", cat="fl", track="server"):
            self._init_phase_body()

    def _init_phase_body(self) -> None:
        # --- curriculum difficulty (lines 2-5) ---
        with self.tel.span("difficulty", cat="fl", track="server"):
            self._compute_difficulty()
        # --- layer sensitivity scores (Eq. 9-10) ---
        fl = self.fl
        with self.tel.span("sensitivity", cat="fl", track="server"):
            if (self._oocore and fl.gal_fraction is not None and fl.sparse_ratio is not None
                    and self.gal_mode in ("full", "random")):
                # population-scale fast path: with both fractions pinned and
                # a score-blind GAL mode, the probe could only feed scores
                # nobody reads, so no cold client is faulted in for it. The
                # sample counts come from the store; the GAL selection below
                # is what an in-memory run of this configuration computes.
                global_scores = np.zeros(lora_num_logical_layers(self.cfg))
                ns = [int(n) for n in self.store.sample_counts()]
                fractions = [fl.gal_fraction] * len(ns)
            else:
                global_scores, fractions, ns = self._probe_sensitivity()
        # --- server: GAL selection (lines 6-7) ---
        n_star = galmod.gal_layer_count(fractions, ns, len(global_scores), fl.mu_global_local)
        self.gal_layers = self._select_layers(global_scores, n_star)
        self._gal_mask_tree = gal_mask_tree(self.cfg, self.global_lora, self.gal_layers)
        self._gal_leaf_cache = None
        self._comm_bytes_cache = {}
        self._comp_mask_cache = {}
        # --- local update parameter selection (lines 8-10) ---
        if self.sparse_update:
            with self.tel.span("fim_warmup", cat="fl", track="server"):
                self._select_local_masks()
        # --- per-client ranks: fold the keep-masks into the update masks ---
        if self.client_ranks is not None:
            self._fold_rank_masks()
        # --- compression state: the residuals live on the GAL support, so
        # a re-init resets them; the top-k count masks likewise ---
        self._reset_compression_state()

    def _rank_mask(self, rank: int) -> Any:
        if rank not in self._rank_mask_cache:
            self._rank_mask_cache[rank] = rank_mask_tree(self._init_lora, rank)
        return self._rank_mask_cache[rank]

    def _comp_mask(self, ci: int) -> Any:
        """Top-k count mask of client ``ci``: GAL support × rank keep-mask
        (the fraction is taken of the values the client can send). Cached
        per distinct rank."""
        rank = int(self.client_ranks[ci])
        if rank not in self._comp_mask_cache:
            self._comp_mask_cache[rank] = tree_map(lambda m, r: m * r, self._gal_mask_tree,
                                                   self._rank_mask(rank))
        return self._comp_mask_cache[rank]

    def _fold_rank_masks(self) -> None:
        """Fold per-client rank keep-masks into the update masks. A rank-r_i
        client's beyond-rank components stay frozen at the pulled values, so
        its delta there is exactly zero and the masked FedAvg aggregates
        rank-heterogeneous updates into the full server rank. Idempotent
        (binary masks), so a repeated ``init_phase`` is safe."""
        if self._stacked:
            stacked = _stack([self._rank_mask(int(self.client_ranks[self._row_client(i)]))
                              for i in range(self._rows_per_rank)])
            self._stacked_mask = (stacked if self._stacked_mask is None
                                  else tree_map(torch.mul, self._stacked_mask, stacked))
            for ci in self._owned_clients():
                self.clients[ci].neuron_mask = tree_map(lambda x, i=ci - self._row0: x[i], self._stacked_mask)
            return
        per_client = [self._rank_mask(int(r)) for r in self.client_ranks]
        for client, rm in zip(self.clients, per_client):
            client.neuron_mask = rm if client.neuron_mask is None else tree_map(
                torch.mul, client.neuron_mask, rm)

    def _reset_compression_state(self) -> None:
        """Zero the error-feedback residuals and (re)build the stacked top-k
        count masks."""
        comp = self.compression
        if comp is None:
            return
        if self._stacked:
            if comp.error_feedback:
                self._stacked_residual = tree_map(torch.zeros_like, self._stacked_lora)
            if comp.use_thresh and self.client_ranks is not None:
                self._stacked_comp_mask = _stack([self._comp_mask(self._row_client(i))
                                                  for i in range(self._rows_per_rank)])
            return
        if comp.error_feedback:
            for client in self.clients:
                client.ef_residual = tree_map(torch.zeros_like, self._init_lora)

    # ------------------------------------------------------------------
    # tuning phase (Alg. 1 lines 11-19)
    # ------------------------------------------------------------------

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

    def _client_comm_bytes(self, ci: int) -> tuple:
        """(down, up) wire bytes of client ``ci`` in one round: the pull
        ships the client's rank projection of the unmasked GAL values raw,
        the push the compressed payload (values + scales + top-k indices)
        under ``self.compression``. Cached per distinct rank."""
        from repro_torch.federated.compress import leaf_upload_bytes

        rank = None if self.client_ranks is None else int(self.client_ranks[ci])
        if rank not in self._comm_bytes_cache:
            R = self.cfg.lora_rank
            down = up = 0
            for n, itemsize in self._gal_leaf_values():
                # the rank axis is a full dimension of every LoRA leaf, so
                # the rank projection is exact integer arithmetic
                n_r = n if rank is None else (n * rank) // R
                down += n_r * itemsize
                up += leaf_upload_bytes(n_r, itemsize, self.compression)
            self._comm_bytes_cache[rank] = (down, up)
        return self._comm_bytes_cache[rank]

    def _gal_bytes(self, chosen) -> tuple:
        """The round's comm bytes over the cohort: (total, upload only)."""
        pairs = [self._client_comm_bytes(int(ci)) for ci in chosen]
        return sum(d + u for d, u in pairs), sum(u for _, u in pairs)

    def _record_comm(self, chosen) -> None:
        total, up = self._gal_bytes(chosen)
        self.comm_bytes_per_round.append(total)
        self.comm_upload_bytes_per_round.append(up)

    def _compress_client(self, ci: int, client: ClientState, pulled: Any):
        """The compressed upload of one client (loop and async engines): fake-quantize
        the masked GAL delta plus the carried residual, keep the new
        residual, and return the reconstructed delta the server receives.
        The quantizer maps 0 to 0, so it stays on the GAL support."""
        comp = self.compression
        delta = tree_map(lambda nl, g, mm: (nl - g) * mm, client.lora, pulled, self._gal_mask_tree)
        cm = None
        if comp.use_thresh:
            cm = self._comp_mask(ci) if self.client_ranks is not None else self._gal_mask_tree
        y, new_res = kops.fake_compress(
            delta, client.ef_residual if comp.error_feedback else None, cm,
            qmax=comp.qmax, topk_ratio=comp.topk_ratio, use_thresh=comp.use_thresh,
        )
        if comp.error_feedback:
            client.ef_residual = new_res
        return y

    def run_round(self, t: int, lr: Optional[float] = None) -> Dict[str, float]:
        if not self.tel.enabled:
            return self._dispatch_round(t, lr)
        tel = self.tel
        start = tel.tracer.now()
        with tel.span("round", cat="fl", track="server", args={"t": t, "engine": self.engine}) as sargs:
            stats = self._dispatch_round(t, lr)
            sargs["loss"] = stats.get("loss")
            sargs["comm_bytes"] = stats.get("comm_bytes")
        dur = tel.tracer.now() - start
        m = tel.metrics
        m.counter("fl.rounds").inc()
        m.histogram("fl.round_s").observe(dur)
        if dur > 0.0:
            m.gauge("fl.rounds_per_s").set(1.0 / dur)
        loss = stats.get("loss")
        if loss is not None and not np.isnan(loss):
            m.histogram("fl.round_loss").observe(loss)
        if self.comm_bytes_per_round:
            m.counter("fl.comm_bytes").inc(self.comm_bytes_per_round[-1])
            m.counter("fl.comm_upload_bytes").inc(self.comm_upload_bytes_per_round[-1])
        return stats

    def _dispatch_round(self, t: int, lr: Optional[float] = None) -> Dict[str, float]:
        if self.engine == "async":
            return self._run_round_async(t, lr)
        if self.engine in ("vectorized", "sharded"):
            if self._oocore:
                return self._run_round_cohort(t, lr)
            return self._run_round_vectorized(t, lr)
        return self._run_round_loop(t, lr)

    def _run_round_loop(self, t: int, lr: Optional[float] = None) -> Dict[str, float]:
        fl = self.fl
        lr = fl.learning_rate if lr is None else lr
        k = min(fl.devices_per_round, len(self.clients))
        chosen = self.rng.choice(len(self.clients), k, replace=False)
        # the pulled global the cohort trains against (only reassigned after
        # the FedAvg below), for the compressed delta
        g0 = self.global_lora
        train_fn = eng.build_client_train_fn(self.loss_fn, self.opt_update)
        losses, updates, weights, sel_counts = [], [], [], []
        for ci in chosen:
            client = self.clients[ci]
            # line 15, then the selected batches, epoch-major
            batch_idx, step_valid = curr.step_plan(self.schedule, t, [client.order], fl.local_epochs)
            client.lora, client.opt_state, client_losses = train_fn(
                self.params, g0, client.lora, client.opt_state, client.neuron_mask, self._gal_mask_tree,
                lambda j: self._client_batch(client, client.batches[j]), batch_idx[0], step_valid[0], lr,
            )
            losses.extend(client_losses[s] for s in np.flatnonzero(step_valid[0]))
            sel_counts.append(int(step_valid.sum()) // fl.local_epochs)
            if self.compression is not None:
                y = self._compress_client(int(ci), client, g0)
                # value-form payload: the weighted GAL average of g0 + y_i
                # is the delta merge g0 + Σ w_i y_i
                updates.append(tree_map(lambda g, yy: (g + yy).to(g.dtype), g0, y))
            else:
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
        self._record_comm(chosen)
        host_losses = [float(x) for x in losses]
        return {
            "loss": float(np.mean(host_losses)) if host_losses else float("nan"),
            "selected_batches": float(np.mean(sel_counts)),
            "comm_bytes": float(self.comm_bytes_per_round[-1]),
        }

    def _compress_static(self) -> Optional[Dict[str, Any]]:
        c = self.compression
        if c is None:
            return None
        return {
            "qmax": c.qmax,
            "topk_ratio": c.topk_ratio,
            "use_thresh": c.use_thresh,
            "error_feedback": c.error_feedback,
            "has_comp_mask": bool(c.use_thresh and self.client_ranks is not None),
        }

    def _run_round_vectorized(self, t: int, lr: Optional[float] = None) -> Dict[str, float]:
        fl = self.fl
        lr = fl.learning_rate if lr is None else lr
        k = min(fl.devices_per_round, len(self.clients))
        chosen = self.rng.choice(len(self.clients), k, replace=False)
        orders = [self.clients[ci].order for ci in chosen]
        batch_idx, step_valid = curr.step_plan(self.schedule, t, orders, fl.local_epochs)
        w = np.asarray([self.clients[ci].n for ci in chosen], np.float64)
        w = (w / w.sum()).astype(np.float32)
        rows, plan, valid_plan, w_pad = chosen, batch_idx, step_valid, w
        if self._cohort_pad > k:
            # the sharded engine: pad the cohort onto the stack's inert rows
            # (distinct, so no row is written twice; zero weight and zero
            # valid steps make them no-ops)
            pad_n = self._cohort_pad - k
            rows = np.concatenate([chosen, np.arange(len(self.clients), len(self.clients) + pad_n)])
            plan = np.pad(batch_idx, ((0, pad_n), (0, 0)))
            valid_plan = np.pad(step_valid, ((0, pad_n), (0, 0)))
            w_pad = np.pad(w, (0, pad_n))

        use_mask, comp = self._stacked_mask is not None, self._compress_static()
        if self.mesh is not None:
            round_fn = eng.build_sharded_round_fn(self.loss_fn, self.opt_update, use_neuron_mask=use_mask,
                                                  mesh=self.mesh, compress=comp)
        else:
            round_fn = eng.build_round_fn(self.loss_fn, self.opt_update, use_neuron_mask=use_mask, compress=comp)
        dev = self.device
        self.global_lora, losses = round_fn(
            self.params, self.global_lora, self._stacked_lora, self._stacked_opt,
            self._stacked_mask, self._gal_mask_tree, self._stack_data, self._sample_valid,
            torch.as_tensor(rows, dtype=torch.int64, device=dev),
            torch.as_tensor(plan, dtype=torch.int64, device=dev),
            torch.as_tensor(valid_plan, device=dev), torch.as_tensor(w_pad, device=dev), lr,
            self._stacked_residual, self._stacked_comp_mask,
        )
        losses = losses.cpu().numpy()[:, :k]  # (S, k): the real clients' columns
        valid = step_valid.T
        self.last_round_info = {
            "chosen": np.asarray(chosen),
            "client_steps": step_valid.sum(axis=1).astype(np.int64),
        }
        self._record_comm(chosen)
        return {
            "loss": float(np.sum(losses * valid) / max(np.sum(valid), 1.0)),
            "selected_batches": float(np.mean(
                [len(curr.selected_batch_ids(self.schedule, t, o)) for o in orders])),
            "comm_bytes": float(self.comm_bytes_per_round[-1]),
            # the round's padded step count (power-of-two bucketed)
            "padded_steps": float(batch_idx.shape[1]),
        }

    def _run_round_cohort(self, t: int, lr: Optional[float] = None) -> Dict[str, float]:
        """The vectorized round against an out-of-core client store.

        The cohort draw, curriculum plan, FedAvg weights and comm accounting
        of :meth:`_run_round_vectorized`, but only the cohort's states are
        fetched (pinned against eviction for the round) and stacked on a
        leading k axis with their data grid, streamed per round
        (:func:`stack_cohort`, the batch axis bucketed to a power of two).
        The round body is the vectorized engine's own,
        :func:`repro_torch.core.engine.build_round_fn` over the cohort stack
        with ``chosen = arange(k)``; its outputs are unstacked back into the
        store. Peak memory scales with the cohort and the hot set, never the
        population.
        """
        fl = self.fl
        lr = fl.learning_rate if lr is None else lr
        C = len(self.clients)
        k = min(fl.devices_per_round, C)
        chosen = self.rng.choice(C, k, replace=False)
        cohort = [int(ci) for ci in chosen]
        dev = self.device
        for ci in cohort:
            self.store.pin(ci)
        try:
            states = [self.clients[ci] for ci in cohort]
            orders = [s.order for s in states]
            batch_idx, step_valid = curr.step_plan(self.schedule, t, orders, fl.local_epochs)
            w = np.asarray([s.n for s in states], np.float64)
            w = (w / w.sum()).astype(np.float32)
            grid = stack_cohort([self.store.client_data(ci) for ci in cohort], fl.batch_size,
                                pad_batches_to=bucket_size(max(len(s.batches) for s in states)))
            use_mask = states[0].neuron_mask is not None
            comp = self._compress_static()
            ef = comp is not None and comp["error_feedback"]
            lora, opt = _stack([s.lora for s in states]), _stack([s.opt_state for s in states])
            residual = _stack([s.ef_residual for s in states]) if ef else None
            round_fn = eng.build_round_fn(self.loss_fn, self.opt_update, use_neuron_mask=use_mask, compress=comp)
            self.global_lora, losses = round_fn(
                self.params, self.global_lora, lora, opt,
                _stack([s.neuron_mask for s in states]) if use_mask else None, self._gal_mask_tree,
                to_device(grid.data, dev, self._data_dtype), torch.as_tensor(grid.sample_valid, device=dev),
                torch.arange(k, device=dev), torch.as_tensor(batch_idx, dtype=torch.int64, device=dev),
                torch.as_tensor(step_valid, device=dev), torch.as_tensor(w, device=dev), lr,
                residual, _stack([self._comp_mask(ci) for ci in cohort]) if comp and comp["has_comp_mask"] else None,
            )
            # round_fn wrote the cohort's new trees into the stacks in place
            for i, (ci, s) in enumerate(zip(cohort, states)):
                s.lora = tree_map(lambda x: x[i], lora)
                s.opt_state = tree_map(lambda x: x[i], opt)
                if ef:
                    s.ef_residual = tree_map(lambda x: x[i], residual)
                self.store.put(ci, s)
        finally:
            for ci in cohort:
                self.store.unpin(ci)
        losses = losses.cpu().numpy()  # (S, k)
        valid = step_valid.T
        self.last_round_info = {
            "chosen": np.asarray(chosen),
            "client_steps": step_valid.sum(axis=1).astype(np.int64),
        }
        self._record_comm(chosen)
        return {
            "loss": float(np.sum(losses * valid) / max(np.sum(valid), 1.0)),
            "selected_batches": float(np.mean(
                [len(curr.selected_batch_ids(self.schedule, t, o)) for o in orders])),
            "comm_bytes": float(self.comm_bytes_per_round[-1]),
            "padded_steps": float(batch_idx.shape[1]),
        }

    # ------------------------------------------------------------------
    # async engine (event-driven, straggler-aware)
    # ------------------------------------------------------------------

    def _ensure_scheduler(self):
        if self._scheduler is None:
            from repro_torch.federated.async_agg import AsyncScheduler
            from repro_torch.federated.hetero import SCENARIO_SEED_OFFSET

            # scenario randomness rides its own stream, so heterogeneity
            # never perturbs cohort sampling (self.rng)
            bound = self.scenario.bind(len(self.clients), seed=self.seed + SCENARIO_SEED_OFFSET)
            self._scheduler = AsyncScheduler(
                num_clients=len(self.clients),
                cohort_size=min(self.fl.devices_per_round, len(self.clients)),
                scenario=bound,
                rng=self.rng,
                cfg=self.async_cfg,
                # wall-clock-aware sampling interpolates on the curriculum
                # ramp: fast clients early, uniform once data is full
                progress=self.schedule.progress,
                telemetry=self.tel,
            )
        return self._scheduler

    def _async_callbacks(self, lr, sched):
        """(plan, train) closures handed to the event scheduler.

        Both apply the same step-count adaptation (``adapt_steps``): a
        client ``r`` times slower than the fastest trains the easiest
        ``ceil(n/r)`` of its selected batches, so ``plan`` (which prices a
        dropped client, who never trains) and ``train`` (the real local
        round, run at dispatch against the pulled version) agree. In delta
        mode ``train`` takes the client's delta against the pulled version
        while that version is still alive.
        """
        from repro_torch.federated.async_agg import ClientUpdate, adapted_step_count

        fl, cfg = self.fl, self.async_cfg
        train_fn = eng.build_client_train_fn(self.loss_fn, self.opt_update)
        delta_mode = cfg.merge_mode == "delta"
        comp = self.compression

        def _cap(ci: int, n_sel: int) -> Optional[int]:
            if not cfg.adapt_steps:
                return None
            # the scenario's ground truth, or the scheduler's EMA of observed
            # completion times (scenario-free, as in a deployment)
            rel = sched.observed_rel_speed(ci) if cfg.pace_mode == "observed" else sched.scenario.rel_speed(ci)
            return adapted_step_count(n_sel, rel, cfg.min_steps)

        def plan(ci: int, t: int) -> int:
            sel = curr.selected_batch_ids(self.schedule, t, self.clients[ci].order)
            cap = _cap(ci, len(sel))
            n_sel = len(sel) if cap is None else min(cap, len(sel))
            return n_sel * fl.local_epochs

        def train(ci: int, t: int, version: int) -> ClientUpdate:
            # pinned while in flight or buffered: the aggregator may hold
            # this client's payload across several flushes (the round
            # re-syncs the pins after every merge)
            self.store.pin(ci)
            client = self.clients[ci]
            cap = _cap(ci, len(curr.selected_batch_ids(self.schedule, t, client.order)))
            batch_idx, step_valid = curr.step_plan(self.schedule, t, [client.order], fl.local_epochs,
                                                   max_selected=None if cap is None else [cap])
            pulled = self._global.front  # the version this client pulls
            new_lora, new_opt, losses = train_fn(
                self.params, pulled, client.lora, client.opt_state, client.neuron_mask, self._gal_mask_tree,
                lambda j: self._client_batch(client, client.batches[j]), batch_idx[0], step_valid[0], lr,
            )
            client.lora, client.opt_state = new_lora, new_opt
            self.store.put(ci, client)
            # the delta against the pulled version, taken now: by merge time
            # the double buffer may have retired that version
            if comp is None:
                delta = eng.lora_delta(new_lora, pulled) if delta_mode else None
                payload = new_lora
            else:
                # the channel carries the compressed GAL delta either way;
                # buffered mode reconstructs pulled + y on the server
                y = self._compress_client(ci, client, pulled)
                delta = y if delta_mode else None
                payload = new_lora if delta_mode else tree_map(lambda g, yy: (g + yy).to(g.dtype), pulled, y)
            down, up = self._client_comm_bytes(ci)
            n_steps = int(step_valid.sum())
            return ClientUpdate(
                client=ci, lora=payload, delta=delta, losses=losses, step_valid=step_valid[0],
                n_samples=client.n, n_steps=n_steps, n_selected=n_steps // fl.local_epochs,
                pulled_version=version, round_t=t, comm_bytes=down + up, upload_bytes=up,
            )

        return plan, train

    def _run_round_async(self, t: int, lr: Optional[float] = None) -> Dict[str, float]:
        """One buffer flush = one server round.

        The scheduler advances its virtual clock (dispatching replacements,
        absorbing drops) until any ``buffer_size`` clients have reported;
        their GAL layers merge into a fresh double-buffered global with
        staleness-discounted FedAvg weights. Comm bytes are charged per
        completion, stale-discarded ones included, so dropped clients cost
        nothing and the homogeneous full-cohort configuration reproduces the
        synchronous engines' accounting exactly. ``last_round_info`` names
        the merged clients and their real steps.
        """
        from repro_torch.federated.hierarchy import build_edge_summary_fn, edge_reduce

        lr = self.fl.learning_rate if lr is None else lr
        sched = self._ensure_scheduler()
        plan, train = self._async_callbacks(lr, sched)
        result = sched.run_until_merge(t, plan, train)

        if self.async_cfg.merge_mode == "delta":
            payloads, merge = [u.delta for u in result.updates], eng.gal_delta_merge
        else:
            payloads, merge = [u.lora for u in result.updates], eng.gal_weighted_merge
        if self._hierarchy is not None:
            # edges reduce their regions' payloads to partial weighted sums,
            # the server merges the summaries with unit weights: bit-exact to
            # the flat merge at one edge, equal up to reassociation otherwise
            stacked, wts = edge_reduce(
                build_edge_summary_fn(), payloads, np.asarray(result.weights),
                [u.client for u in result.updates], len(self.clients), self._hierarchy.num_edges,
                assignments=self._hierarchy.assignments,
            )
        else:
            stacked = _stack(payloads)
            wts = torch.as_tensor(np.asarray(result.weights), dtype=torch.float32, device=self.device)
        self._global.publish(merge(self._global.front, self._gal_mask_tree, stacked, wts))
        self.global_lora = self._global.front
        # merged and dropped clients may be evicted again; those still in
        # flight or in the next buffer stay pinned
        self.store.sync_pins(set(sched.in_flight) | {u.client for u in sched.buffer})

        num = den = 0.0
        for u in result.updates:
            losses = u.losses.cpu().numpy().astype(np.float64)
            valid = np.asarray(u.step_valid, np.float64)
            num += float(np.sum(losses * valid))
            den += float(np.sum(valid))
        self.last_round_info = {
            "chosen": np.asarray([u.client for u in result.updates]),
            "client_steps": np.asarray([u.n_steps for u in result.updates], np.int64),
        }
        # completions pay the round trip whether or not the staleness cutoff
        # later discards them: the bytes were already on the wire
        self.comm_bytes_per_round.append(
            sum(u.comm_bytes for u in result.updates) + result.stale_dropped_bytes)
        self.comm_upload_bytes_per_round.append(
            sum(u.upload_bytes for u in result.updates) + result.stale_dropped_upload_bytes)
        return {
            "loss": num / max(den, 1.0),
            "selected_batches": float(np.mean([u.n_selected for u in result.updates])),
            "comm_bytes": float(self.comm_bytes_per_round[-1]),
            "virtual_time": float(result.clock),
            "staleness_mean": float(result.staleness.mean()),
            "merged_clients": float(result.completed),
            "dropped_clients": float(result.dropped),
            "stale_dropped": float(result.stale_dropped),
            "buffer_size": float(sched.buffer_size),
            "padded_steps": float(max(len(np.asarray(u.step_valid)) for u in result.updates)),
        }

    # ------------------------------------------------------------------
    # run checkpointing (repro_torch.checkpoint.federation)
    # ------------------------------------------------------------------

    def checkpoint_state(self):
        """``(host, arrays, files)``: everything a fresh runner needs to
        continue this run exactly where it stands, in the JAX package's
        layout (the same keys, shapes and dtype names).

        ``host`` is JSON-able (the configuration basics for validation, the
        cohort RNG's ``bit_generator.state``, comm accounting, the async
        scheduler's bookkeeping); ``arrays`` is one nested dict of tensors
        and numpy arrays (global LoRA, GAL selection, client state: stacked
        trees, per-client trees, or the out-of-core store's resident
        metadata, by engine and store); ``files`` maps cold-file names to
        paths for the checkpoint writer to hardlink (out-of-core store
        only). Not captured: what the constructor arguments give again
        (params, data, batches, schedules) and, on the in-memory vectorized
        and sharded engines, the per-client momentum FIMs (read only by
        ``init_phase``). On the sharded engine a collective: every rank
        gathers the stacks into the vectorized layout, padding rows kept.
        """
        from repro_torch.federated.store import OutOfCoreStore

        host: Dict[str, Any] = {
            "engine": self.engine,
            "num_clients": len(self.clients),
            "seed": int(self.seed),
            "optimizer": self.optimizer_name,
            "initialized": self.gal_layers is not None,
            "rng_state": self.rng.bit_generator.state,
            "comm_bytes_per_round": [int(x) for x in self.comm_bytes_per_round],
            "comm_upload_bytes_per_round": [int(x) for x in self.comm_upload_bytes_per_round],
        }
        arrays: Dict[str, Any] = {"global_lora": self.global_lora}
        files: Dict[str, str] = {}
        if self.gal_layers is not None:
            arrays["gal_layers"] = np.asarray(self.gal_layers, bool)

        if self._oocore:
            s_host, s_arrays, files = self.store.checkpoint_state()
            host["store"] = s_host
            if s_arrays:
                arrays["store"] = s_arrays
        elif self._stacked:
            stacked = self.population_state()  # gathered from every rank on a mesh
            opt_empty = isinstance(self._stacked_opt, dict) and not self._stacked_opt
            if opt_empty:
                del stacked["opt"]
            arrays["stacked"] = stacked
            host["stacked"] = {
                "opt_empty": opt_empty,
                "has_mask": self._stacked_mask is not None,
                "has_residual": self._stacked_residual is not None,
                "has_comp_mask": self._stacked_comp_mask is not None,
            }
            host["clients"], carrs = self._checkpoint_client_meta()
            if carrs:
                arrays["clients"] = carrs
        else:  # loop and async on the in-memory store: each client's own trees
            clients_host, carrs = self._checkpoint_client_meta()
            for ci, client in enumerate(self.clients):
                fields, trees = OutOfCoreStore._split_state(client)
                clients_host[str(ci)]["fields"] = fields
                if trees:
                    carrs.setdefault(str(ci), {})["trees"] = trees
            host["clients"] = clients_host
            if carrs:
                arrays["clients"] = carrs

        if self.engine == "async":
            a_host: Dict[str, Any] = {
                "global_version": int(self._global.version),
                "has_back": self._global.back is not None,
                "scheduler": None,
            }
            a_arrays: Dict[str, Any] = {}
            if self._global.back is not None:
                a_arrays["back"] = self._global.back
            if self._scheduler is not None:
                s_host, s_arrays = self._scheduler.checkpoint_state()
                a_host["scheduler"] = s_host
                if s_arrays:
                    a_arrays["scheduler"] = s_arrays
            host["async"] = a_host
            if a_arrays:
                arrays["async"] = a_arrays
        return host, arrays, files

    def population_state(self) -> Dict[str, Any]:
        """The population-stacked client trees of the vectorized and sharded
        engines, ``{"lora", "opt"[, "mask", "residual", "comp_mask"]}``,
        each leaf ``(C_stack, ...)`` with the sharded engine's padding rows
        last. On a mesh a collective (every rank calls it) that returns the
        whole population on every rank; off one, the runner's own trees."""
        if not self._stacked:
            raise ValueError(f"engine={self.engine!r} on this store keeps no population stack")
        trees = {"lora": self._stacked_lora, "opt": self._stacked_opt}
        for name, tree in (("mask", self._stacked_mask), ("residual", self._stacked_residual),
                           ("comp_mask", self._stacked_comp_mask)):
            if tree is not None:
                trees[name] = tree
        if self.mesh is None:
            return trees
        return dict(zip(trees, eng.all_gather_rows(list(trees.values()), self.mesh)))

    @property
    def checkpoint_writer(self) -> bool:
        """Whether this process writes run checkpoints: rank 0 of a sharded
        run's mesh (every rank gathers the state), and any runner off one."""
        return self._rank == 0

    def checkpoint_barrier(self) -> None:
        """Wait until every rank of the mesh is here (after rank 0 wrote a
        snapshot); nothing off a mesh."""
        if self._group is not None:
            flag = torch.zeros(1, device=self.device)
            torch.distributed.all_reduce(flag, group=self._group)

    def _checkpoint_client_meta(self):
        """Every client's curriculum metadata (in-memory store):
        ``order``/``difficulty``/``layer_scores`` as arrays,
        ``lossless_fraction`` in host. ``n`` and ``batches`` come from the
        data shards at construction, so they are not captured."""
        clients_host: Dict[str, Any] = {}
        carrs: Dict[str, Any] = {}
        for ci, client in enumerate(self.clients):
            key = str(ci)
            clients_host[key] = {
                "lossless_fraction": float(client.lossless_fraction),
                "has_difficulty": client.difficulty is not None,
                "has_layer_scores": client.layer_scores is not None,
            }
            meta = {"order": np.asarray(client.order)}
            if client.difficulty is not None:
                meta["difficulty"] = np.asarray(client.difficulty)
            if client.layer_scores is not None:
                meta["layer_scores"] = np.asarray(client.layer_scores)
            carrs[key] = {"meta": meta}
        return clients_host, carrs

    def restore_state(self, host, arrays, *, store_files_dir: str = "") -> None:
        """Install a :meth:`checkpoint_state` snapshot (this port's or the
        JAX package's) on this runner; its tensors go to ``self.device``.

        The runner must be freshly constructed with the configuration the
        snapshot was taken under (engine, population and optimizer are
        validated; the rest is the caller's contract) and must not have run
        ``init_phase`` or any round: restore replaces state, it does not
        merge. ``store_files_dir`` is the checkpoint's cold-file directory
        (out-of-core store only). A sharded runner takes its rank's block of
        the stacks, which must hold as many rows as its own padded stack.
        """
        from repro_torch.federated.store import SPILL_FIELDS

        for field, mine in (("engine", self.engine), ("num_clients", len(self.clients)),
                            ("optimizer", self.optimizer_name)):
            if host[field] != mine:
                raise ValueError(f"checkpoint was taken with {field}={host[field]!r}; this runner has {mine!r}")
        self.rng.bit_generator.state = host["rng_state"]
        self.comm_bytes_per_round = [int(x) for x in host["comm_bytes_per_round"]]
        self.comm_upload_bytes_per_round = [int(x) for x in host["comm_upload_bytes_per_round"]]
        dev = self.device

        def _dev(tree):
            # copies: a restored leaf owns its storage (the vectorized round
            # writes the stacked trees in place)
            return tree_map(lambda x: torch.as_tensor(x).to(dev, copy=True), tree)

        self.global_lora = _dev(arrays["global_lora"])
        if host["initialized"]:
            self.gal_layers = host_array(arrays["gal_layers"]).astype(bool)
            self._gal_mask_tree = gal_mask_tree(self.cfg, self.global_lora, self.gal_layers)
        else:
            self.gal_layers = None
            self._gal_mask_tree = None
        # caches keyed on the GAL selection: rebuilt when read
        self._gal_leaf_cache = None
        self._comm_bytes_cache = {}
        self._comp_mask_cache = {}

        if self._oocore:
            self.store.restore_checkpoint_state(host["store"], arrays.get("store", {}), store_files_dir)
        elif self._stacked:
            st_host, st = host["stacked"], arrays["stacked"]
            n = tree_leaves(st["lora"])[0].shape[0]
            if n != self._C_stack:
                raise ValueError(f"checkpoint holds {n} stacked client rows; this runner's stack has {self._C_stack}")
            rows = self._local_rows()

            def _block(tree):  # this rank's rows of a stacked tree
                return _dev(tree_map(lambda x: x[rows], tree))

            self._stacked_lora = _block(st["lora"])
            self._stacked_opt = {} if st_host["opt_empty"] else _block(st["opt"])
            self._stacked_mask = _block(st["mask"]) if st_host["has_mask"] else None
            self._stacked_residual = _block(st["residual"]) if st_host["has_residual"] else None
            self._stacked_comp_mask = _block(st["comp_mask"]) if st_host["has_comp_mask"] else None
            self._restore_client_meta(host["clients"], arrays.get("clients", {}))
            for ci in self._owned_clients():
                # the LoRA stays a view into the restored stack; masks re-slice it
                self.clients[ci].neuron_mask = (None if self._stacked_mask is None else tree_map(
                    lambda x, i=ci - self._row0: x[i], self._stacked_mask))
        else:
            self._restore_client_meta(host["clients"], arrays.get("clients", {}))
            carrs = arrays.get("clients", {})
            for ci, client in enumerate(self.clients):
                key = str(ci)
                fields = host["clients"][key]["fields"]
                trees = carrs.get(key, {}).get("trees", {})
                for field in SPILL_FIELDS:
                    status = fields[field]
                    value = None if status == "none" else {} if status == "empty" else _dev(trees[field])
                    if field == "_lora":
                        client.lora = value  # the setter also clears any view
                    else:
                        setattr(client, field, value)
                self.store.put(ci, client)

        if self.engine == "async":
            from repro_torch.federated.async_agg import DoubleBufferedGlobal

            a_host, a_arrays = host["async"], arrays.get("async", {})
            self._global = DoubleBufferedGlobal(self.global_lora)
            self._global.version = int(a_host["global_version"])
            if a_host["has_back"]:
                self._global.back = _dev(a_arrays["back"])
            if a_host["scheduler"] is not None:
                sched = self._ensure_scheduler()
                sched.restore_checkpoint_state(a_host["scheduler"], _dev(a_arrays.get("scheduler", {})))
                self.store.sync_pins(set(sched.in_flight) | {u.client for u in sched.buffer})

    def _restore_client_meta(self, clients_host, carrs) -> None:
        for ci, client in enumerate(self.clients):
            key = str(ci)
            m = clients_host[key]
            meta = carrs.get(key, {}).get("meta", {})
            client.order = host_array(meta["order"])
            client.lossless_fraction = float(m["lossless_fraction"])
            client.difficulty = host_array(meta["difficulty"]) if m["has_difficulty"] else None
            client.layer_scores = host_array(meta["layer_scores"]) if m["has_layer_scores"] else None

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------

    def evaluate(self, data: Dict[str, np.ndarray], batch_size: int = 32) -> float:
        """Accuracy with the *server* model (GAL part global, the rest as
        initialized): the next token's argmax against ``label_token``, or
        for the encoder family the class argmax against ``labels``."""
        n = len(next(iter(data.values())))
        correct, total = 0, 0
        with torch.no_grad():
            for i in range(0, n, batch_size):
                ids = np.arange(i, min(i + batch_size, n))
                batch = to_device(gather_batch(data, ids), self.device, self._data_dtype)
                logits, _ = self.model.forward(self.params, self.global_lora, batch)
                if self.cfg.family == "encoder":  # class logits against the labels
                    pred, gold = torch.argmax(logits, dim=-1).cpu().numpy(), data["labels"][ids]
                else:
                    pred, gold = torch.argmax(logits[:, -1], dim=-1).cpu().numpy(), data["label_token"][ids]
                correct += int((pred == gold).sum())
                total += len(gold)
        return correct / max(total, 1)
