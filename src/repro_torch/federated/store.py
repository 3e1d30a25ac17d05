"""Pluggable client-state ownership: the population lives behind a store
(port of ``repro.federated.store``).

The paper's cross-device regime assumes 10^4-10^6 clients of which only a
small cohort is active per round, while a runner that builds one
``ClientState`` per client, and stacks the population on the vectorized
engine, caps the simulation at what fits in memory. This module puts
client-state ownership behind a :class:`ClientStore` protocol:

* :class:`InMemoryStore` (default): the whole population resident, built
  eagerly at bind time, every lookup a list index; it changes who owns the
  states, not any number (``tests/test_torch_store.py`` holds it bit for
  bit to the default). The vectorized engine's population-stacked trees
  stay on the runner.
* :class:`OutOfCoreStore` — an LRU-resident *hot set* of at most
  ``hot_slots`` client states; cold clients spill to one flat-npz file each
  (``repro_torch.checkpoint.save_tree``, the same atomic tmp+rename writer
  as run checkpoints) and small host metadata (sample counts, curriculum
  order, difficulty, layer scores) stays resident. Only the round's cohort
  is ever materialized, so peak memory is bounded by the hot-set size, not
  the population. Clients in flight or buffered by the async aggregator can
  be *pinned* to exempt them from eviction.

The store is deliberately decoupled from ``FibecFed``: it never imports the
runner. The runner hands :meth:`ClientStore.bind` two factories — one for a
fresh fully-initialized state, one for a "shell" with the spillable device
fields unset — plus the raw ``client_data`` sequence and the device its
trees live on (a fetched client's trees are loaded back there), and the
store treats states as opaque objects with a known set of spillable
attribute names (:data:`SPILL_FIELDS`).

Spill format: one ``client_<ci>.npz`` per cold client holding the non-empty
device trees; a per-client resident ``meta`` dict records which fields were
``None`` / empty / spilled (an empty dict — e.g. momentum-free SGD optimizer
state — flattens to nothing, so presence must be recorded out of band) plus
the host metadata. Telemetry (when enabled) traces ``store_fetch`` /
``store_evict`` / ``store_flush`` spans and keeps hit/miss/eviction
counters, so cache behavior at population scale is visible in traces.
"""
from __future__ import annotations

import collections
import os
import shutil
from typing import Any, Callable, Dict, List, Optional, Protocol, Sequence, Set

import numpy as np

from repro_torch.checkpoint import clean_stale_tmp, load_tree, save_tree
from repro_torch.obs import ensure as ensure_telemetry
from repro_torch.utils.tree import host_array, tree_map

# ClientState attributes holding (potentially device-resident) pytrees that
# spill to the per-client npz on eviction. ``_lora`` is the concrete LoRA
# slot behind the ``lora`` property — out-of-core states are always concrete
# (never lazy views into a population stack, which cannot exist out of core).
SPILL_FIELDS = ("_lora", "opt_state", "fim", "neuron_mask", "ef_residual")

# Small host-side attributes kept resident for every client (hot or cold):
# sizes, curriculum order/difficulty, and the init-phase scalars (the port
# also keeps what the lossless criterion read). Cheap at population scale and
# needed without materializing the device state. A run checkpoint carries
# the JAX package's six, not ``lossless``.
META_FIELDS = (
    "n",
    "batches",
    "order",
    "difficulty",
    "layer_scores",
    "lossless_fraction",
    "lossless",
)


class ClientStore(Protocol):
    """What the engines need from client-state storage.

    ``get`` returns the authoritative, mutable state object for a client —
    callers mutate it in place (and may call ``put`` to make the write-back
    explicit). ``pin``/``sync_pins`` exempt clients from eviction while the
    async aggregator has them in flight or buffered. ``out_of_core`` tells
    the runner which code paths apply (population-stacked programs need an
    in-memory store).
    """

    out_of_core: bool
    num_clients: int

    def bind(
        self,
        *,
        client_data: Sequence[Dict[str, np.ndarray]],
        make_state: Callable[[int], Any],
        make_shell: Callable[[int], Any],
        telemetry: Any = None,
        device: Any = None,
    ) -> None: ...

    def get(self, ci: int) -> Any: ...

    def put(self, ci: int, state: Any) -> None: ...

    def client_data(self, ci: int) -> Dict[str, np.ndarray]: ...

    def sample_count(self, ci: int) -> int: ...

    def pin(self, ci: int) -> None: ...

    def unpin(self, ci: int) -> None: ...

    def sync_pins(self, pinned: Set[int]) -> None: ...

    def flush(self) -> int: ...


class ClientsView(Sequence):
    """Sequence facade over a store: ``runner.clients[ci]`` / iteration keep
    working for every engine, with lookups routed through the store (so an
    out-of-core store can fault states in lazily)."""

    def __init__(self, store: "ClientStore"):
        self._store = store

    def __len__(self) -> int:
        return self._store.num_clients

    def __getitem__(self, ci):
        if isinstance(ci, slice):
            return [self._store.get(i) for i in range(*ci.indices(len(self)))]
        return self._store.get(int(ci))

    def __iter__(self):
        for ci in range(len(self)):
            yield self._store.get(ci)


def _population_sample_counts(client_data: Sequence) -> np.ndarray:
    """Per-client sample counts without holding shards: honor an optional
    ``sample_counts`` attribute on lazy sequences (one materialization per
    shard would defeat the point at 10^5 clients); otherwise measure each
    shard once."""
    counts = getattr(client_data, "sample_counts", None)
    if counts is not None:
        counts = np.asarray(counts, np.int64)
        if counts.shape != (len(client_data),):
            raise ValueError(
                "client_data.sample_counts must have one entry per client"
            )
        return counts
    return np.asarray(
        [len(next(iter(cd.values()))) for cd in client_data], np.int64
    )


class InMemoryStore:
    """Default store: the whole population resident.

    ``bind`` builds every state eagerly in client order (the runner's
    construction order and RNG consumption, so an explicit store is bit for
    bit the default). The vectorized engine's population-stacked trees stay
    on the runner.
    """

    out_of_core = False

    def __init__(self):
        self._states: List[Any] = []
        self._client_data: Optional[Sequence] = None
        self.num_clients = 0

    def bind(self, *, client_data, make_state, make_shell, telemetry=None, device=None):
        del make_shell, telemetry, device  # nothing spills, nothing to trace
        self._client_data = client_data
        self.num_clients = len(client_data)
        self._states = [make_state(ci) for ci in range(self.num_clients)]

    def get(self, ci: int) -> Any:
        return self._states[ci]

    def put(self, ci: int, state: Any) -> None:
        self._states[ci] = state

    def client_data(self, ci: int) -> Dict[str, np.ndarray]:
        return self._client_data[ci]

    def sample_count(self, ci: int) -> int:
        return self._states[ci].n

    def pin(self, ci: int) -> None:
        pass

    def unpin(self, ci: int) -> None:
        pass

    def sync_pins(self, pinned: Set[int]) -> None:
        pass

    def flush(self) -> int:
        return 0


class OutOfCoreStore:
    """LRU hot set over flat-npz cold storage; peak memory ~ ``hot_slots``.

    States are created lazily on first access and spilled (device trees ->
    one npz per client, host metadata resident) when the hot set overflows.
    Every resident state is treated as dirty at eviction — callers mutate
    states in place, so the store conservatively re-spills rather than
    tracking writes. Pinned clients (async in-flight/buffered) are skipped
    by eviction; if every resident state is pinned the hot set temporarily
    overflows rather than failing.

    Args:
      directory: cold-storage directory (created on bind; stale ``*.tmp``
        from a crashed writer are swept on open).
      hot_slots: resident-state capacity (>= 1). Size it to the round
        cohort plus headroom — the population bench holds 10k+ clients with
        a few dozen slots.
    """

    out_of_core = True

    def __init__(self, directory: str, *, hot_slots: int = 64):
        if hot_slots < 1:
            raise ValueError("hot_slots must be >= 1")
        self.directory = directory
        self.hot_slots = hot_slots
        self.num_clients = 0
        self._client_data: Optional[Sequence] = None
        self._make_state: Optional[Callable[[int], Any]] = None
        self._make_shell: Optional[Callable[[int], Any]] = None
        self._hot: "collections.OrderedDict[int, Any]" = collections.OrderedDict()
        self._meta: Dict[int, Dict[str, Any]] = {}  # ci -> resident metadata
        self._pinned: Set[int] = set()
        self._counts: Optional[np.ndarray] = None
        self.tel = ensure_telemetry(None)
        self.device: Any = None

    # -- lifecycle ---------------------------------------------------------

    def bind(self, *, client_data, make_state, make_shell, telemetry=None, device=None):
        self._client_data = client_data
        self._make_state = make_state
        self._make_shell = make_shell
        self.num_clients = len(client_data)
        self.tel = ensure_telemetry(telemetry)
        self.device = device
        os.makedirs(self.directory, exist_ok=True)
        clean_stale_tmp(self.directory)

    def _path(self, ci: int) -> str:
        return os.path.join(self.directory, f"client_{ci}.npz")

    # -- core protocol -----------------------------------------------------

    def get(self, ci: int) -> Any:
        state = self._hot.get(ci)
        if state is not None:
            self._hot.move_to_end(ci)
            if self.tel.enabled:
                self.tel.metrics.counter("store.hits").inc()
            return state
        state = self._fetch(ci)
        self._hot[ci] = state
        self._evict_overflow()
        return state

    def put(self, ci: int, state: Any) -> None:
        self._hot[ci] = state
        self._hot.move_to_end(ci)
        self._evict_overflow()

    def client_data(self, ci: int) -> Dict[str, np.ndarray]:
        return self._client_data[ci]

    def sample_count(self, ci: int) -> int:
        meta = self._meta.get(ci)
        if meta is not None:
            return int(meta["n"])
        state = self._hot.get(ci)
        if state is not None:
            return int(state.n)
        return int(self.sample_counts()[ci])

    def sample_counts(self) -> np.ndarray:
        """(num_clients,) per-client sample counts, computed once."""
        if self._counts is None:
            self._counts = _population_sample_counts(self._client_data)
        return self._counts

    def pin(self, ci: int) -> None:
        self._pinned.add(ci)

    def unpin(self, ci: int) -> None:
        self._pinned.discard(ci)
        self._evict_overflow()

    def sync_pins(self, pinned: Set[int]) -> None:
        self._pinned = set(pinned)
        self._evict_overflow()

    def flush(self) -> int:
        """Spill every *unpinned* resident state to cold storage (states stay
        hot). Returns the number of states spilled.

        Pinned clients are deferred, not flushed: a pin marks an open async
        transaction (the client's update is in flight or buffered, awaiting
        merge), so writing its mid-transaction state to the cold file would
        let the on-disk copy race the pinned buffer — a checkpoint or crash
        recovery reading that file would see a post-train state whose
        pending update is not accounted for. Deferred clients spill through
        the normal eviction path once unpinned (or via the next flush); a
        consistent snapshot of pinned state goes through
        :meth:`checkpoint_state`, which captures it together with the
        scheduler's transaction bookkeeping.
        """
        spilled = deferred = 0
        with self.tel.span("store_flush", cat="store", track="server"):
            for ci, state in self._hot.items():
                if ci in self._pinned:
                    deferred += 1
                    continue
                self._spill(ci, state)
                spilled += 1
        if self.tel.enabled and deferred:
            self.tel.metrics.counter("store.flush_deferred").inc(deferred)
        return spilled

    # -- run-checkpoint integration ----------------------------------------

    def checkpoint_state(self):
        """``(host, arrays, cold_files)`` snapshot of every touched client.

        Unpinned residents are flushed first, so their cold file + resident
        meta are the authoritative copy; ``cold_files`` maps each spilled
        client's file name to its current path for the checkpoint writer to
        hardlink (``save_tree``'s rename protocol never mutates an existing
        inode, so the link stays frozen while the live file moves on).
        Pinned residents are mid-async-transaction — their cold file (if
        any) is stale by design (see :meth:`flush`) — so their live state
        serializes inline into ``arrays`` instead. Clients never touched
        (no meta, not resident) are omitted: a restore recreates them
        deterministically on first access via ``make_state``.
        """
        self.flush()
        clients_host: Dict[str, Any] = {}
        meta_arrays: Dict[str, Any] = {}
        inline_arrays: Dict[str, Any] = {}
        cold_files: Dict[str, str] = {}

        def _meta_entry(n, lossless, fields, order, difficulty, layer_scores):
            entry = {
                "fields": dict(fields),
                "n": int(n),
                "lossless_fraction": float(lossless),
                "has_difficulty": difficulty is not None,
                "has_layer_scores": layer_scores is not None,
            }
            ma = {"order": host_array(order)}
            if difficulty is not None:
                ma["difficulty"] = host_array(difficulty)
            if layer_scores is not None:
                ma["layer_scores"] = host_array(layer_scores)
            return entry, ma

        for ci, state in self._hot.items():
            if ci not in self._pinned:
                continue  # the flush above made this client's cold copy fresh
            fields, trees = self._split_state(state)
            key = str(ci)
            entry, ma = _meta_entry(
                state.n, state.lossless_fraction, fields,
                state.order, state.difficulty, state.layer_scores,
            )
            entry["inline"] = True
            clients_host[key] = entry
            meta_arrays[key] = ma
            if trees:
                inline_arrays[key] = trees
        for ci, meta in self._meta.items():
            key = str(ci)
            if key in clients_host:
                continue  # pinned inline snapshot wins over the stale file
            entry, ma = _meta_entry(
                meta["n"], meta["lossless_fraction"], meta["fields"],
                meta["order"], meta["difficulty"], meta["layer_scores"],
            )
            entry["inline"] = False
            entry["spilled"] = bool(meta["spilled"])
            clients_host[key] = entry
            meta_arrays[key] = ma
            if meta["spilled"]:
                cold_files[f"client_{ci}.npz"] = self._path(ci)
        host = {"clients": clients_host}
        arrays: Dict[str, Any] = {}
        if meta_arrays:
            arrays["meta"] = meta_arrays
        if inline_arrays:
            arrays["inline"] = inline_arrays
        return host, arrays, cold_files

    def restore_checkpoint_state(self, host, arrays, cold_dir: str) -> None:
        """Rebuild the population's cold state from a run checkpoint.

        Everything restores *cold*: the hot set and pin set empty out (the
        runner re-pins from its restored scheduler state), resident metas
        rebuild from the manifest, inline (pinned-at-save) states and
        hardlinked cold files re-materialize as per-client npz files, and
        any cold file the checkpoint does not know about — state the
        crashed run wrote after the snapshot — is deleted, so a fetch can
        never resurrect post-checkpoint state. Metas omit ``batches`` (and
        the port's ``lossless`` readings): ``make_shell`` rebuilds those
        and ``_fetch`` keeps the shell's value for fields absent from the
        meta.
        """
        self._hot.clear()
        self._pinned.clear()
        self._meta.clear()
        for name in os.listdir(self.directory):
            is_cold = name.startswith("client_") and name.endswith(".npz")
            if is_cold or name.endswith(".tmp"):
                try:
                    os.unlink(os.path.join(self.directory, name))
                except OSError:  # pragma: no cover - racing unlink
                    pass
        meta_arrays = arrays.get("meta", {})
        inline_arrays = arrays.get("inline", {})
        for key, m in host["clients"].items():
            ci = int(key)
            ma = meta_arrays.get(key, {})
            meta = {
                "fields": dict(m["fields"]),
                "n": int(m["n"]),
                "lossless_fraction": float(m["lossless_fraction"]),
                "order": host_array(ma["order"]),
                "difficulty": (
                    host_array(ma["difficulty"]) if m["has_difficulty"] else None
                ),
                "layer_scores": (
                    host_array(ma["layer_scores"])
                    if m["has_layer_scores"]
                    else None
                ),
            }
            if m.get("inline"):
                trees = inline_arrays.get(key)
                meta["spilled"] = trees is not None
                if trees is not None:
                    save_tree(self._path(ci), trees)
            else:
                meta["spilled"] = bool(m["spilled"])
                if meta["spilled"]:
                    shutil.copyfile(
                        os.path.join(cold_dir, f"client_{ci}.npz"),
                        self._path(ci),
                    )
            self._meta[ci] = meta

    # -- hot/cold mechanics ------------------------------------------------

    def _fetch(self, ci: int) -> Any:
        with self.tel.span("store_fetch", cat="store", track="server",
                           args={"client": ci}):
            meta = self._meta.get(ci)
            if meta is None:
                # first touch: a fresh fully-initialized state
                state = self._make_state(ci)
                if self.tel.enabled:
                    self.tel.metrics.counter("store.creates").inc()
                return state
            state = self._make_shell(ci)
            trees = {}
            if meta["spilled"]:
                trees = load_tree(self._path(ci))
                if self.device is not None:
                    trees = tree_map(lambda t: t.to(self.device), trees)
            for field in SPILL_FIELDS:
                status = meta["fields"][field]
                if status == "none":
                    value = None
                elif status == "empty":
                    value = {}
                else:
                    value = trees[field]
                setattr(state, field, value)
            state._lora_view = None
            # restored-from-checkpoint metas omit the fields make_shell
            # rebuilds deterministically (batches); keep the shell's value
            for field in META_FIELDS:
                if field in meta:
                    setattr(state, field, meta[field])
            if self.tel.enabled:
                self.tel.metrics.counter("store.misses").inc()
            return state

    @staticmethod
    def _split_state(state: Any):
        """(field-status map, spillable trees) of one state — the spill
        wire format: statuses record ``None`` vs empty-dict vs tree out of
        band (flatten_dict drops empty dicts, e.g. momentum-free SGD
        optimizer state, so presence must ride separately)."""
        fields: Dict[str, str] = {}
        trees: Dict[str, Any] = {}
        for field in SPILL_FIELDS:
            value = getattr(state, field)
            if value is None:
                fields[field] = "none"
            elif isinstance(value, dict) and not value:
                fields[field] = "empty"
            else:
                fields[field] = "tree"
                trees[field] = value
        return fields, trees

    def _spill(self, ci: int, state: Any) -> None:
        fields, trees = self._split_state(state)
        meta = {
            "fields": fields,
            "spilled": bool(trees),
        }
        for field in META_FIELDS:
            meta[field] = getattr(state, field)
        if trees:
            save_tree(self._path(ci), trees)
        self._meta[ci] = meta

    def _evict_overflow(self) -> None:
        while len(self._hot) > self.hot_slots:
            victim = None
            for ci in self._hot:  # oldest-first (LRU order)
                if ci not in self._pinned:
                    victim = ci
                    break
            if victim is None:
                return  # everything pinned: overflow rather than fail
            state = self._hot.pop(victim)
            with self.tel.span("store_evict", cat="store", track="server",
                               args={"client": victim}):
                self._spill(victim, state)
            if self.tel.enabled:
                self.tel.metrics.counter("store.evictions").inc()
                self.tel.metrics.gauge("store.hot").set(len(self._hot))
