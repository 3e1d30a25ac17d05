"""The port's client stores against the JAX package's.

The tiny-lm world of ``tests/test_engine_equivalence.py`` (50 samples over 4
clients, seed 7, FibecFed/AdamW, 4 rounds), the port starting from the JAX
runner's params and initial LoRA:

- an explicit ``InMemoryStore`` is bit for bit the default, on each engine;
- ``OutOfCoreStore(hot_slots=2)`` (below the population, so clients spill
  and reload every round) against the port's in-memory run and against
  JAX's out-of-core run, on each engine: the twin of
  ``test_engine_equivalence.py::test_out_of_core_store_matches_in_memory``,
  at the slice tolerances (losses rel 1e-4 / abs 1e-5, LoRA atol 5e-5 /
  rtol 1e-4; decisions, comm bytes and the async accounting identical);
- the compressed loop run out of core at ``hot_slots=1``, error-feedback
  residuals included (the twin of ``test_ef_residual_survives_eviction``),
  against JAX with the AdamW top-k tie allowance of
  ``tests/test_torch_engine_compress.py``;
- a flush defers pinned clients (the twin of
  ``tests/test_service.py::test_flush_defers_pinned_clients``).

The JAX runs are cached for the module.
"""
import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores: no thread pool each

import jax
import numpy as np

from repro.config import FibecFedConfig, ModelConfig
from repro.data import dirichlet_partition, make_keyword_task
import repro.federated as jfed
from repro.models import build_model
from repro.train import make_loss_fn

import repro_torch.config as tconfig
import repro_torch.federated as tfed
from repro_torch.checkpoint import load_tree
from repro_torch.convert import to_numpy
from repro_torch.core.fibecfed import ClientState
from repro_torch.models import build_model as t_build_model
from repro_torch.train import make_loss_fn as t_make_loss_fn
from repro_torch.utils.tree import tree_leaves
from torch_jax_refs import release_jax_programs  # noqa: F401

CFG = ModelConfig(
    name="tiny-lm", family="dense", num_layers=2, d_model=32, num_heads=2,
    num_kv_heads=2, d_ff=64, vocab_size=256, head_dim=16, rope="full",
    norm="rmsnorm", mlp="swiglu", dtype="float32", lora_rank=2, max_seq_len=64,
)
FL = FibecFedConfig(
    num_devices=4, devices_per_round=2, rounds=4, batch_size=4,
    learning_rate=5e-3, fim_warmup_epochs=1, gal_fraction=0.5, sparse_ratio=0.5,
)
ROUNDS = 4
ASYNC_STATS = ("virtual_time", "staleness_mean", "merged_clients", "dropped_clients", "stale_dropped",
               "buffer_size")
COMP = dict(mode="topk", topk_ratio=0.25, topk_values="int8", error_feedback=True)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    model = build_model(CFG)
    task = make_keyword_task(n_samples=50, seq_len=12, vocab_size=256, seed=0)
    parts = dirichlet_partition(task.data["label"], FL.num_devices, 1.0, seed=0)
    client_data = [{k: v[idx] for k, v in task.data.items() if k != "label"} for idx in parts]
    t_cfg = tconfig.ModelConfig(**{f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)})
    t_model = t_build_model(t_cfg)
    return dict(model=model, loss_fn=make_loss_fn(model), t_model=t_model, t_loss_fn=t_make_loss_fn(t_model),
                client_data=client_data, jax_runs={}, tmp=tmp_path_factory.mktemp("jax-stores"))


def _jax_run(world, engine, hot_slots, comp=None):
    """JAX's out-of-core run (once per configuration in this module)."""
    key = (engine, hot_slots, comp is not None)
    if key not in world["jax_runs"]:
        store = jfed.OutOfCoreStore(str(world["tmp"] / f"{engine}-{hot_slots}-{key[2]}"), hot_slots=hot_slots)
        r = jfed.make_runner("fibecfed", world["model"], world["loss_fn"], FL, world["client_data"],
                             optimizer="adamw", engine=engine, seed=7, store=store,
                             compression=None if comp is None else jfed.CompressionConfig(**comp))
        r.init_phase()
        world["jax_runs"][key] = (r, [r.run_round(t) for t in range(ROUNDS)])
    return world["jax_runs"][key]


def _port_run(world, ref, engine, store=None, comp=None, rounds=ROUNDS):
    r = tfed.make_runner(
        "fibecfed", world["t_model"], world["t_loss_fn"], tconfig.FibecFedConfig(**dataclasses.asdict(FL)),
        world["client_data"], optimizer="adamw", engine=engine, seed=7, device="cpu", store=store,
        compression=None if comp is None else tfed.CompressionConfig(**comp),
        **({} if ref is None else dict(init_params=jax.tree.map(np.asarray, ref.params),
                                       init_lora=jax.tree.map(np.asarray, ref._init_lora))),
    )
    r.init_phase()
    return r, [r.run_round(t) for t in range(rounds)]


def _close(port_tree, ref_tree, allowance=None):
    """Slice tolerance, or (fraction of the tree's entries outside it, max diff)."""
    got = tree_leaves(to_numpy(port_tree))
    want = [np.asarray(w, np.float32) for w in jax.tree.leaves(ref_tree)]
    assert len(got) == len(want)
    if allowance is None:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=5e-5, rtol=1e-4)
        return
    frac, max_diff = allowance
    diffs = [np.abs(g - w) for g, w in zip(got, want)]
    bad = np.concatenate([(d > 5e-5 + 1e-4 * np.abs(w)).ravel() for d, w in zip(diffs, want)])
    assert bad.mean() <= frac, bad.mean()
    assert max(d.max() for d in diffs) < max_diff


def _torch_close(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        torch.testing.assert_close(x, y, atol=5e-5, rtol=1e-4)


def _same_run(ref, port, h_ref, h_port, engine):
    """Decisions, losses at the slice tolerance, comm and async accounting exact."""
    for cr, cp in zip(ref.clients, port.clients):
        np.testing.assert_array_equal(np.asarray(cr.order), np.asarray(cp.order))
    np.testing.assert_array_equal(np.asarray(ref.gal_layers), np.asarray(port.gal_layers))
    for hr, hp in zip(h_ref, h_port):
        assert hp["loss"] == pytest.approx(hr["loss"], rel=1e-4, abs=1e-5)
        assert hp["selected_batches"] == hr["selected_batches"]
        if engine == "async":
            assert {k: hp[k] for k in ASYNC_STATS} == {k: hr[k] for k in ASYNC_STATS}
    assert port.comm_bytes_per_round == ref.comm_bytes_per_round
    assert port.comm_upload_bytes_per_round == ref.comm_upload_bytes_per_round


@pytest.mark.parametrize("engine", ["loop", "vectorized", "async"])
def test_inmemory_store_default_bit_identical(world, engine):
    """An explicit InMemoryStore is byte for byte the default: the store
    changes who owns the client states, not any number."""
    runs = [_port_run(world, None, engine, store=store) for store in (None, tfed.InMemoryStore())]
    (r_def, h_def), (r_exp, h_exp) = runs
    assert isinstance(r_def.store, tfed.InMemoryStore) and r_exp.store is not r_def.store
    assert [h["loss"] for h in h_def] == [h["loss"] for h in h_exp]
    for a, b in zip(tree_leaves(r_def.global_lora), tree_leaves(r_exp.global_lora)):
        assert torch.equal(a, b)
    for ca, cb in zip(r_def.clients, r_exp.clients):
        for a, b in zip(tree_leaves(ca.lora), tree_leaves(cb.lora)):
            assert torch.equal(a, b)
    assert r_def.comm_bytes_per_round == r_exp.comm_bytes_per_round


@pytest.mark.parametrize("engine", ["loop", "vectorized", "async"])
def test_out_of_core_store_matches_in_memory_and_jax(world, engine, tmp_path):
    """Two hot slots for four clients force spills and reloads every round:
    the port's run stays within the slice tolerance of its in-memory run and
    of JAX's out-of-core run, with identical decisions and bytes; a cold file
    lands for every client, and every client's state reads back through the
    store as the runner left it."""
    ref, h_ref = _jax_run(world, engine, 2)
    store = tfed.OutOfCoreStore(str(tmp_path), hot_slots=2)
    port, h_port = _port_run(world, ref, engine, store=store)
    mem, h_mem = _port_run(world, ref, engine)
    _same_run(ref, port, h_ref, h_port, engine)
    _same_run(mem, port, h_mem, h_port, engine)
    _close(port.global_lora, ref.global_lora)
    _torch_close(port.global_lora, mem.global_lora)
    if engine == "async":
        assert [h["virtual_time"] for h in h_port] == [h["virtual_time"] for h in h_mem]
    store.flush()
    assert sorted(os.listdir(tmp_path)) == [f"client_{ci}.npz" for ci in range(FL.num_devices)]
    for ci in range(FL.num_devices):
        cold = load_tree(store._path(ci))
        for a, b in zip(tree_leaves(cold["_lora"]), tree_leaves(port.clients[ci].lora)):
            assert torch.equal(a, b)
        _close(port.clients[ci].lora, ref.clients[ci].lora)
        _torch_close(port.clients[ci].lora, mem.clients[ci].lora)
    assert len(store._hot) <= store.hot_slots


def test_compressed_out_of_core_loop_keeps_residuals(world, tmp_path):
    """Error-feedback residuals are client state: one hot slot evicts every
    client after its round, and the run (residuals included) equals the
    in-memory one and stays within JAX's out-of-core run by the AdamW top-k
    tie allowance."""
    ref, h_ref = _jax_run(world, "loop", 1, COMP)
    port, h_port = _port_run(world, ref, "loop", store=tfed.OutOfCoreStore(str(tmp_path), hot_slots=1), comp=COMP)
    mem, h_mem = _port_run(world, ref, "loop", comp=COMP)
    _same_run(ref, port, h_ref, h_port, "loop")
    assert [h["loss"] for h in h_port] == [h["loss"] for h in h_mem]
    allowance = (0.02, 2e-2)
    _close(port.global_lora, ref.global_lora, allowance)
    seen = 0
    for ci in range(FL.num_devices):
        cm, co, cr = mem.clients[ci], port.clients[ci], ref.clients[ci]
        if cm.ef_residual is None:
            assert co.ef_residual is None and cr.ef_residual is None
            continue
        seen += 1
        for a, b in zip(tree_leaves(cm.ef_residual), tree_leaves(co.ef_residual)):
            assert torch.equal(a, b)
        _close(co.ef_residual, cr.ef_residual, allowance)
    assert seen > 0


def test_flush_defers_pinned_clients(tmp_path):
    """A flush during an open async transaction must not race the pinned
    buffer: the pinned client's cold file keeps its pre-transaction content
    (or stays absent) until unpin — never the mid-transaction state."""

    def make_state(ci):
        return ClientState(data={"x": np.zeros((2, 2), np.float32)}, n=2, batches=[np.array([0])],
                           order=np.array([0]), opt_state={}, _lora={"a": torch.full((3,), float(ci))})

    store = tfed.OutOfCoreStore(str(tmp_path / "s"), hot_slots=4)
    store.bind(client_data=[{"x": np.zeros((2, 2), np.float32)}] * 3, make_state=make_state,
               make_shell=make_state)
    s0, s1 = store.get(0), store.get(1)
    store.pin(0)
    s0._lora["a"] = torch.full((3,), 99.0)  # mid-transaction write
    assert store.flush() == 1  # client 1 spilled; pinned client 0 deferred
    assert not os.path.exists(store._path(0))  # no racing cold copy
    assert os.path.exists(store._path(1))
    # after the transaction closes, the next flush persists the final state
    store.unpin(0)
    assert store.flush() == 2
    assert torch.equal(load_tree(store._path(0))["_lora"]["a"], s0._lora["a"])
    del s1
