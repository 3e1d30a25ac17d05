"""Compressed uploads and per-client ranks: each port engine against its own
JAX engine.

The tiny-lm world of ``tests/test_engine_equivalence.py`` (fibecfed, seed
7, 2 rounds) with the compression configurations of its
``test_compressed_engines_equivalent``, per-client ranks ``[R, 1, 1, R]``,
both together, and ``mode="none"``. The two engines merge differently, as
in the JAX package (loop: value form ``g0 + y`` with f64-normalized
weights; vectorized: delta form with f32-normalized weights), so each is
held against its own JAX engine. Comm-byte integers, orders and GAL layers
must be identical; the global LoRA and the error-feedback residuals agree
within atol 5e-5 / rtol 1e-4, except where top-k flips an entry at its
threshold (``|x| >= thresh`` keeps more than k on ties, and one ulp of
drift moves an entry across it):

- with SGD the deltas are gradient-shaped and ties are rare: the JAX
  package's own allowance, at most 2% of each leaf's entries outside, none
  by more than 1e-2;
- with AdamW the first steps move every entry by nearly the same amount
  (``lr`` per step), so the threshold sits amid exact ties and which of
  them pass depends on the last ulp: at most 2% of the tree's entries
  outside (one flip is already 0.8% of a 128-entry leaf), none by more
  than 2e-2, the few Adam steps of 5e-3 that a flipped entry carries.
"""
import dataclasses

import pytest

pytest.importorskip("torch").set_num_threads(1)  # xdist workers share the cores: no thread pool each

import jax
import numpy as np
import torch

from repro.config import FibecFedConfig, ModelConfig
from repro.data import dirichlet_partition, make_keyword_task
from repro.federated import CompressionConfig, make_runner
from repro.models import build_model
from repro.train import make_loss_fn

import repro_torch.config as tconfig
from repro_torch.convert import to_numpy
from repro_torch.federated import CompressionConfig as TCompressionConfig
from repro_torch.federated import make_runner as t_make_runner
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
ROUNDS = 2
R = CFG.lora_rank
COMP_KW = [
    dict(mode="int8"),
    dict(mode="topk", topk_ratio=0.25, topk_values="int8"),
    dict(mode="topk", topk_ratio=0.25, topk_values="float", error_feedback=False),
]


@pytest.fixture(scope="module")
def world():
    model = build_model(CFG)
    task = make_keyword_task(n_samples=50, seq_len=12, vocab_size=256, seed=0)
    parts = dirichlet_partition(task.data["label"], FL.num_devices, 1.0, seed=0)
    client_data = [{k: v[idx] for k, v in task.data.items() if k != "label"} for idx in parts]
    t_cfg = tconfig.ModelConfig(**{f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)})
    t_model = t_build_model(t_cfg)
    return model, make_loss_fn(model), t_model, t_make_loss_fn(t_model), client_data


def _run_pair(world, engine, optimizer, comp_kw=None, ranks=None):
    model, loss_fn, t_model, t_loss_fn, client_data = world
    ref = make_runner("fibecfed", model, loss_fn, FL, client_data, optimizer=optimizer, engine=engine,
                      seed=7, compression=None if comp_kw is None else CompressionConfig(**comp_kw),
                      client_ranks=ranks)
    port = t_make_runner(
        "fibecfed", t_model, t_loss_fn, tconfig.FibecFedConfig(**dataclasses.asdict(FL)), client_data,
        optimizer=optimizer, engine=engine, seed=7, device="cpu",
        compression=None if comp_kw is None else TCompressionConfig(**comp_kw), client_ranks=ranks,
        init_params=jax.tree.map(np.asarray, ref.params),
        init_lora=jax.tree.map(np.asarray, ref._init_lora),
    )
    hists = []
    for r in (ref, port):
        r.init_phase()
        hists.append([r.run_round(t) for t in range(ROUNDS)])
    for cr, cp in zip(ref.clients, port.clients):
        np.testing.assert_array_equal(cr.order, cp.order)
    np.testing.assert_array_equal(ref.gal_layers, port.gal_layers)
    for hr, hp in zip(*hists):
        assert hp["loss"] == pytest.approx(hr["loss"], rel=1e-4, abs=1e-5)
    assert port.comm_bytes_per_round == ref.comm_bytes_per_round
    assert port.comm_upload_bytes_per_round == ref.comm_upload_bytes_per_round
    assert all(isinstance(b, int) for b in port.comm_upload_bytes_per_round)
    return ref, port


def _allowance(optimizer, comp_kw):
    """None (tight), or (fraction outside, max diff, counted per leaf)."""
    if comp_kw is None or comp_kw["mode"] != "topk":
        return None
    return (0.02, 1e-2, True) if optimizer == "sgd" else (0.02, 2e-2, False)


def _assert_close(port_tree, ref_leaves, allowance):
    got = tree_leaves(to_numpy(port_tree))
    assert len(got) == len(ref_leaves)
    want = [np.asarray(w, np.float32) for w in ref_leaves]
    if allowance is None:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=5e-5, rtol=1e-4)
        return
    frac, max_diff, per_leaf = allowance
    diffs = [np.abs(g - w) for g, w in zip(got, want)]
    bads = [d > (5e-5 + 1e-4 * np.abs(w)) for d, w in zip(diffs, want)]
    fracs = [b.mean() for b in bads] if per_leaf else [np.concatenate([b.ravel() for b in bads]).mean()]
    assert max(fracs) <= frac, fracs
    assert max(d.max() for d in diffs) < max_diff


@pytest.mark.parametrize("comp_kw", COMP_KW, ids=["int8", "topk_int8", "topk_float_noef"])
@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
@pytest.mark.parametrize("engine", ["loop", "vectorized"])
def test_compressed_matches_jax(world, engine, optimizer, comp_kw):
    ref, port = _run_pair(world, engine, optimizer, comp_kw)
    allowance = _allowance(optimizer, comp_kw)
    _assert_close(port.global_lora, jax.tree.leaves(ref.global_lora), allowance)
    # the compressed push is cheaper than the raw pull
    for total, up in zip(port.comm_bytes_per_round, port.comm_upload_bytes_per_round):
        assert up < total - up
    if not comp_kw.get("error_feedback", True):
        return
    if engine == "vectorized":
        _assert_close(port._stacked_residual, jax.tree.leaves(ref._stacked_residual), allowance)
    else:
        for cr, cp in zip(ref.clients, port.clients):
            _assert_close(cp.ef_residual, jax.tree.leaves(cr.ef_residual), allowance)


@pytest.mark.parametrize("comp_kw", [None, dict(mode="topk", topk_ratio=0.25, topk_values="int8")],
                         ids=["uncompressed", "topk_int8"])
@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
@pytest.mark.parametrize("engine", ["loop", "vectorized"])
def test_rank_heterogeneous_matches_jax(world, engine, optimizer, comp_kw):
    """Ranks fold into the update masks (and, under top-k, into each
    client's count mask): the rank-1 clients' beyond-rank components never
    move, and their bytes are rank-projected, as in the JAX package."""
    ranks = [R, 1, 1, R]
    ref, port = _run_pair(world, engine, optimizer, comp_kw, ranks)
    _assert_close(port.global_lora, jax.tree.leaves(ref.global_lora), _allowance(optimizer, comp_kw))
    # on the client-local (non-GAL) layers nothing overwrites a rank-1
    # client's LoRA, so beyond rank 1 it still holds its initial values
    local = np.flatnonzero(~port.gal_layers)
    assert local.size
    init = port._init_lora["layers"]
    for ci in (1, 2):
        for name, ab in port.clients[ci].lora["layers"].items():
            assert torch.equal(ab["a"][local][..., 1:], init[name]["a"][local][..., 1:])
            assert torch.equal(ab["b"][local][:, 1:], init[name]["b"][local][:, 1:])
    full, low = port._client_comm_bytes(0), port._client_comm_bytes(1)
    assert low[0] * R == full[0] * 1
    assert full == ref._client_comm_bytes(0) and low == ref._client_comm_bytes(1)


@pytest.mark.parametrize("engine", ["loop", "vectorized"])
def test_compression_none_is_exact_noop(world, engine):
    """mode="none" and full ranks everywhere take the uncompressed paths:
    bit-identical global LoRA and identical comm integers."""
    _, _, t_model, t_loss_fn, client_data = world
    runs = []
    for kw in ({}, dict(compression=TCompressionConfig(mode="none"), client_ranks=[R] * FL.num_devices)):
        r = t_make_runner("fibecfed", t_model, t_loss_fn, tconfig.FibecFedConfig(**dataclasses.asdict(FL)),
                          client_data, optimizer="adamw", engine=engine, seed=7, device="cpu", **kw)
        r.init_phase()
        for t in range(ROUNDS):
            r.run_round(t)
        runs.append(r)
    base, none = runs
    assert none.compression is None and none.client_ranks is None
    for a, b in zip(tree_leaves(base.global_lora), tree_leaves(none.global_lora)):
        assert torch.equal(a, b)
    assert base.comm_bytes_per_round == none.comm_bytes_per_round
    assert base.comm_upload_bytes_per_round == none.comm_upload_bytes_per_round
