"""The vectorized engine's building blocks agree with the JAX package's.

The padded client stack and the padded step plan (numpy copies: equal), the
mask-aware loss, per-batch Fisher scores over padded batches and the
sample-masked diagonal FIM (per-sample gradients: atol 1e-5 / rtol 1e-4 in
f32, as ``tests/test_torch_core.py`` holds them), and the server merges
(equal up to f32 summation order). Inputs are seeded numpy, fed to both.
"""
import dataclasses

import pytest

pytest.importorskip("torch").set_num_threads(1)  # xdist workers share the cores: no thread pool each

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.config import ModelConfig
from repro.core import curriculum as jcurr
from repro.core import engine as jeng
from repro.core import fisher as jfish
from repro.data.pipeline import bucket_size as j_bucket_size
from repro.data.pipeline import stack_clients as j_stack_clients
from repro.models import build_model
from repro.train import make_loss_fn

import repro_torch.config as tconfig
from repro_torch.convert import lora_from_numpy, params_from_numpy
from repro_torch.core import curriculum as tcurr
from repro_torch.core import engine as teng
from repro_torch.core import fisher as tfish
from repro_torch.data import bucket_size, stack_clients
from repro_torch.models import build_model as t_build_model
from repro_torch.train import make_loss_fn as t_make_loss_fn
from repro_torch.utils.tree import tree_leaves
from torch_jax_refs import release_jax_programs  # noqa: F401

CFG = ModelConfig(
    name="tiny-lm", family="dense", num_layers=2, d_model=32, num_heads=2,
    num_kv_heads=2, d_ff=64, vocab_size=256, head_dim=16, rope="full",
    norm="rmsnorm", mlp="swiglu", dtype="float32", lora_rank=2, max_seq_len=64,
)


def _clients(rng, sizes, seq=6):
    return [{"tokens": rng.integers(0, 256, (n, seq)).astype(np.int32),
             "label_token": rng.integers(0, 256, (n,)).astype(np.int32)} for n in sizes]


@pytest.fixture(scope="module")
def world():
    model = build_model(CFG)
    params = jax.tree.map(np.asarray, model.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    lora = jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape)).astype(np.float32),
        model.init_lora(jax.random.PRNGKey(1)),
    )
    t_cfg = tconfig.ModelConfig(**{f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)})
    t_model = t_build_model(t_cfg)
    t = dict(loss=t_make_loss_fn(t_model), params=params_from_numpy(params, t_cfg, "cpu"),
             lora=lora_from_numpy(lora, "cpu"))
    return make_loss_fn(model), params, lora, t


def _torch_batch(batch):
    return {k: torch.as_tensor(np.asarray(v)).to(torch.int64) for k, v in batch.items()}


def test_bucket_size_and_stack_clients_match():
    for n in range(0, 70):
        assert bucket_size(n) == j_bucket_size(n)
    clients = _clients(np.random.default_rng(1), [9, 4, 13, 1])
    got, want = stack_clients(clients, 4), j_stack_clients(clients, 4)
    assert got.data.keys() == want.data.keys()
    for k in want.data:
        np.testing.assert_array_equal(got.data[k], want.data[k])
    np.testing.assert_array_equal(got.sample_valid, want.sample_valid)
    np.testing.assert_array_equal(got.n_batches, want.n_batches)
    np.testing.assert_array_equal(got.n_samples, want.n_samples)
    assert got.sample_valid.shape == (4, 4, 4) and got.sample_valid[3].sum() == 1


@pytest.mark.parametrize("local_epochs", [1, 2])
@pytest.mark.parametrize("strategy", ["linear", "none"])
def test_step_plan_matches(strategy, local_epochs):
    rng = np.random.default_rng(2)
    orders = [rng.permutation(n) for n in (5, 3, 9)]
    js = jcurr.CurriculumSchedule(strategy=strategy, beta=0.3, total_rounds=6)
    ts = tcurr.CurriculumSchedule(strategy=strategy, beta=0.3, total_rounds=6)
    for t in range(7):
        bi, sv = tcurr.step_plan(ts, t, orders, local_epochs)
        jbi, jsv = jcurr.step_plan(js, t, orders, local_epochs)
        assert bi.dtype == jbi.dtype and sv.dtype == jsv.dtype
        np.testing.assert_array_equal(bi, jbi)
        np.testing.assert_array_equal(sv, jsv)


def test_masked_loss_matches(world):
    loss_fn, params, lora, t = world
    rng = np.random.default_rng(3)
    batch = _clients(rng, [4], seq=10)[0]
    for mask in (np.ones(4, np.float32), np.array([1, 1, 0, 1], np.float32), np.zeros(4, np.float32)):
        for b in (batch, {"tokens": batch["tokens"]}):  # label-token and next-token objectives
            want = loss_fn.masked(params, lora, b, jnp.asarray(mask))
            got = t["loss"].masked(t["params"], t["lora"], _torch_batch(b), torch.from_numpy(mask))
            assert float(got) == pytest.approx(float(want), rel=1e-5, abs=1e-6)
    # a masked padded batch is the plain loss of its ragged sub-batch
    sub = {k: v[[0, 1, 3]] for k, v in batch.items()}
    plain = t["loss"](t["params"], t["lora"], _torch_batch(sub))
    masked = t["loss"].masked(t["params"], t["lora"], _torch_batch(batch),
                              torch.tensor([1.0, 1.0, 0.0, 1.0]))
    assert float(masked) == pytest.approx(float(plain), rel=1e-6)


def test_batch_fisher_scores_and_masked_fim_match(world):
    loss_fn, params, lora, t = world
    stack = j_stack_clients(_clients(np.random.default_rng(4), [7]), 3)
    batches = {k: v[0] for k, v in stack.data.items()}  # (3 batches, 3, ...)
    sv = stack.sample_valid[0]
    assert sv[-1].tolist() == [1.0, 0.0, 0.0]  # a padded final batch
    want = jfish.batch_fisher_scores(loss_fn, params, lora, batches, jnp.asarray(sv))
    got = tfish.batch_fisher_scores(t["loss"], t["params"], t["lora"], _torch_batch(batches), torch.from_numpy(sv))
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    last = {k: v[-1] for k, v in batches.items()}
    want = jfish.fim_diag(loss_fn, params, lora, last, jnp.asarray(sv[-1]))
    got = tfish.fim_diag(t["loss"], t["params"], t["lora"], _torch_batch(last), torch.from_numpy(sv[-1]))
    for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=1e-4)


def test_server_merges_match():
    rng = np.random.default_rng(5)
    shape = (2, 6, 3)
    g = {"w": rng.standard_normal(shape).astype(np.float32)}
    stacked = {"w": rng.standard_normal((3,) + shape).astype(np.float32)}
    mask = {"w": np.array([1.0, 0.0], np.float32).reshape(2, 1, 1)}
    w = np.array([0.2, 0.5, 0.3], np.float32)
    tt = lambda tree: {k: torch.from_numpy(v) for k, v in tree.items()}  # noqa: E731
    for jf, tf in ((jeng.gal_weighted_merge, teng.gal_weighted_merge),
                   (jeng.gal_delta_merge, teng.gal_delta_merge)):
        want = jf(g, mask, stacked, jnp.asarray(w))
        got = tf(tt(g), tt(mask), tt(stacked), torch.from_numpy(w))
        np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]), atol=1e-6, rtol=1e-6)
        np.testing.assert_array_equal(got["w"].numpy()[1], g["w"][1])  # non-GAL layer untouched
