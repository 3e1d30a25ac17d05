"""The port's initialization mechanisms agree with the JAX package's.

Fisher scores and the diagonal FIM (per-sample gradients), the GAL
sensitivity probe, neuron and GAL masks, and the curriculum, each on the
same seeded inputs through both packages. Gradients are held at atol 1e-5,
rtol 1e-4 in f32: tiny-lm's gradients move by ~1e-4 under a one-ulp change
of its weights (ROADMAP.md §C), so the two frameworks' rounding shows there.
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
from repro.core import fisher as jfish
from repro.core import gal as jgal
from repro.core import sparse as jsparse
from repro.lora import gal_mask_tree as j_gal_mask_tree
from repro.lora import neuron_mask_tree as j_neuron_mask_tree
from repro.models import build_model
from repro.train import make_loss_fn
from repro.train.losses import make_logits_loss

import repro_torch.config as tconfig
from repro_torch.convert import lora_from_numpy, params_from_numpy, to_numpy
from repro_torch.core import curriculum as tcurr
from repro_torch.core import fisher as tfish
from repro_torch.core import gal as tgal
from repro_torch.core import sparse as tsparse
from repro_torch.lora import gal_mask_tree, lora_num_logical_layers, neuron_mask_tree
from repro_torch.models import build_model as t_build_model
from repro_torch.train import make_logits_loss as t_make_logits_loss
from repro_torch.train import make_loss_fn as t_make_loss_fn
from repro_torch.utils.tree import tree_leaves
from torch_jax_refs import release_jax_programs  # noqa: F401

CFG = ModelConfig(
    name="tiny-lm", family="dense", num_layers=2, d_model=32, num_heads=2,
    num_kv_heads=2, d_ff=64, vocab_size=256, head_dim=16, rope="full",
    norm="rmsnorm", mlp="swiglu", dtype="float32", lora_rank=2, max_seq_len=64,
)


@pytest.fixture(scope="module")
def world():
    model = build_model(CFG)
    params = jax.tree.map(np.asarray, model.init_params(jax.random.PRNGKey(0)))
    lora = jax.tree.map(np.asarray, model.init_lora(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(0)
    lora = jax.tree.map(lambda x: (x + 0.05 * rng.standard_normal(x.shape)).astype(np.float32), lora)
    batch = {
        "tokens": rng.integers(0, 256, (3, 12)).astype(np.int32),
        "label_token": rng.integers(0, 256, (3,)).astype(np.int32),
    }
    t_cfg = tconfig.ModelConfig(**{f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)})
    t_model = t_build_model(t_cfg)
    t = dict(
        model=t_model, loss=t_make_loss_fn(t_model), params=params_from_numpy(params, t_cfg, "cpu"),
        lora=lora_from_numpy(lora, "cpu"),
        batch={k: torch.as_tensor(v).to(torch.int64) for k, v in batch.items()},
    )
    return model, make_loss_fn(model), params, lora, batch, t


def test_per_sample_fisher_scores_match(world):
    model, loss_fn, params, lora, batch, t = world
    ref = jfish.per_sample_fisher_scores(loss_fn, params, lora, batch)
    out = tfish.per_sample_fisher_scores(t["loss"], t["params"], t["lora"], t["batch"])
    assert out.shape == (3,)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4)


def test_fim_diag_and_momentum_match(world):
    model, loss_fn, params, lora, batch, t = world
    ref = jfish.fim_diag(loss_fn, params, lora, batch)
    out = tfish.fim_diag(t["loss"], t["params"], t["lora"], t["batch"])
    for a, b in zip(jax.tree.leaves(ref), tree_leaves(out)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=1e-4)
    # mean of per-sample squares, not the square of the mean gradient
    g = torch.func.grad(lambda lo: t["loss"](t["params"], lo, t["batch"]))(t["lora"])
    sq_of_mean = sum(float(torch.sum(x * x)) for x in tree_leaves(g))
    assert sum(float(torch.sum(x)) for x in tree_leaves(out)) > sq_of_mean
    ref2 = jfish.fim_momentum_update(ref, ref, 0.9)
    out2 = tfish.fim_momentum_update(out, out, 0.9)
    assert tfish.fim_momentum_update(None, out, 0.9) is out
    for a, b in zip(jax.tree.leaves(ref2), tree_leaves(out2)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=1e-4)


def test_layer_sensitivity_scores_match(world):
    model, loss_fn, params, lora, batch, t = world
    kw = dict(gamma=0.05, p=2.0, noise_shape=(3, 12, CFG.d_model))
    ref = jgal.layer_sensitivity_scores(model.forward_probe, make_logits_loss(CFG), params, lora, batch, **kw)
    out = tgal.layer_sensitivity_scores(
        t["model"].forward_probe, t_make_logits_loss(t["model"].cfg), t["params"], t["lora"], t["batch"], **kw
    )
    assert out.shape == (lora_num_logical_layers(t["model"].cfg),)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-3)


@pytest.mark.parametrize("p", [2.0, 3.0, np.inf])
def test_adversarial_perturbation_matches(p):
    g = np.random.default_rng(0).standard_normal((2, 5, 7)).astype(np.float32)
    ref = jgal.adversarial_perturbation(jnp.asarray(g), 0.05, p)
    out = tgal.adversarial_perturbation(torch.from_numpy(g), 0.05, p)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-7, rtol=1e-5)


def test_server_side_gal_selection_matches():
    rng = np.random.default_rng(0)
    scores = [rng.uniform(size=6) for _ in range(3)]
    ns = [10, 25, 7]
    agg = tgal.aggregate_layer_scores(scores, ns)
    np.testing.assert_array_equal(agg, jgal.aggregate_layer_scores(scores, ns))
    for frac in (0.1, 0.5, 0.75, 1.0):
        n_star = tgal.gal_layer_count([frac] * 3, ns, 6)
        assert n_star == jgal.gal_layer_count([frac] * 3, ns, 6)
        np.testing.assert_array_equal(
            tgal.select_gal_layers(agg, n_star), jgal.select_gal_layers(agg, n_star)
        )


@pytest.mark.parametrize("rho", [0.25, 0.5, 1.0])
def test_neuron_and_gal_masks_match(world, rho):
    model, loss_fn, params, lora, batch, t = world
    rng = np.random.default_rng(int(rho * 8))
    fim = jax.tree.map(lambda x: np.abs(rng.standard_normal(x.shape)).astype(np.float32), lora)
    fim["layers"]["wq"]["b"][:, :, :3] = 0.0  # ties at the threshold keep every tied neuron
    keep_j = jsparse.select_neuron_masks(jsparse.neuron_importance(fim), rho)
    keep_t = tsparse.select_neuron_masks(tsparse.neuron_importance(lora_from_numpy(fim, "cpu")), rho)
    for a, b in zip(jax.tree.leaves(keep_j), tree_leaves(keep_t)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    masks_j = j_neuron_mask_tree(CFG, lora, keep_j)
    masks_t = neuron_mask_tree(t["model"].cfg, t["lora"], keep_t)
    for a, b in zip(jax.tree.leaves(masks_j), tree_leaves(masks_t)):
        assert b.shape == a.shape and b.is_contiguous()
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    gal = np.array([True, False])
    for a, b in zip(jax.tree.leaves(j_gal_mask_tree(CFG, lora, gal)),
                    tree_leaves(gal_mask_tree(t["model"].cfg, t["lora"], gal))):
        assert b.shape == a.shape == (2, 1, 1)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("strategy", ["linear", "sqrt", "quadratic", "exp", "none"])
def test_curriculum_matches(strategy):
    rng = np.random.default_rng(0)
    diff = rng.uniform(size=11)
    diff[3] = diff[7]  # a tie: the stable sort keeps index order
    js = jcurr.CurriculumSchedule(strategy=strategy, total_rounds=10)
    ts = tcurr.CurriculumSchedule(strategy=strategy, total_rounds=10)
    order_j = jcurr.order_batches(diff, strategy)
    np.testing.assert_array_equal(tcurr.order_batches(diff, strategy), order_j)
    for t in range(12):
        assert ts.fraction(t) == js.fraction(t)
        np.testing.assert_array_equal(
            tcurr.selected_batch_ids(ts, t, order_j), jcurr.selected_batch_ids(js, t, order_j)
        )


def test_to_numpy_keeps_tree_paths(world):
    *_, lora, _, t = world
    back = to_numpy(t["lora"])
    assert jax.tree.structure(back) == jax.tree.structure(lora)
    for a, b in zip(jax.tree.leaves(lora), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
