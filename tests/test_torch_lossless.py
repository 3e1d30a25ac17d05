"""The port's lossless criteria (``repro_torch.core.gal``: Lanczos Ritz
values of the LoRA Hessian, the Lipschitz margin, the eigengap fraction),
the runner with ``gal_fraction=None`` / ``sparse_ratio=None`` on both
engines, and ``optim.schedule`` against the JAX package's.

The port cannot replay ``jax.random``, so each side gets the same normal
draws: the JAX package's own (its ``fold_in`` keys, in its order), handed to
the port through the ``draw`` callable, and to the runner by replacing
``repro_torch.core.fibecfed._lossless_draw`` (its per-client draws).

The JAX side runs its loss under ``jax.jit`` (:func:`jitted`): its Lanczos
loop calls the Hessian-vector product eagerly, op by op, which takes ~30 s
a client on the CPU; jitted, the same arithmetic takes ~0.2 s. The runner's
values are read off its own calls (:func:`recording`).

Tolerances: Ritz values within rtol 1e-4 plus 1e-5 of the spectrum's
largest |λ| (the Hessian-vector products sum in other orders, and Lanczos
in f32 errs relative to ‖H‖, so a small Ritz value carries the rounding of
the large ones); the Lipschitz estimate within rel 1e-3 (a difference of two
nearby gradients); fractions, GAL layers and neuron masks identical. The
eigengap rule is discontinuous, so every comparison of fractions first
asserts that no gap lies within the two sides' difference of the 4·L
margin; the worlds' seeds were fixed before any comparison.
"""
import dataclasses

import pytest

pytest.importorskip("torch").set_num_threads(1)  # xdist workers share the cores: no thread pool each

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.config import FibecFedConfig, ModelConfig
from repro.configs import ARCHS
from repro.core import gal as jgal
from repro.data import dirichlet_partition, make_keyword_task
from repro.federated import make_runner
from repro.models import build_model
from repro.optim.schedule import linear_warmup_cosine as j_schedule
from repro.train import make_loss_fn

import repro_torch.config as tconfig
from repro_torch.convert import lora_from_numpy, params_from_numpy, to_numpy
from repro_torch.core import gal as tgal
from repro_torch.core import fibecfed as t_fibecfed
from repro_torch.core.fibecfed import check_ported
from repro_torch.federated import make_runner as t_make_runner
from repro_torch.models import build_model as t_build_model
from repro_torch.optim import linear_warmup_cosine
from repro_torch.train import make_loss_fn as t_make_loss_fn
from repro_torch.utils.tree import tree_leaves
from torch_jax_refs import release_jax_programs  # noqa: F401

TINY = ModelConfig(
    name="tiny-lm", family="dense", num_layers=2, d_model=32, num_heads=2,
    num_kv_heads=2, d_ff=64, vocab_size=256, head_dim=16, rope="full",
    norm="rmsnorm", mlp="swiglu", dtype="float32", lora_rank=2, max_seq_len=64,
)
FL = FibecFedConfig(
    num_devices=4, devices_per_round=2, rounds=4, batch_size=4, learning_rate=5e-3,
    fim_warmup_epochs=1, gal_fraction=None, sparse_ratio=None, lanczos_iters=8,
)
ITERS = 8


def torch_config(cfg):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["ssm"] = tconfig.SSMConfig(**dataclasses.asdict(cfg.ssm)) if cfg.ssm is not None else None
    return tconfig.ModelConfig(**kw)


def jax_draws(key, shapes, n_probes=4):
    """The normals JAX's ``lossless_rank_fraction`` draws from ``key``, in
    the order the port's functions ask for them: the starting vector's
    leaves, then each Lipschitz probe's."""
    out = [jax.random.normal(jax.random.fold_in(key, j), s, jnp.float32) for j, s in enumerate(shapes)]
    k_lip = jax.random.fold_in(key, 777)
    for i in range(n_probes):
        k = jax.random.fold_in(k_lip, i)
        out += [jax.random.normal(jax.random.fold_in(k, j), s, jnp.float32) for j, s in enumerate(shapes)]
    return [np.array(d) for d in out]


def replay(draws):
    """A port ``draw(leaf_index, shape)`` that hands out ``draws`` in order."""
    it = iter(draws)

    def draw(j, shape):
        d = next(it)
        assert d.shape == tuple(shape)
        return torch.from_numpy(d.copy())

    return draw


def jitted(loss_fn):
    """``loss_fn`` under ``jax.jit``, keeping its ``.masked`` variant."""
    jit = jax.jit(loss_fn)

    def fn(params, lora, batch):
        return jit(params, lora, batch)

    fn.masked = loss_fn.masked
    return fn


def recording(monkeypatch):
    """Record what JAX's ``lossless_rank_fraction`` computes: each call's
    Ritz values and Lipschitz estimate, in call order."""
    seen = {"eigs": [], "lipschitz": []}
    lanczos, lipschitz = jgal.lanczos_spectrum, jgal.estimate_lipschitz

    def rec_lanczos(*a, **kw):
        seen["eigs"].append(lanczos(*a, **kw))
        return seen["eigs"][-1]

    def rec_lipschitz(*a, **kw):
        seen["lipschitz"].append(lipschitz(*a, **kw))
        return seen["lipschitz"][-1]

    monkeypatch.setattr(jgal, "lanczos_spectrum", rec_lanczos)
    monkeypatch.setattr(jgal, "estimate_lipschitz", rec_lipschitz)
    return seen


def _shapes(lora):
    return [tuple(x.shape) for x in jax.tree.leaves(lora)]


@pytest.fixture(scope="module")
def tiny():
    """The tiny dense model, its params, a LoRA with a non-zero b and one
    batch, on both sides."""
    model = build_model(TINY)
    key = jax.random.PRNGKey(0)
    params = jax.tree.map(np.asarray, model.init_params(key))
    rng = np.random.default_rng(0)
    lora = jax.tree.map(lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape)).astype(np.float32),
                        model.init_lora(jax.random.fold_in(key, 1)))
    tokens = rng.integers(0, TINY.vocab_size, (4, 12)).astype(np.int32)
    t_model = t_build_model(torch_config(TINY))
    return dict(
        loss=jitted(make_loss_fn(model)), params=params, lora=lora, batch={"tokens": jnp.asarray(tokens)},
        t_loss=t_make_loss_fn(t_model), t_params=params_from_numpy(params, t_model.cfg, "cpu"),
        t_lora=lora_from_numpy(lora, "cpu"), t_batch={"tokens": torch.as_tensor(tokens).long()},
    )


def _ritz_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def _margin_clear(eigs_j, eigs_t, lip_j, lip_t):
    """The eigengap rule's precondition: no gap within the two sides'
    difference of the margin, so both pick the same gap."""
    gaps = np.diff(np.asarray(eigs_j))
    slack = 2 * np.abs(np.asarray(eigs_t) - np.asarray(eigs_j)).max() + 4 * abs(lip_t - lip_j)
    assert np.abs(gaps - 4 * lip_j).min() > slack, (gaps, lip_j, slack)


@pytest.mark.parametrize("step", [0, 3, 10, 55, 100, 130])
def test_linear_warmup_cosine_matches_jax(step):
    kw = dict(base_lr=3e-4, warmup=10, total=100)
    want = np.asarray(j_schedule(step, **kw))
    got = linear_warmup_cosine(step, **kw)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    steps = np.arange(0, 120)
    np.testing.assert_allclose(linear_warmup_cosine(torch.as_tensor(steps), **kw).numpy(),
                               np.asarray(j_schedule(steps, **kw)), rtol=1e-6, atol=1e-12)
    assert float(linear_warmup_cosine(step, base_lr=1.0, warmup=0, total=0)) == float(
        j_schedule(step, base_lr=1.0, warmup=0, total=0))


def test_lora_hvp_matches_jax(tiny):
    """Forward over reverse on both sides, one direction: each entry sums
    products over the whole LoRA tree in another order, so it agrees within
    1e-5 of the largest |Hv| (rtol 1e-4 beside it)."""
    v = jax.tree.map(lambda x: np.random.default_rng(x.size).standard_normal(x.shape).astype(np.float32),
                     tiny["lora"])
    want = jgal.make_lora_hvp(tiny["loss"], tiny["params"], tiny["lora"], tiny["batch"])(
        jax.tree.map(jnp.asarray, v))
    got = tgal.make_lora_hvp(tiny["t_loss"], tiny["t_params"], tiny["t_lora"], tiny["t_batch"])(
        lora_from_numpy(v, "cpu"))
    scale = max(float(np.abs(np.asarray(w)).max()) for w in jax.tree.leaves(want))
    for g, w in zip(tree_leaves(to_numpy(got)), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-5 * scale)


def test_lanczos_spectrum_matches_jax(tiny):
    key = jax.random.PRNGKey(5)
    draws = jax_draws(key, _shapes(tiny["lora"]), n_probes=0)
    v0 = jax.tree.unflatten(jax.tree.structure(tiny["lora"]), [jnp.asarray(d) for d in draws])
    want = jgal.lanczos_spectrum(jgal.make_lora_hvp(tiny["loss"], tiny["params"], tiny["lora"], tiny["batch"]),
                                 v0, ITERS)
    hvp = tgal.make_lora_hvp(tiny["t_loss"], tiny["t_params"], tiny["t_lora"], tiny["t_batch"])
    got = tgal.lanczos_spectrum(hvp, lora_from_numpy(jax.tree.map(np.asarray, v0), "cpu"), ITERS)
    assert len(got) == ITERS and np.all(np.diff(got) >= 0)
    _ritz_close(got, want)


def test_estimate_lipschitz_matches_jax(tiny):
    key = jax.random.fold_in(jax.random.PRNGKey(5), 777)
    draws = jax_draws(jax.random.PRNGKey(5), _shapes(tiny["lora"]))[len(_shapes(tiny["lora"])):]
    want = jgal.estimate_lipschitz(tiny["loss"], tiny["params"], tiny["lora"], tiny["batch"], key)
    got = tgal.estimate_lipschitz(tiny["t_loss"], tiny["t_params"], tiny["t_lora"], tiny["t_batch"],
                                  replay(draws))
    assert want > 0
    assert got == pytest.approx(want, rel=1e-3)


@pytest.mark.parametrize("seed", [5, 6])
def test_lossless_rank_fraction_matches_jax(tiny, seed, monkeypatch):
    key = jax.random.PRNGKey(seed)
    draws = jax_draws(key, _shapes(tiny["lora"]))
    seen = recording(monkeypatch)
    want = jgal.lossless_rank_fraction(tiny["loss"], tiny["params"], tiny["lora"], tiny["batch"], key,
                                       iters=ITERS)
    (eigs,), (lip,) = seen["eigs"], seen["lipschitz"]
    res = tgal.lossless_criterion(tiny["t_loss"], tiny["t_params"], tiny["t_lora"], tiny["t_batch"],
                                  replay(draws), iters=ITERS)
    _ritz_close(res["eigs"], eigs)
    assert res["lipschitz"] == pytest.approx(lip, rel=1e-3)
    _margin_clear(eigs, res["eigs"], lip, res["lipschitz"])
    assert res["fraction"] == want


def _world(cfg):
    task = make_keyword_task(n_samples=50, seq_len=12, vocab_size=256, seed=0)
    parts = dirichlet_partition(task.data["label"], FL.num_devices, 1.0, seed=0)
    clients = [{k: v[idx] for k, v in task.data.items() if k != "label"} for idx in parts]
    model = build_model(cfg)
    t_model = t_build_model(torch_config(cfg))
    return model, jitted(make_loss_fn(model)), t_model, t_make_loss_fn(t_model), clients


@pytest.mark.parametrize("engine", ["loop", "vectorized"])
def test_runner_lossless_matches_jax(engine, monkeypatch):
    """``gal_fraction=None, sparse_ratio=None`` on the tiny dense world:
    each client's Ritz values, Lipschitz estimate and fraction, the GAL
    layers and every client's neuron masks equal the JAX engine's, given
    its draws; then one round keeps the ROADMAP gate."""
    model, loss_fn, t_model, t_loss_fn, clients = _world(TINY)
    seen = recording(monkeypatch)
    ref = make_runner("fibecfed", model, loss_fn, FL, clients, optimizer="adamw", engine=engine, seed=7)
    shapes = _shapes(ref._init_lora)
    monkeypatch.setattr(t_fibecfed, "_lossless_draw", lambda device, seed, ci: replay(
        jax_draws(jax.random.fold_in(ref.key, 1000 + ci), shapes)))
    port = t_make_runner(
        "fibecfed", t_model, t_loss_fn, tconfig.FibecFedConfig(**dataclasses.asdict(FL)), clients,
        optimizer="adamw", engine=engine, seed=7, device="cpu",
        init_params=jax.tree.map(np.asarray, ref.params), init_lora=jax.tree.map(np.asarray, ref._init_lora),
    )
    ref.init_phase()
    port.init_phase()
    assert len(seen["eigs"]) == len(seen["lipschitz"]) == len(clients)
    for cr, cp, eigs, lip in zip(ref.clients, port.clients, seen["eigs"], seen["lipschitz"]):
        np.testing.assert_array_equal(cr.order, cp.order)
        _ritz_close(cp.lossless["eigs"], eigs)
        assert cp.lossless["lipschitz"] == pytest.approx(lip, rel=1e-3)
        _margin_clear(eigs, cp.lossless["eigs"], lip, cp.lossless["lipschitz"])
        assert cp.lossless_fraction == cr.lossless_fraction
        for g, w in zip(tree_leaves(to_numpy(cp.neuron_mask)), jax.tree.leaves(cr.neuron_mask)):
            np.testing.assert_array_equal(g, np.asarray(w))
    np.testing.assert_array_equal(ref.gal_layers, port.gal_layers)
    hr, hp = ref.run_round(0), port.run_round(0)
    assert hp["loss"] == pytest.approx(hr["loss"], rel=1e-4, abs=1e-5)
    for a, b in zip(tree_leaves(to_numpy(port.global_lora)), jax.tree.leaves(ref.global_lora)):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), atol=5e-5, rtol=1e-4)
    assert port.comm_bytes_per_round == ref.comm_bytes_per_round


def test_ssm_runner_lossless_engines_agree():
    """The lossless criteria on the reduced mamba2 (forward over reverse
    through the SSM block): the port's two engines, from the same draws,
    read the same spectra (within the Ritz tolerance) and make the same
    decisions."""
    cfg = torch_config(ARCHS["mamba2-1.3b"].reduced())
    _, _, t_model, t_loss_fn, clients = _world(ARCHS["mamba2-1.3b"].reduced())
    fl = tconfig.FibecFedConfig(**dataclasses.asdict(FL))
    runs = []
    for engine in ("loop", "vectorized"):
        r = t_make_runner("fibecfed", t_model, t_loss_fn, fl, clients, optimizer="adamw", engine=engine, seed=7,
                          device="cpu")
        r.init_phase()
        runs.append(r)
    assert runs[0].cfg == cfg
    for a, b in zip(*(r.clients for r in runs)):
        _ritz_close(b.lossless["eigs"], a.lossless["eigs"])
        _margin_clear(a.lossless["eigs"], b.lossless["eigs"], a.lossless["lipschitz"], b.lossless["lipschitz"])
        assert a.lossless_fraction == b.lossless_fraction
        for g, w in zip(tree_leaves(a.neuron_mask), tree_leaves(b.neuron_mask)):
            assert torch.equal(g, w)
    np.testing.assert_array_equal(runs[0].gal_layers, runs[1].gal_layers)


def test_lossless_runner_draws_from_its_seed():
    """Each client draws from a generator seeded from the run's seed: the same seed gives the same spectra, another seed
    other ones. ``check_ported`` takes both fractions as None."""
    check_ported("loop", tconfig.FibecFedConfig(gal_fraction=None, sparse_ratio=None))
    _, _, t_model, t_loss_fn, clients = _world(TINY)
    fl = tconfig.FibecFedConfig(**dataclasses.asdict(FL))

    def spectra(seed):
        r = t_make_runner("fibecfed", t_model, t_loss_fn, fl, clients, engine="loop", seed=seed, device="cpu")
        r.init_phase()
        assert all(0.0 < c.lossless_fraction <= 1.0 for c in r.clients)
        return [c.lossless["eigs"] for c in r.clients]

    a, b, c = spectra(3), spectra(3), spectra(4)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.allclose(x, y) for x, y in zip(a, c))
