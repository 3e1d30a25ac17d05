"""The port's encoder family (roberta-large, the paper's own evaluation
model: the decoder's blocks made bidirectional, no position information,
mean pooling and a class head; the class loss, ``evaluate`` against
``labels``, the runner on it, and the refusals of every decode path)
against the JAX package.

The world is ``ARCHS["roberta-large"].reduced()``: 2 layers, d 128, 4 heads
of 32, vocab 512, 2 classes, f32. Params come from the JAX init through
``repro_torch.convert``, the adapters get a non-zero ``b``, and tokens and
labels are made from a seed with numpy (the keyword task's ``label`` taken
mod 2 as ``labels``).

Tolerances: logits, probe norms and losses at atol 2e-5 / rtol 1e-4 (the
other families' files'); the runners at the slice gate (losses rel 1e-4 /
abs 1e-5, global LoRA atol 5e-5 / rtol 1e-4, identical comm bytes,
curriculum orders and GAL layers); accuracies equal.
"""
import dataclasses
import warnings

import pytest

pytest.importorskip("torch").set_num_threads(1)  # xdist workers share the cores: no thread pool each

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.config import FibecFedConfig
from repro.configs import ARCHS
from repro.data import make_keyword_task
from repro.federated import make_runner
from repro.models import build_model
from repro.serve import ServeEngine as JServeEngine
from repro.train import make_loss_fn

import repro_torch.config as tconfig
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import INPUT_SHAPES
from repro_torch.convert import lora_from_numpy, params_from_numpy, to_numpy
from repro_torch.federated import make_runner as t_make_runner
from repro_torch.models import build_model as t_build_model
from repro_torch.serve import ServeEngine, make_prompt_batch
from repro_torch.train import cls_loss
from repro_torch.train import make_loss_fn as t_make_loss_fn
from repro_torch.utils.tree import tree_items, tree_leaves
from torch_jax_refs import release_jax_programs  # noqa: F401

ATOL, RTOL = 2e-5, 1e-4
CFG = ARCHS["roberta-large"].reduced()
FL = FibecFedConfig(num_devices=4, devices_per_round=2, rounds=4, batch_size=4, learning_rate=5e-3,
                    fim_warmup_epochs=1, gal_fraction=0.5, sparse_ratio=0.5)


def torch_config(cfg):
    return tconfig.ModelConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


@pytest.fixture(scope="module")
def world():
    model = build_model(CFG)
    rng = jax.random.PRNGKey(0)
    params = jax.tree.map(np.asarray, jax.jit(model.init_params)(rng))
    nrng = np.random.default_rng(0)
    adapters = [
        jax.tree.map(lambda x: (np.asarray(x) + 0.05 * nrng.standard_normal(x.shape)).astype(np.float32),
                     model.init_lora(jax.random.fold_in(rng, i)))
        for i in range(2)
    ]
    t_model = t_build_model(torch_config(CFG))
    return model, params, adapters, t_model, params_from_numpy(params, t_model.cfg, "cpu"), \
        [lora_from_numpy(a, "cpu") for a in adapters]


def _batch(n, S, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 512, (n, S)).astype(np.int32),
            "labels": rng.integers(0, CFG.num_classes, n).astype(np.int32)}


def _t(batch):
    return {k: torch.as_tensor(v).long() for k, v in batch.items()}


def _close(t, j, what):
    np.testing.assert_allclose(t.detach().to(torch.float32).numpy(), np.asarray(j, np.float32), atol=ATOL,
                               rtol=RTOL, err_msg=what)


def test_config_and_init_follow_jax():
    """The registry's roberta-large is the JAX package's; the init has a
    class head (d, num_classes) and no LM head, every leaf at JAX's shape
    and dtype."""
    assert torch_config(ARCHS["roberta-large"]) == T_ARCHS["roberta-large"]
    jp = jax.eval_shape(build_model(CFG).init_params, jax.random.PRNGKey(0))
    tp = t_build_model(torch_config(CFG)).init_params(torch.Generator().manual_seed(0), "cpu")
    assert {p: (tuple(t.shape), str(t.dtype)[6:]) for p, t in tree_items(tp)} == \
        {p: (tuple(s.shape), str(s.dtype)) for p, s in tree_items(jp)}
    assert tp["cls_head"].shape == (CFG.d_model, 2) and "lm_head" not in tp


def test_forward_losses_and_probe_match_jax(world):
    """Class logits (B, num_classes), the class loss, its masked form equal
    to the ragged sub-batch's loss, and the probe norms under noise."""
    model, params, adapters, t_model, t_params, t_adapters = world
    batch = _batch(3, 20)
    jb, tb = jax.tree.map(jnp.asarray, batch), _t(batch)
    eps = np.random.default_rng(4).standard_normal((3, 20, CFG.d_model)).astype(np.float32) * 0.1
    logits, _ = model.forward(params, adapters[1], jb)
    _, _, norms = model.forward_probe(params, adapters[1], jb, jnp.asarray(eps))
    loss_fn = t_make_loss_fn(t_model)
    with torch.no_grad():
        t_logits, aux = t_model.forward(t_params, t_adapters[1], tb)
        _, _, t_norms = t_model.forward_probe(t_params, t_adapters[1], tb, torch.as_tensor(eps))
        t_loss = loss_fn(t_params, t_adapters[1], tb)
        t_masked = loss_fn.masked(t_params, t_adapters[1], tb, torch.tensor([1.0, 0.0, 1.0]))
        sub = {k: v[[0, 2]] for k, v in tb.items()}
        t_sub = loss_fn(t_params, t_adapters[1], sub)
    assert t_logits.shape == (3, CFG.num_classes) and float(aux) == 0.0 and t_norms.shape == (CFG.num_layers, 3)
    _close(t_logits, logits, "class logits")
    _close(t_norms, norms, "layer norms")
    torch.testing.assert_close(t_loss, cls_loss(t_logits, tb["labels"]))
    j_loss = make_loss_fn(model)
    np.testing.assert_allclose(float(t_loss), float(j_loss(params, adapters[1], jb)), atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(t_masked, t_sub, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(float(t_masked), float(j_loss.masked(params, adapters[1], jb, jnp.array([1, 0, 1]))),
                               atol=ATOL, rtol=RTOL)


def test_no_position_information(world):
    """rope "none" and no learned table, as in the JAX package: a permutation
    of the tokens permutes the hidden states, and mean pooling leaves the
    class logits unchanged."""
    _, _, _, t_model, t_params, t_adapters = world
    tb = _t(_batch(2, 16, seed=3))
    perm = torch.randperm(16, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a, _ = t_model.forward(t_params, t_adapters[0], tb)
        b, _ = t_model.forward(t_params, t_adapters[0], {**tb, "tokens": tb["tokens"][:, perm]})
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_decode_paths_raise_as_jax(world):
    """No decode: ``supports`` says so for every decode shape, and init_cache,
    prefill, decode_step and ServeEngine's first admission raise JAX's
    error."""
    model, params, adapters, t_model, t_params, t_adapters = world
    for name, shape in INPUT_SHAPES.items():
        assert t_model.supports(shape) == (shape.kind != "decode"), name
    batch = make_prompt_batch(t_model.cfg, 0, 2, 8)
    assert sorted(batch) == ["tokens"]
    msg = "encoder-only model has no decode path"
    with pytest.raises(NotImplementedError, match=msg):
        t_model.init_cache(2, 16, "cpu")
    with pytest.raises(NotImplementedError, match=msg):
        t_model.decode_step(t_params, t_adapters[0], None, None, 0)
    with pytest.raises(NotImplementedError, match=msg):
        JServeEngine(model, params, adapters[0], cache_len=16).generate({"tokens": jnp.asarray(batch["tokens"])})
    with pytest.raises(NotImplementedError, match=msg):
        ServeEngine(t_model, t_params, t_adapters[0], cache_len=16, device="cpu").generate(batch)


def test_launcher_exits_with_the_no_decode_error():
    from repro_torch.launch.serve import main

    with pytest.raises(SystemExit, match="roberta-large: encoder-only model has no decode path"):
        main(["--arch", "roberta-large", "--device", "cpu"])


@pytest.fixture(scope="module")
def data():
    task = make_keyword_task(n_samples=48, seq_len=12, vocab_size=256, seed=0)
    return {"tokens": task.data["tokens"], "labels": (task.data["label"] % 2).astype(np.int32)}


@pytest.fixture(scope="module")
def clients(data):
    """4 clients of 4, 8, 12 and 8 samples."""
    edges = np.cumsum([0, 4, 8, 12, 8])
    return [{k: v[a:b] for k, v in data.items()} for a, b in zip(edges[:-1], edges[1:])]


@pytest.fixture(scope="module")
def jax_loop_run(world, clients, data):
    model = world[0]
    ref = make_runner("fibecfed", model, make_loss_fn(model), FL, clients, optimizer="adamw", engine="loop", seed=7)
    ref.init_phase()
    rounds = [(ref.run_round(t), jax.tree.map(np.asarray, ref.global_lora)) for t in range(2)]
    return ref, rounds, ref.evaluate({k: v[32:] for k, v in data.items()}, batch_size=8)


@pytest.mark.parametrize("engine", ["loop", "vectorized"])
def test_runner_matches_jax_loop_engine(world, clients, data, jax_loop_run, engine):
    """FibecFed/AdamW on the encoder (class loss over ``labels``), 2 rounds,
    each port engine against the JAX loop engine: the same curriculum orders
    and GAL layers, losses, global LoRA and comm bytes; then ``evaluate``'s
    class argmax against ``labels`` gives JAX's accuracy."""
    ref, rounds, acc = jax_loop_run
    t_model = world[3]
    port = t_make_runner("fibecfed", t_model, t_make_loss_fn(t_model), tconfig.FibecFedConfig(**dataclasses.asdict(FL)),
                         clients, optimizer="adamw", engine=engine, seed=7, device="cpu",
                         init_params=jax.tree.map(np.asarray, ref.params),
                         init_lora=jax.tree.map(np.asarray, ref._init_lora))
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            port.init_phase()
            for cr, cp in zip(ref.clients, port.clients):
                np.testing.assert_array_equal(cr.order, cp.order)
            np.testing.assert_array_equal(ref.gal_layers, port.gal_layers)
            for t, (hr, glora) in enumerate(rounds):
                hp = port.run_round(t)
                assert hp["loss"] == pytest.approx(hr["loss"], rel=1e-4, abs=1e-5)
                assert hp["selected_batches"] == hr["selected_batches"]
                for a, b in zip(tree_leaves(to_numpy(port.global_lora)), jax.tree.leaves(glora)):
                    np.testing.assert_allclose(a, b, atol=5e-5, rtol=1e-4)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    assert not [str(w.message) for w in caught if "batching rule" in str(w.message)]
    assert port.comm_bytes_per_round == ref.comm_bytes_per_round
    assert port.evaluate({k: v[32:] for k, v in data.items()}, batch_size=8) == acc
