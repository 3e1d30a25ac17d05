"""The port's dense decoder agrees with the JAX package's.

Params come from the JAX init (through ``repro_torch.convert``) with a
non-zero LoRA ``b``; inputs are made from a seed with numpy. Logits, loss and
the probe's layer norms are compared in f32 at atol 2e-5, rtol 1e-4: the two
frameworks round rsqrt, exp and the matmul sums differently by an ulp or so,
and a few layers add those up.
"""
import dataclasses

import pytest

pytest.importorskip("torch").set_num_threads(1)  # xdist workers share the cores: no thread pool each

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.config import ModelConfig
from repro.configs import ARCHS
from repro.models import attention as jattn
from repro.models import build_model
from repro.train import make_loss_fn

import repro_torch.config as tconfig
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.convert import lora_from_numpy, params_from_numpy, to_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import build_model as t_build_model
from repro_torch.models.layers import apply_rope, layer_norm, rms_norm
from repro_torch.train import make_loss_fn as t_make_loss_fn
from repro_torch.utils import tree as ttree
from torch_jax_refs import release_jax_programs  # noqa: F401

TINY = ModelConfig(
    name="tiny-lm", family="dense", num_layers=2, d_model=32, num_heads=2,
    num_kv_heads=2, d_ff=64, vocab_size=256, head_dim=16, rope="full",
    norm="rmsnorm", mlp="swiglu", dtype="float32", lora_rank=2, max_seq_len=64,
)
# every other knob of the dense branch: GQA, layer norm, GELU, qk-norm,
# parallel residual, 2d RoPE, soft-cap, untied head
KNOBS = dataclasses.replace(
    TINY, name="tiny-knobs", num_heads=4, num_kv_heads=2, head_dim=8, norm="layernorm",
    mlp="gelu", qk_norm=True, parallel_residual=True, rope="2d", logit_soft_cap=30.0,
    qkv_bias=True, attention_window=5,
)
CASES = {
    "tiny-lm": (TINY, 12),
    "tiny-knobs": (KNOBS, 12),
    # the reduced config keeps the 64-token window: 80 tokens exercise it
    "qwen2-0.5b-reduced": (ARCHS["qwen2-0.5b"].reduced(), 80),
}
ATOL, RTOL = 2e-5, 1e-4


def torch_config(cfg):
    return tconfig.ModelConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def _models(cfg, seed=0):
    model = build_model(cfg)
    params = jax.tree.map(np.asarray, model.init_params(jax.random.PRNGKey(seed)))
    lora = jax.tree.map(np.asarray, model.init_lora(jax.random.PRNGKey(seed + 1)))
    rng = np.random.default_rng(seed)
    lora = jax.tree.map(  # non-zero b, so the LoRA branch contributes
        lambda x: (x + 0.05 * rng.standard_normal(x.shape)).astype(np.float32), lora
    )
    t_model = t_build_model(torch_config(cfg))
    t_params = params_from_numpy(params, t_model.cfg, "cpu")
    t_lora = lora_from_numpy(lora, "cpu")
    return model, params, lora, t_model, t_params, t_lora


def _batch(cfg, seq_len, seed=1, batch=3):
    rng = np.random.default_rng(seed)
    return {
        "tokens": rng.integers(0, cfg.vocab_size, (batch, seq_len)).astype(np.int32),
        "label_token": rng.integers(0, cfg.vocab_size, (batch,)).astype(np.int32),
    }


def _t(batch):
    return {k: torch.as_tensor(v).to(torch.int64) for k, v in batch.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_logits_and_loss_match(case):
    cfg, seq_len = CASES[case]
    model, params, lora, t_model, t_params, t_lora = _models(cfg)
    batch = _batch(cfg, seq_len)
    logits, _ = model.forward(params, lora, batch)
    with torch.no_grad():
        t_logits, aux = t_model.forward(t_params, t_lora, _t(batch))
        t_loss = t_make_loss_fn(t_model)(t_params, t_lora, _t(batch))
    assert float(aux) == 0.0
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(logits), atol=ATOL, rtol=RTOL)
    loss = make_loss_fn(model)(params, lora, batch)
    np.testing.assert_allclose(float(t_loss), float(loss), atol=ATOL, rtol=RTOL)
    lm = {"tokens": batch["tokens"]}  # no label token: next-token LM loss
    np.testing.assert_allclose(
        float(t_make_loss_fn(t_model)(t_params, t_lora, _t(lm))),
        float(make_loss_fn(model)(params, lora, lm)), atol=ATOL, rtol=RTOL,
    )


@pytest.mark.parametrize("case", ["tiny-lm", "qwen2-0.5b-reduced"])
def test_probe_layer_norms_match(case):
    cfg, seq_len = CASES[case]
    model, params, lora, t_model, t_params, t_lora = _models(cfg)
    batch = _batch(cfg, seq_len)
    noise = 0.01 * np.random.default_rng(2).standard_normal((3, seq_len, cfg.d_model))
    noise = noise.astype(np.float32)
    _, _, norms = model.forward_probe(params, lora, batch, jnp.asarray(noise))
    with torch.no_grad():
        _, _, t_norms = t_model.forward_probe(t_params, t_lora, _t(batch), torch.from_numpy(noise))
    assert t_norms.shape == (cfg.num_layers, 3)
    np.testing.assert_allclose(t_norms.numpy(), np.asarray(norms), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize(
    "causal,window,S",
    [(True, None, 40), (True, 24, 40), (False, None, 32), (True, 8, 48)],
)
def test_blockwise_attention_matches(causal, window, S):
    """Block sizes below S take the online-softmax, windowed and padded paths."""
    rng = np.random.default_rng(S)
    q = rng.standard_normal((2, S, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, S, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, S, 2, 8)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_block=16, kv_block=16)
    ref = jattn.blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    out = tattn.blockwise_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    full = tattn.full_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                causal=causal, window=window)
    np.testing.assert_allclose(out.numpy(), full.numpy(), atol=1e-5, rtol=1e-5)


def test_layers_match():
    from repro.models import layers as jl

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    pos = np.arange(7)[None]
    tx = torch.from_numpy(x)
    for mode in ("full", "2d", "none"):
        np.testing.assert_allclose(
            apply_rope(tx, torch.from_numpy(pos), theta=1e6, mode=mode).numpy(),
            np.asarray(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=1e6, mode=mode)),
            atol=1e-6, rtol=1e-6,
        )
    np.testing.assert_allclose(rms_norm(tx, torch.from_numpy(w)).numpy(),
                               np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w))), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(
        layer_norm(tx, torch.from_numpy(w), torch.from_numpy(b)).numpy(),
        np.asarray(jl.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))), atol=1e-6, rtol=1e-5,
    )


def test_registry_and_tree_utils():
    """The port's qwen2-0.5b config and its reduction equal the JAX package's,
    and the tree helpers count elements and bytes by each leaf's dtype."""
    for full in (True, False):
        ref = ARCHS["qwen2-0.5b"] if full else ARCHS["qwen2-0.5b"].reduced()
        port = T_ARCHS["qwen2-0.5b"] if full else T_ARCHS["qwen2-0.5b"].reduced()
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    tree = {"b": {"x": torch.zeros(3, 4, dtype=torch.bfloat16)}, "a": torch.ones(5)}
    assert ttree.tree_size(tree) == 17
    assert ttree.tree_bytes(tree) == 3 * 4 * 2 + 5 * 4
    assert [p for p, _ in ttree.tree_items(tree)] == ["a", "b/x"]
    doubled = ttree.tree_scale(ttree.tree_add(tree, tree), 0.5)
    assert ttree.tree_map_with_path_str(lambda p, x: p, doubled) == {"a": "a", "b": {"x": "b/x"}}
    for x, y in zip(ttree.tree_leaves(doubled), ttree.tree_leaves(tree)):
        assert torch.equal(x, y) and x.dtype == y.dtype
    assert all(float(z.abs().sum()) == 0 for z in ttree.tree_leaves(ttree.tree_zeros_like(tree)))


def test_convert_round_trip_keeps_bf16_bits():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((4, 6)), jnp.bfloat16)
    cfg = torch_config(dataclasses.replace(TINY, dtype="bfloat16"))
    t = params_from_numpy({"w": np.asarray(x)}, cfg, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_numpy({"w": t})["w"], np.asarray(x, np.float32))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_and_supports_match_jax(arch):
    """``input_specs`` (meta tensors, the stand-in for
    ``jax.ShapeDtypeStruct``) and ``supports`` of every registry name over
    the four input shapes: JAX's shapes, dtypes and answers."""
    from repro.configs import INPUT_SHAPES as J_SHAPES
    from repro_torch.configs import INPUT_SHAPES

    assert sorted(INPUT_SHAPES) == sorted(J_SHAPES)
    jm, tm = build_model(ARCHS[arch]), t_build_model(T_ARCHS[arch])
    for name, shape in INPUT_SHAPES.items():
        js = J_SHAPES[name]
        assert dataclasses.asdict(shape) == dataclasses.asdict(js)
        assert tm.supports(shape) == jm.supports(js), name
        got, want = tm.input_specs(shape), jm.input_specs(js)
        assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in got.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}, name
        assert all(v.device.type == "meta" for v in got.values())
