"""The rest of the dense family in the port agrees with the JAX package's:
qwen3-0.6b (qk-norm, tied embeddings), stablelm-3b (LayerNorm, parallel
residual, half RoPE, head_dim 80 at full width) and chatglm3-6b (half RoPE,
QKV bias, 2 KV heads), with the prefix embeddings (C7) and the
parallel-residual prefill (C8) repaired, the public names the port lacked,
and the plain flash attention at head_dim 80.

Each config runs at ``cfg.reduced()`` (stablelm also at
``reduced(head_dim=80)``) with the JAX init's params (through
``repro_torch.convert``) and a non-zero LoRA ``b``; inputs are made from a
seed with numpy. Logits, probe norms and KV caches are held at
``test_torch_model.py``'s atol 2e-5 / rtol 1e-4 (the two frameworks round
rsqrt, exp and the matmul sums an ulp or so apart). A loop FibecFed round
is held at the slice tolerances: loss rel 1e-4 / abs 1e-5, global LoRA
atol 5e-5 / rtol 1e-4, identical comm bytes.
"""
import dataclasses

import pytest

pytest.importorskip("torch").set_num_threads(1)  # xdist workers share the cores: no thread pool each

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import core as jcore
from repro import data as jdata
from repro import lora as jlora
from repro import train as jtrain
from repro import utils as jutils
from repro.config import FibecFedConfig, ModelConfig
from repro.configs import ARCHS
from repro.core import gal as jgal
from repro.data import dirichlet_partition, make_keyword_task
from repro.federated import make_runner
from repro.kernels import ops as jops
from repro.models import build_model
from repro.train.losses import make_logits_loss

import repro_torch.config as tconfig
from repro_torch import core as tcore
from repro_torch import data as tdata
from repro_torch import lora as tlora
from repro_torch import train as ttrain
from repro_torch import utils as tutils
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.convert import lora_from_numpy, params_from_numpy, to_numpy
from repro_torch.core import gal as tgal
from repro_torch.federated import make_runner as t_make_runner
from repro_torch.kernels import ops as tops
from repro_torch.models import build_model as t_build_model
from repro_torch.utils.tree import tree_leaves
from torch_jax_refs import release_jax_programs  # noqa: F401

ATOL, RTOL = 2e-5, 1e-4
NEW = ("qwen3-0.6b", "stablelm-3b", "chatglm3-6b")
CASES = {
    "qwen3-0.6b": ARCHS["qwen3-0.6b"].reduced(),
    "stablelm-3b": ARCHS["stablelm-3b"].reduced(),
    "stablelm-3b-d80": ARCHS["stablelm-3b"].reduced(head_dim=80),
    "chatglm3-6b": ARCHS["chatglm3-6b"].reduced(),
}
# 80 tokens: past the reduced configs' 64-token window
SEQ = 80


def torch_config(cfg):
    return tconfig.ModelConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def _models(cfg, seed=0):
    model = build_model(cfg)
    params = jax.tree.map(np.asarray, model.init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    lora = jax.tree.map(  # non-zero b, so the LoRA branch contributes
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape)).astype(np.float32),
        model.init_lora(jax.random.PRNGKey(seed + 1)))
    t_model = t_build_model(torch_config(cfg))
    return model, params, lora, t_model, params_from_numpy(params, t_model.cfg, "cpu"), lora_from_numpy(lora, "cpu")


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return (request.param, CASES[request.param]) + _models(CASES[request.param])


def _tokens(cfg, S, seed=1, batch=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, S)).astype(np.int32)


def _prefix(cfg, P=5, seed=3, batch=2):
    return (0.02 * np.random.default_rng(seed).standard_normal((batch, P, cfg.d_model))).astype(np.float32)


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol, rtol=RTOL)


def test_configs_equal_the_jax_registry():
    for name in NEW:
        for port, ref in ((T_ARCHS[name], ARCHS[name]), (T_ARCHS[name].reduced(), ARCHS[name].reduced()),
                          (T_ARCHS[name].reduced(head_dim=80), ARCHS[name].reduced(head_dim=80))):
            assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert T_ARCHS["stablelm-3b"].resolved_head_dim == 80 and T_ARCHS["stablelm-3b"].parallel_residual


def test_params_convert_at_each_config(case):
    """Every leaf (LayerNorm biases, qk-norm weights, QKV biases) arrives
    with the JAX tree's path, shape and values."""
    _, cfg, model, params, _, _, t_params, _ = case
    want = {}
    jutils.tree_map_with_path_str(lambda p, x: want.setdefault(p, np.asarray(x)), params)
    got = {}
    tutils.tree_map_with_path_str(lambda p, x: got.setdefault(p, x), t_params)
    assert sorted(got) == sorted(want)
    for path, x in got.items():
        assert tuple(x.shape) == want[path].shape, path
        np.testing.assert_array_equal(x.numpy(), want[path])
    names = set(got)
    assert ("layers/attn_norm_b" in names) == (cfg.norm == "layernorm")
    assert ("layers/q_norm_w" in names) == cfg.qk_norm
    assert ("layers/bq" in names) == cfg.qkv_bias


def test_forward_and_probe_match(case):
    _, cfg, model, params, lora, t_model, t_params, t_lora = case
    tokens = _tokens(cfg, SEQ)
    noise = (0.01 * np.random.default_rng(2).standard_normal((2, SEQ, cfg.d_model))).astype(np.float32)
    logits, _ = model.forward(params, lora, {"tokens": tokens})
    _, _, norms = model.forward_probe(params, lora, {"tokens": tokens}, jnp.asarray(noise))
    tb = {"tokens": torch.as_tensor(tokens).long()}
    with torch.no_grad():
        t_logits, aux = t_model.forward(t_params, t_lora, tb)
        _, _, t_norms = t_model.forward_probe(t_params, t_lora, tb, torch.from_numpy(noise))
    assert float(aux) == 0.0
    _close(t_logits, logits)
    _close(t_norms, norms)


def test_prefill_and_decode_match_the_forward(case):
    """The port's prefill (last logits, KV cache) and two decode steps. For
    the sequential-residual configs they equal JAX's prefill and decode;
    for every config (stablelm's parallel residual too: C8) they equal
    JAX's forward over the prompt and over prompt + tokens."""
    _, cfg, model, params, lora, t_model, t_params, t_lora = case
    S, cache_len = 40, 48
    tokens = _tokens(cfg, S)
    with torch.no_grad():
        t_last, t_cache, t_S = t_model.prefill(t_params, t_lora, {"tokens": torch.as_tensor(tokens).long()},
                                               cache_len)
    assert t_S == S
    full, _ = model.forward(params, lora, {"tokens": tokens})
    _close(t_last[:, 0], np.asarray(full)[:, -1])
    if not cfg.parallel_residual:
        last, cache, _ = model.prefill(params, lora, {"tokens": tokens}, cache_len)
        _close(t_last, last)
        for name in ("k", "v"):
            _close(t_cache[name], cache[name])
    seq = tokens
    for step in range(2):
        tok = np.asarray(np.argmax(np.asarray(full)[:, -1], -1), np.int32)[:, None]
        seq = np.concatenate([seq, tok], 1)
        with torch.no_grad():
            t_logits, t_cache = t_model.decode_step(t_params, t_lora, torch.as_tensor(tok).long(), t_cache, S + step)
        full, _ = model.forward(params, lora, {"tokens": seq})
        _close(t_logits[:, 0], np.asarray(full)[:, -1])


def test_prefix_embeds_reach_forward_probe_and_prefill(case):
    """C7: ``prefix_embeds`` (B, P, D) is prepended to the token embeddings
    in the forward, the probe (its noise over P + S positions) and the
    prefill (S counts P), as in the JAX package."""
    _, cfg, model, params, lora, t_model, t_params, t_lora = case
    tokens, prefix = _tokens(cfg, 20), _prefix(cfg)
    S_total = 25
    noise = (0.01 * np.random.default_rng(4).standard_normal((2, S_total, cfg.d_model))).astype(np.float32)
    batch = {"tokens": tokens, "prefix_embeds": jnp.asarray(prefix)}
    tb = {"tokens": torch.as_tensor(tokens).long(), "prefix_embeds": torch.from_numpy(prefix)}
    logits, _ = model.forward(params, lora, batch)
    _, _, norms = model.forward_probe(params, lora, batch, jnp.asarray(noise))
    with torch.no_grad():
        t_logits, _ = t_model.forward(t_params, t_lora, tb)
        _, _, t_norms = t_model.forward_probe(t_params, t_lora, tb, torch.from_numpy(noise))
        t_last, _, t_S = t_model.prefill(t_params, t_lora, tb, 32)
    assert tuple(t_logits.shape) == (2, S_total, cfg.vocab_size) and t_S == S_total
    _close(t_logits, logits)
    _close(t_norms, norms)
    _close(t_last[:, 0], np.asarray(logits)[:, -1])
    if not cfg.parallel_residual:
        last, _, S = model.prefill(params, lora, batch, 32)
        assert int(S) == t_S
        _close(t_last, last)


def test_empty_prefix_and_no_prefix_give_the_same_bits(case):
    """A batch without ``prefix_embeds`` runs the embeddings as they were;
    an empty prefix (P = 0) gives the same bits."""
    _, cfg, _, _, _, t_model, t_params, t_lora = case
    tokens = torch.as_tensor(_tokens(cfg, 16)).long()
    with torch.no_grad():
        plain, _ = t_model.forward(t_params, t_lora, {"tokens": tokens})
        empty, _ = t_model.forward(t_params, t_lora, {"tokens": tokens,
                                                      "prefix_embeds": torch.zeros(2, 0, cfg.d_model)})
    assert torch.equal(plain, empty)


def test_parallel_residual_prefill_is_the_forwards_network():
    """C8 on stablelm-3b: the port's prefill under ``parallel_residual``
    equals JAX's forward at the last position, and prefill then decode the
    forward over prompt + token. JAX's own prefill adds the attention and
    MLP outputs in turn, another network: it differs from its forward."""
    cfg = CASES["stablelm-3b"]
    model, params, lora, t_model, t_params, t_lora = _models(cfg)
    tokens = _tokens(cfg, 24)
    full, _ = model.forward(params, lora, {"tokens": tokens})
    full = np.asarray(full)
    with torch.no_grad():
        t_last, t_cache, S = t_model.prefill(t_params, t_lora, {"tokens": torch.as_tensor(tokens).long()}, 32)
    _close(t_last[:, 0], full[:, -1])
    tok = np.argmax(full[:, -1], -1).astype(np.int32)[:, None]
    with torch.no_grad():
        t_next, _ = t_model.decode_step(t_params, t_lora, torch.as_tensor(tok).long(), t_cache, S)
    full2, _ = model.forward(params, lora, {"tokens": np.concatenate([tokens, tok], 1)})
    _close(t_next[:, 0], np.asarray(full2)[:, -1])
    j_last, _, _ = model.prefill(params, lora, {"tokens": tokens}, 32)
    gap = float(np.max(np.abs(np.asarray(j_last)[:, 0] - full[:, -1])))
    assert gap > 1e3 * ATOL, gap  # the JAX package's fault (ROADMAP.md §C, C8)


FL = FibecFedConfig(
    num_devices=4, devices_per_round=2, rounds=4, batch_size=4,
    learning_rate=5e-3, fim_warmup_epochs=1, gal_fraction=0.5, sparse_ratio=0.5,
)


@pytest.mark.parametrize("name", NEW)
def test_loop_fibecfed_round_matches_jax(name):
    """One loop FibecFed/AdamW round at the reduced width: the same
    curriculum orders and GAL layers, the round loss, the global LoRA and
    the comm bytes."""
    cfg = CASES[name]
    model = build_model(cfg)
    task = make_keyword_task(n_samples=40, seq_len=12, vocab_size=cfg.vocab_size, seed=0)
    parts = dirichlet_partition(task.data["label"], FL.num_devices, 1.0, seed=0)
    clients = [{k: v[idx] for k, v in task.data.items() if k != "label"} for idx in parts]
    t_model = t_build_model(torch_config(cfg))
    ref = make_runner("fibecfed", model, jtrain.make_loss_fn(model), FL, clients, optimizer="adamw",
                      engine="loop", seed=7)
    port = t_make_runner(
        "fibecfed", t_model, ttrain.make_loss_fn(t_model), tconfig.FibecFedConfig(**dataclasses.asdict(FL)),
        clients, optimizer="adamw", engine="loop", seed=7, device="cpu",
        init_params=jax.tree.map(np.asarray, ref.params), init_lora=jax.tree.map(np.asarray, ref._init_lora),
    )
    ref.init_phase()
    port.init_phase()
    for cr, cp in zip(ref.clients, port.clients):
        np.testing.assert_array_equal(cr.order, cp.order)
    np.testing.assert_array_equal(ref.gal_layers, port.gal_layers)
    hr, hp = ref.run_round(0), port.run_round(0)
    assert hp["loss"] == pytest.approx(hr["loss"], rel=1e-4, abs=1e-5)
    for a, b in zip(tree_leaves(to_numpy(port.global_lora)), jax.tree.leaves(ref.global_lora)):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), atol=5e-5, rtol=1e-4)
    assert port.comm_bytes_per_round == ref.comm_bytes_per_round
    assert all(isinstance(b, int) for b in port.comm_bytes_per_round)


# --- the public names the port lacked, against their JAX twins ---

TINY = ModelConfig(
    name="tiny-lm", family="dense", num_layers=2, d_model=32, num_heads=2,
    num_kv_heads=2, d_ff=64, vocab_size=256, head_dim=16, rope="full",
    norm="rmsnorm", mlp="swiglu", dtype="float32", lora_rank=2, max_seq_len=64,
)


@pytest.fixture(scope="module")
def tiny():
    model, params, lora, t_model, t_params, t_lora = _models(TINY)
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, 256, (4, 12)).astype(np.int32),
             "label_token": rng.integers(0, 256, (4,)).astype(np.int32)}
    t_batch = {k: torch.as_tensor(v).long() for k, v in batch.items()}
    return model, params, lora, t_model, t_params, t_lora, batch, t_batch


def test_losses_match_jax(tiny):
    model, params, lora, t_model, t_params, t_lora, batch, t_batch = tiny
    rng = np.random.default_rng(6)
    logits, labels = rng.standard_normal((5, 7)).astype(np.float32), rng.integers(0, 7, (5,)).astype(np.int32)
    assert float(ttrain.cls_loss(torch.from_numpy(logits), torch.from_numpy(labels).long())) == pytest.approx(
        float(jtrain.cls_loss(jnp.asarray(logits), jnp.asarray(labels))), rel=1e-6)
    loss, t_loss = jtrain.make_label_token_loss(model), ttrain.make_label_token_loss(t_model)
    assert float(t_loss(t_params, t_lora, t_batch)) == pytest.approx(float(loss(params, lora, batch)),
                                                                     rel=RTOL, abs=ATOL)
    lm, t_lm = jtrain.make_loss_fn(model), ttrain.make_loss_fn(t_model)
    for fn, t_fn, b in ((loss, t_loss, batch), (lm, t_lm, {"tokens": batch["tokens"]})):
        tb = {k: t_batch[k] for k in b}
        per = jtrain.per_sample_losses(fn, params, lora, b)
        with torch.no_grad():
            t_per = ttrain.per_sample_losses(t_fn, t_params, t_lora, tb)
        assert tuple(t_per.shape) == (4,)
        _close(t_per, per)
        mask = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
        want = jtrain.masked_mean_loss(fn, params, lora, b, jnp.asarray(mask))
        with torch.no_grad():
            got = ttrain.masked_mean_loss(t_fn, t_params, t_lora, tb, torch.from_numpy(mask))
        assert float(got) == pytest.approx(float(want), rel=RTOL, abs=ATOL)


@pytest.mark.parametrize("name", ["tiny-lm", "qwen3-0.6b", "mamba2-1.3b"])
def test_lora_helpers_match_jax(name):
    cfg = TINY if name == "tiny-lm" else ARCHS[name].reduced()
    t_cfg = T_ARCHS[name].reduced() if name != "tiny-lm" else torch_config(TINY)
    lora = build_model(cfg).init_lora(jax.random.PRNGKey(0))
    t_lora = t_build_model(t_cfg).init_lora(torch.Generator().manual_seed(0), "cpu")
    assert tlora.lora_param_count(t_lora) == jlora.lora_param_count(lora)
    for z in tree_leaves(tlora.zeros_like_lora(t_lora)):
        assert z.dtype == torch.float32 and not bool(z.any())
    ids, t_ids = jlora.lora_layer_index_tree(cfg, lora), tlora.lora_layer_index_tree(t_cfg, t_lora)
    want = jax.tree.leaves(ids)
    got = tree_leaves(t_ids)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_embedding_grad_and_lossless_rank_fraction_match_jax(tiny):
    model, params, lora, t_model, t_params, t_lora, batch, t_batch = tiny
    noise_shape = (4, 12, TINY.d_model)

    def j_loss(noise):
        logits, _, _ = model.forward_probe(params, lora, {"tokens": batch["tokens"]}, noise)
        return make_logits_loss(model.cfg)(logits, batch)

    def t_loss(noise):
        logits, _, _ = t_model.forward_probe(t_params, t_lora, {"tokens": t_batch["tokens"]}, noise)
        return ttrain.make_logits_loss(t_model.cfg)(logits, t_batch)

    _close(tgal.embedding_grad(t_loss, noise_shape), jgal.embedding_grad(j_loss, noise_shape))
    # the lossless fraction with JAX's draws (its starting vector, then its
    # Lipschitz probes), where no eigengap lies near the 4·L margin
    key = jax.random.PRNGKey(5)
    shapes = [tuple(x.shape) for x in jax.tree.leaves(lora)]
    draws = [jax.random.normal(jax.random.fold_in(key, j), s, jnp.float32) for j, s in enumerate(shapes)]
    k_lip = jax.random.fold_in(key, 777)
    for i in range(4):
        k = jax.random.fold_in(k_lip, i)
        draws += [jax.random.normal(jax.random.fold_in(k, j), s, jnp.float32) for j, s in enumerate(shapes)]
    loss, t_lossfn = jax.jit(jtrain.make_label_token_loss(model)), ttrain.make_label_token_loss(t_model)

    def replay():
        it = iter([np.array(d) for d in draws])
        return lambda j, shape: torch.from_numpy(next(it).copy())

    res = tgal.lossless_criterion(t_lossfn, t_params, t_lora, t_batch, replay(), iters=6)
    gaps, margin = np.diff(res["eigs"]), 4.0 * res["lipschitz"]
    assert np.all(np.abs(gaps - margin) > 1e-2 * margin)
    want = jgal.lossless_rank_fraction(loss, params, lora, batch, key, iters=6)
    assert tgal.lossless_rank_fraction(t_lossfn, t_params, t_lora, t_batch, replay(), iters=6) == want


def test_core_exports_match_jax():
    """``repro_torch.core`` gives every name of ``repro.core`` but the JAX
    compile cache, and the JAX package's four engines."""
    jax_only = {"clear_compile_caches"}
    names = {n for n in dir(jcore) if not n.startswith("_") and callable(getattr(jcore, n, None))}
    names = {n for n in names if getattr(getattr(jcore, n), "__module__", "").startswith("repro.core")}
    assert names - jax_only <= set(dir(tcore)), sorted(names - jax_only - set(dir(tcore)))
    assert set(tcore.ENGINES) <= set(jcore.ENGINES) and tcore.ENGINES == ("vectorized", "loop", "sharded", "async")
    assert tcore.FibecFed is not None and tcore.ClientState is not None


def test_tree_utils_match_jax():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32), "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    t_tree = {"a": torch.from_numpy(tree["a"]), "b": {"c": torch.from_numpy(tree["b"]["c"])}}
    assert float(tutils.tree_l2_norm(t_tree)) == pytest.approx(float(jutils.tree_l2_norm(tree)), rel=1e-6)
    assert tutils.tree_size(t_tree) == jutils.tree_size(tree)
    assert tutils.tree_bytes(t_tree) == jutils.tree_bytes(tree)
    for got, want in ((tutils.tree_add(t_tree, t_tree), jutils.tree_add(tree, tree)),
                      (tutils.tree_scale(t_tree, 0.5), jutils.tree_scale(tree, 0.5)),
                      (tutils.tree_zeros_like(t_tree), jutils.tree_zeros_like(tree))):
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    paths = tutils.tree_map_with_path_str(lambda p, x: p, t_tree)
    assert paths == jutils.tree_map_with_path_str(lambda p, x: p, tree)


@pytest.mark.parametrize("n,bs,drop", [(10, 4, False), (10, 4, True), (8, 4, True), (3, 4, True)])
def test_make_batches_matches_jax(n, bs, drop):
    got, want = tdata.make_batches(n, bs, drop_remainder=drop), jdata.make_batches(n, bs, drop_remainder=drop)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_batch_iterator_matches_jax():
    rng = np.random.default_rng(1)
    data = {"tokens": rng.integers(0, 9, (23, 4)), "label": np.arange(23)}
    got = list(tdata.batch_iterator(data, 5, seed=3, epochs=2))
    want = list(jdata.batch_iterator(data, 5, seed=3, epochs=2))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        for k in data:
            np.testing.assert_array_equal(g[k], w[k])


# --- B8's plain version at stablelm-3b's head_dim 80 ---

@pytest.mark.parametrize("S,window,dtype", [(256, None, "float32"), (256, 64, "float32"), (200, None, "float32"),
                                            (256, 64, "bfloat16")])
def test_flash_attention_head_dim_80_matches_jax(S, window, dtype):
    """``ops.flash_attention`` at D 80 (its plain version on the CPU)
    against ``repro.kernels.ops.flash_attention`` run as the JAX tests run
    it (interpret mode; a ragged S takes its dense oracle): within 1e-5 of
    the largest |v|, bf16 one ulp beyond."""
    rng = np.random.default_rng(S)
    arrs = [rng.standard_normal((2, S, 4, 80), dtype=np.float32) for _ in range(3)]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrs)
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch, dtype)) for x in (jq, jk, jv))
    want = np.asarray(jops.flash_attention(jq, jk, jv, causal=True, window=window), np.float32)
    got = tops.flash_attention(tq, tk, tv, causal=True, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    g = got.to(torch.float32).numpy()
    allowed = 1e-5 * float(np.abs(np.asarray(jv, np.float32)).max())
    if dtype == "bfloat16":
        _, e = np.frexp(np.maximum(np.abs(g), np.abs(want)))
        allowed = allowed + np.ldexp(1.0, e - 8)
    assert np.all(np.abs(g - want) <= allowed)
