"""The port's Mamba2 family (``repro_torch.models.ssm``/``ssm_model``, the
ssm LoRA trees, the runner and ``ServeEngine`` on it) against the JAX
package's.

The world is ``repro.configs.ARCHS["mamba2-1.3b"].reduced()``: 2 layers, d
128, 8 heads of 32, state 16, chunk 32, conv width 4, vocab 512, f32, LoRA
rank 4 on in_proj/out_proj. Params come from the JAX init and LoRA adapters
get a non-zero ``b`` (so every adapter moves the outputs), carried into the
port through ``repro_torch.convert``; tokens are made from a seed with
numpy and handed to both packages.

Tolerances: logits, layer norms and caches in f32 at atol 2e-5, rtol 1e-4,
the model tests' tolerance (the frameworks round exp, rsqrt, softplus and
the einsums' sums differently by an ulp or so, and two layers add those
up). The runner keeps the ROADMAP gate: the same curriculum orders and GAL
layers, losses within rel 1e-4 / abs 1e-5, identical comm-byte integers, a
global LoRA within atol 5e-5 / rtol 1e-4. Greedy token streams must be
equal.

The bf16 cases (the same world with ``dtype="bfloat16"``, JAX's bf16 params
carried through ``convert``) run the JAX side op by op (``jax.disable_jit``):
each of its bf16 ops then rounds as the port's eager ops do, where under jit
XLA fuses them and keeps f32 between (2-6 bf16 ulps of a row's largest
logit apart). They hold the port within ``BF16_ULPS`` bf16 ulps (2^-8) of
each row's largest |value|: a mixer's output 1, logits and conv buffers 2,
the f32 state 6; measured at most 0.02, 1.3, 0 and 2.5. Leaving out any one
of the model-dtype roundings that JAX makes (``xh * dtf``, ``silu(conv)``,
the gated RMSNorm's input ``y * silu(z)``) moves them to at least 2.05,
2.4 and 12.6.
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
from repro.data import dirichlet_partition, make_keyword_task
from repro.federated import make_runner
from repro.kernels import ssd_chunk as jsc
from repro.lora import gal_mask_tree as j_gal_mask
from repro.lora import gather_adapter_slots as j_gather
from repro.lora import lora_num_logical_layers as j_num_layers
from repro.lora import neuron_mask_tree as j_neuron_mask
from repro.lora import rank_mask_tree as j_rank_mask
from repro.lora import stack_adapter_trees as j_stack
from repro.models import build_model
from repro.models import ssm as jssm
from repro.serve import Request as JRequest
from repro.serve import SamplingParams as JSamplingParams
from repro.serve import ServeEngine as JServeEngine
from repro.train import make_loss_fn

import repro_torch.config as tconfig
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.convert import lora_from_numpy, params_from_numpy, to_numpy
from repro_torch.federated import make_runner as t_make_runner
from repro_torch.kernels import ops as tops
from repro_torch.lora import (
    gal_mask_tree,
    gather_adapter_slots,
    lora_num_logical_layers,
    neuron_mask_tree,
    rank_mask_tree,
    stack_adapter_trees,
)
from repro_torch.models import build_model as t_build_model
from repro_torch.models import ssm as tssm
from repro_torch.serve import ReferenceEngine, Request, SamplingParams, ServeEngine
from repro_torch.train import make_loss_fn as t_make_loss_fn
from repro_torch.utils.tree import tree_items, tree_leaves
from torch_jax_refs import release_jax_programs  # noqa: F401

ATOL, RTOL = 2e-5, 1e-4
BF16_ULPS = {"block": 1, "logits": 2, "conv": 2, "state": 6}
CFG = ARCHS["mamba2-1.3b"].reduced()
CFG_BF16 = dataclasses.replace(CFG, dtype="bfloat16")
FL = FibecFedConfig(
    num_devices=4, devices_per_round=2, rounds=4, batch_size=4,
    learning_rate=5e-3, fim_warmup_epochs=1, gal_fraction=0.5, sparse_ratio=0.5,
)


def torch_config(cfg):
    """The same architecture as the port's config dataclasses."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["ssm"] = tconfig.SSMConfig(**dataclasses.asdict(cfg.ssm)) if cfg.ssm is not None else None
    return tconfig.ModelConfig(**kw)


def _world(cfg):
    model = build_model(cfg)
    rng = jax.random.PRNGKey(0)
    params = jax.tree.map(np.asarray, model.init_params(rng))
    nrng = np.random.default_rng(0)
    adapters = [
        jax.tree.map(lambda x: (np.asarray(x) + 0.05 * nrng.standard_normal(x.shape)).astype(np.float32),
                     model.init_lora(jax.random.fold_in(rng, i)))
        for i in range(3)
    ]
    t_model = t_build_model(torch_config(cfg))
    t_params = params_from_numpy(params, t_model.cfg, "cpu")
    t_adapters = [lora_from_numpy(a, "cpu") for a in adapters]
    return model, params, adapters, t_model, t_params, t_adapters


@pytest.fixture(scope="module")
def world():
    return _world(CFG)


@pytest.fixture(scope="module")
def world_bf16():
    return _world(CFG_BF16)


def _dtype_world(request, dtype):
    return request.getfixturevalue("world_bf16" if dtype == "bfloat16" else "world")


def _tokens(n, S, seed=1):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (n, S)).astype(np.int32)


def _close(t, j, what, dtype="float32", kind="logits"):
    """f32: within ATOL/RTOL; bf16: within ``BF16_ULPS[kind]`` bf16 ulps of
    each row's (last axis's) largest |value|."""
    got, want = t.detach().to(torch.float32).numpy(), np.asarray(j, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL, err_msg=what)
        return
    assert got.shape == want.shape, what
    err = np.abs(got - want) / (2.0 ** -8 * np.abs(want).max(-1, keepdims=True))
    err = np.where(got == want, 0.0, err)  # rows that are all 0 on both sides
    assert float(err.max()) <= BF16_ULPS[kind], f"{what}: {float(err.max()):.3f} bf16 ulps of a row's largest |value|"


def test_config_dims_and_init_follow_jax():
    """The registry's mamba2-1.3b is the JAX package's; ``ssm_dims`` agree;
    the seeded torch init draws every leaf at JAX's shape and dtype (bf16
    beside f32 A_log/D/dt_bias), with JAX's deterministic leaves equal (A
    to an ulp) and dt in its log-uniform range."""
    assert torch_config(ARCHS["mamba2-1.3b"]) == T_ARCHS["mamba2-1.3b"]
    full = T_ARCHS["mamba2-1.3b"]
    assert tssm.ssm_dims(full) == jssm.ssm_dims(ARCHS["mamba2-1.3b"]) == dict(
        d_inner=4096, nheads=64, conv_ch=4352, in_dim=8512)
    for cfg in (CFG, CFG_BF16):
        jp = jax.eval_shape(lambda k, cfg=cfg: build_model(cfg).init_params(k), jax.random.PRNGKey(0))
        tm = t_build_model(torch_config(cfg))
        tp = tm.init_params(torch.Generator().manual_seed(0), "cpu")
        want = {p: (tuple(s.shape), str(s.dtype)) for p, s in tree_items(jax.tree.map(lambda s: s, jp))}
        got = {p: (tuple(t.shape), str(t.dtype).replace("torch.", "")) for p, t in tree_items(tp)}
        assert got == want
        real = build_model(cfg).init_params(jax.random.PRNGKey(0))["layers"]
        for name in ("D", "gate_norm_w", "norm_w"):
            np.testing.assert_array_equal(to_numpy(tp["layers"][name]), np.asarray(real[name], np.float32))
        # the two linspaces round 1..16 apart by an ulp
        np.testing.assert_allclose(to_numpy(tp["layers"]["A_log"]), np.asarray(real["A_log"]), rtol=1e-6, atol=0)
        dt = torch.nn.functional.softplus(tp["layers"]["dt_bias"])
        assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and float(dt.max()) <= 0.1 * (1 + 1e-5)


def test_convert_keeps_the_f32_leaves_of_a_bf16_model():
    cfg = CFG_BF16
    params = jax.tree.map(np.asarray, build_model(cfg).init_params(jax.random.PRNGKey(0)))
    tp = params_from_numpy(params, torch_config(cfg), "cpu")
    for name, leaf in tp["layers"].items():
        assert leaf.dtype == (torch.float32 if name in ("A_log", "D", "dt_bias") else torch.bfloat16), name
        np.testing.assert_array_equal(to_numpy(leaf), np.asarray(params["layers"][name], np.float32))


def test_softplus_is_jax_formula():
    x = torch.tensor([-30.0, -1.0, 0.0, 1.0, 19.5, 20.5, 40.0])
    np.testing.assert_allclose(tssm.softplus(x).numpy(), np.asarray(jax.nn.softplus(jnp.asarray(x.numpy()))),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("S,dtype", [(12, "float32"), (32, "float32"), (40, "float32"), (12, "bfloat16"),
                                     (32, "bfloat16"), (40, "bfloat16")],
                         ids=["12", "32", "40", "bf16-12", "bf16-32", "bf16-40"])
def test_mamba2_block_matches_jax(request, S, dtype):
    """One mixer (layer 1's slice, its LoRA) on a sequence shorter than a
    chunk, exactly one chunk and a padded second chunk; in bf16 against
    JAX's ops run one by one."""
    model, params, adapters, t_model, t_params, t_adapters = _dtype_world(request, dtype)
    h = np.random.default_rng(S).standard_normal((2, S, CFG.d_model)).astype(np.float32)
    p = {k: v[1] for k, v in params["layers"].items()}
    lo = {t: {n: x[1] for n, x in ab.items()} for t, ab in adapters[0]["layers"].items()}
    with jax.disable_jit(dtype == "bfloat16"):
        want = jssm.mamba2_block(jnp.asarray(h, dtype), p, model.cfg, lo, 2.0)
    tp = {k: v[1] for k, v in t_params["layers"].items()}
    tlo = {t: {n: x[1] for n, x in ab.items()} for t, ab in t_adapters[0]["layers"].items()}
    got = tssm.mamba2_block(torch.as_tensor(h).to(getattr(torch, dtype)), tp, t_model.cfg, tlo, 2.0)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, "block", dtype, "block")


@pytest.mark.parametrize("noise", [False, True])
def test_forward_probe_and_loss_match_jax(world, noise):
    model, params, adapters, t_model, t_params, t_adapters = world
    toks = _tokens(3, 40)
    eps = np.random.default_rng(4).standard_normal((3, 40, CFG.d_model)).astype(np.float32) * 0.1
    logits, _, norms = model.forward_probe(params, adapters[1], {"tokens": jnp.asarray(toks)},
                                           jnp.asarray(eps) if noise else None)
    batch = {"tokens": torch.as_tensor(toks).long()}
    with torch.no_grad():
        t_logits, aux, t_norms = t_model.forward_probe(t_params, t_adapters[1], batch,
                                                       torch.as_tensor(eps) if noise else None)
        t_loss = t_make_loss_fn(t_model)(t_params, t_adapters[1], batch)
    assert float(aux) == 0.0 and t_norms.shape == (CFG.num_layers, 3)
    _close(t_logits, logits, "logits")
    _close(t_norms, norms, "layer norms")
    loss = make_loss_fn(model)(params, adapters[1], {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(float(t_loss), float(loss), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("S", [3, 32, 45])
@pytest.mark.parametrize("per_slot", [False, True], ids=["one-adapter", "per-slot"])
def test_prefill_and_decode_match_jax(world, S, per_slot):
    """Prefill logits and cache (conv tail and f32 state), then three decode
    steps teacher-forced with JAX's greedy tokens, with one shared adapter
    and with each row's own gathered adapter; cache_len 16 is below the
    longer prompts (the state does not grow)."""
    _prefill_and_decode(world, S, per_slot, "float32")


@pytest.mark.parametrize("S", [3, 45])
@pytest.mark.parametrize("per_slot", [False, True], ids=["one-adapter", "per-slot"])
def test_prefill_and_decode_match_jax_bf16(world_bf16, S, per_slot):
    """The same in bf16 (bf16 conv buffers beside the f32 state), against
    JAX's ops run one by one."""
    with jax.disable_jit():
        _prefill_and_decode(world_bf16, S, per_slot, "bfloat16")


def _prefill_and_decode(world, S, per_slot, dtype):
    model, params, adapters, t_model, t_params, t_adapters = world
    toks = _tokens(3, S)
    if per_slot:
        ids = np.array([2, 0, 1], np.int32)
        lora = j_gather(CFG, j_stack([jax.tree.map(jnp.asarray, a) for a in adapters]), jnp.asarray(ids))
        t_lora = gather_adapter_slots(t_model.cfg, stack_adapter_trees(t_adapters), torch.as_tensor(ids).long())
        assert t_lora["layers"]["in_proj"]["a"].shape == (CFG.num_layers, 3, CFG.d_model, CFG.lora_rank)
    else:
        lora, t_lora = adapters[0], t_adapters[0]
    logits, cache, pos = model.prefill(params, lora, {"tokens": jnp.asarray(toks)}, 16)
    t_logits, t_cache, t_pos = t_model.prefill(t_params, t_lora, {"tokens": torch.as_tensor(toks).long()}, 16)
    assert t_pos == int(pos) == S
    assert t_logits.dtype == getattr(torch, dtype)
    _close(t_logits, logits, "prefill logits", dtype)
    for name in ("conv", "state"):
        assert t_cache[name].shape == cache[name].shape and str(t_cache[name].dtype)[6:] == str(cache[name].dtype)
        _close(t_cache[name], cache[name], f"prefill cache {name}", dtype, name)
    for step in range(3):
        tok = np.argmax(np.asarray(logits, np.float32)[:, -1], -1)[:, None].astype(np.int32)
        logits, cache = model.decode_step(params, lora, jnp.asarray(tok), cache, pos)
        t_logits, t_cache = t_model.decode_step(t_params, t_lora, torch.as_tensor(tok).long(), t_cache, t_pos)
        _close(t_logits, logits, f"decode step {step} logits", dtype)
    for name in ("conv", "state"):
        _close(t_cache[name], cache[name], f"decode cache {name}", dtype, name)


def test_prefill_of_a_short_prompt_pads_the_conv_tail(world):
    """A prompt shorter than the conv's W-1 taps keeps zeros before its
    start (the JAX slice would leave the tail short), so decoding after it
    equals the forward over the prompt and the new token."""
    model, params, adapters, t_model, t_params, t_adapters = world
    toks = _tokens(2, 2, seed=8)
    with torch.no_grad():
        logits, cache, S = t_model.prefill(t_params, t_adapters[0], {"tokens": torch.as_tensor(toks).long()}, 16)
        assert cache["conv"].shape[2] == CFG.ssm.conv_width - 1
        assert bool((cache["conv"][:, :, 0] == 0).all()) and bool((cache["conv"][:, :, 1:] != 0).all())
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        step, _ = t_model.decode_step(t_params, t_adapters[0], tok, cache, S)
        seq = torch.cat([torch.as_tensor(toks).long(), tok], 1)
        full, _ = t_model.forward(t_params, t_adapters[0], {"tokens": seq})
    torch.testing.assert_close(step[:, 0], full[:, -1], atol=ATOL, rtol=RTOL)


def test_lora_trees_and_masks_match_jax(world):
    """``init_lora``'s in_proj/out_proj shapes, the logical layer count, and
    the GAL, neuron, rank masks and the per-slot gather equal JAX's trees."""
    model, params, adapters, t_model, t_params, t_adapters = world
    t_lora = t_model.init_lora(torch.Generator().manual_seed(0), "cpu")
    want = {p: tuple(x.shape) for p, x in tree_items(jax.tree.map(np.asarray, adapters[0]))}
    assert {p: tuple(x.shape) for p, x in tree_items(t_lora)} == want
    assert set(t_lora["layers"]) == {"in_proj", "out_proj"}
    assert all(float(ab["b"].abs().max()) == 0.0 for ab in t_lora["layers"].values())
    assert lora_num_logical_layers(t_model.cfg) == j_num_layers(CFG) == CFG.num_layers
    rng = np.random.default_rng(3)
    gal = np.array([True, False])
    keep = {"layers": {t: (rng.random((CFG.num_layers, ab["b"].shape[-1])) < 0.5)
                       for t, ab in adapters[0]["layers"].items()}}
    pairs = [
        (gal_mask_tree(t_model.cfg, t_adapters[0], gal), j_gal_mask(CFG, adapters[0], gal)),
        (neuron_mask_tree(t_model.cfg, t_adapters[0], {"layers": {t: torch.as_tensor(k) for t, k in
                                                                  keep["layers"].items()}}),
         j_neuron_mask(CFG, adapters[0], jax.tree.map(jnp.asarray, keep))),
        (rank_mask_tree(t_adapters[0], 3), j_rank_mask(jax.tree.map(jnp.asarray, adapters[0]), 3)),
        (gather_adapter_slots(t_model.cfg, stack_adapter_trees(t_adapters), torch.tensor([1, 1, 0, 2])),
         j_gather(CFG, j_stack([jax.tree.map(jnp.asarray, a) for a in adapters]), jnp.asarray([1, 1, 0, 2]))),
    ]
    for got, want in pairs:
        got_items, want_items = dict(tree_items(to_numpy(got))), dict(tree_items(jax.tree.map(np.asarray, want)))
        assert sorted(got_items) == sorted(want_items)
        for path, w in want_items.items():
            np.testing.assert_array_equal(np.broadcast_to(got_items[path], w.shape), w, err_msg=path)


@pytest.fixture(scope="module")
def clients():
    task = make_keyword_task(n_samples=50, seq_len=12, vocab_size=256, seed=0)
    parts = dirichlet_partition(task.data["label"], FL.num_devices, 1.0, seed=0)
    return [{k: v[idx] for k, v in task.data.items() if k != "label"} for idx in parts]


def _rounds_match(ref, port):
    ref.init_phase()
    port.init_phase()
    for cr, cp in zip(ref.clients, port.clients):
        np.testing.assert_array_equal(cr.order, cp.order)
    np.testing.assert_array_equal(ref.gal_layers, port.gal_layers)
    for t in range(2):
        hr, hp = ref.run_round(t), port.run_round(t)
        assert hp["loss"] == pytest.approx(hr["loss"], rel=1e-4, abs=1e-5)
        assert hp["selected_batches"] == hr["selected_batches"]
        for tree_p, tree_r in [(port.global_lora, ref.global_lora)] + [
                (cp.lora, cr.lora) for cp, cr in zip(port.clients, ref.clients)]:
            for a, b in zip(tree_leaves(to_numpy(tree_p)), jax.tree.leaves(tree_r)):
                np.testing.assert_allclose(a, np.asarray(b, np.float32), atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("engine", ["loop", "vectorized"])
def test_runner_matches_jax_engine(world, clients, engine):
    """FibecFed/AdamW on the reduced mamba2 over 2 rounds, each port engine
    against the JAX engine of its name (the loop engine is the semantic
    spec): the ROADMAP gate, per-client LoRA included. The stacked engine's
    vmap over the clients finds a batching rule for every op of the SSM
    (none falls back to a loop over the clients, which would warn)."""
    model, params, adapters, t_model, t_params, t_adapters = world
    ref = make_runner("fibecfed", model, make_loss_fn(model), FL, clients, optimizer="adamw", engine=engine,
                      seed=7)
    port = t_make_runner("fibecfed", t_model, t_make_loss_fn(t_model), tconfig.FibecFedConfig(**dataclasses.asdict(FL)),
                         clients, optimizer="adamw", engine=engine, seed=7, device="cpu",
                         init_params=jax.tree.map(np.asarray, ref.params),
                         init_lora=jax.tree.map(np.asarray, ref._init_lora))
    assert port.engine == engine
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _rounds_match(ref, port)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    assert not [str(w.message) for w in caught if "batching rule" in str(w.message)]
    assert port.comm_bytes_per_round == ref.comm_bytes_per_round
    assert port.comm_upload_bytes_per_round == ref.comm_upload_bytes_per_round
    assert all(isinstance(b, int) for b in port.comm_bytes_per_round)


def _serve_pair(world, **kw):
    model, params, adapters, t_model, t_params, t_adapters = world
    n = kw.pop("n_adapters", 1)
    return (JServeEngine(model, params, adapters[0], adapters=adapters[1:n], **kw),
            ServeEngine(t_model, t_params, t_adapters[0], adapters=t_adapters[1:n], device="cpu", **kw))


def _drain(engine, request_cls, reqs):
    rids = [engine.submit(request_cls(**r)) for r in reqs]
    comps = {c.request_id: c for c in engine.drain()}
    return [comps[r] for r in rids]


def test_generate_matches_jax_and_reference(world):
    """generate(): greedy equal to JAX's, with and without EOS, and equal
    to the port's ReferenceEngine (sampled too)."""
    model, params, adapters, t_model, t_params, t_adapters = world
    jax_eng, port_eng = _serve_pair(world, cache_len=16, num_slots=2)
    batch = {"tokens": _tokens(2, 20)}
    eos = int(jax_eng.generate(batch, max_new_tokens=6).tokens[0, 2])
    for kw in ({}, {"eos_id": eos}):
        want = jax_eng.generate(batch, max_new_tokens=6, **kw)
        got = port_eng.generate(batch, max_new_tokens=6, **kw)
        np.testing.assert_array_equal(got.tokens, want.tokens)
        assert got.steps == want.steps
    ref = ReferenceEngine(t_model, t_params, t_adapters[0], cache_len=16, device="cpu")
    for kw in ({}, {"temperature": 0.8, "seed": 5}):
        np.testing.assert_array_equal(port_eng.generate(batch, max_new_tokens=6, **kw).tokens,
                                      ref.generate(batch, max_new_tokens=6, **kw).tokens)


def test_continuous_multi_adapter_streams_match_jax(world):
    """Six requests over three adapters through three slots, in two shape
    groups, the queued ones reusing freed slots: greedy streams equal JAX's
    token for token. The 40-token prompts are longer than cache_len 16 and
    keep their whole budgets (no clamp for ssm, JAX's rule); each stream
    equals a solo ReferenceEngine run of its request."""
    model, params, adapters, t_model, t_params, t_adapters = world
    long, short = _tokens(3, 40, seed=3), _tokens(3, 8, seed=4)
    reqs = [(long[0], 0, 10), (short[0], 1, 5), (long[1], 2, 12), (short[1], 0, 3), (long[2], 1, 7),
            (short[2], 2, 9)]
    jax_eng, port_eng = _serve_pair(world, cache_len=16, num_slots=3, max_new_cap=12, n_adapters=3)
    jc = _drain(jax_eng, JRequest, [dict(tokens=t, adapter_id=a, sampling=JSamplingParams(max_new_tokens=b))
                                    for t, a, b in reqs])
    tc = _drain(port_eng, Request, [dict(tokens=t, adapter_id=a, sampling=SamplingParams(max_new_tokens=b))
                                    for t, a, b in reqs])
    for j, t in zip(jc, tc):
        np.testing.assert_array_equal(t.tokens, j.tokens)
        assert (t.finish_reason, t.steps, t.adapter_id, t.prompt_len) == \
            (j.finish_reason, j.steps, j.adapter_id, j.prompt_len)
    assert [c.steps for c in tc] == [b for _, _, b in reqs]
    assert port_eng.stats["prefill_calls"] > 2  # freed slots were reused
    for (toks, a, b), c in zip(reqs, tc):
        solo = ReferenceEngine(t_model, t_params, t_adapters[a], cache_len=16, device="cpu")
        np.testing.assert_array_equal(c.tokens, solo.generate({"tokens": toks[None]}, max_new_tokens=b).tokens[0])


@pytest.mark.parametrize("heads", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk_intra_heads_matches_jax_kernel(heads, dtype):
    """``ops.ssd_chunk_intra(heads=h)``, b and c one row per h groups,
    against the JAX kernel (interpret mode) on b and c expanded to every
    group: f32 within 1e-5 of the largest |y| (the sums run in other
    orders; bf16 inputs are widened exactly)."""
    G, Q, hd, N = 8, 32, 16, 8
    rng = np.random.default_rng(heads)
    x = rng.standard_normal((G, Q, hd)).astype(np.float32)
    a = (-np.abs(rng.standard_normal((G, 1, Q))) * 0.1).astype(np.float32)
    b, c = (rng.standard_normal((G // heads, Q, N)).astype(np.float32) for _ in range(2))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jx, jb, jc = (jnp.asarray(t, jdt) for t in (x, b, c))
    want = jsc.ssd_chunk_intra_kernel(jx, jnp.asarray(a), jnp.repeat(jb, heads, 0), jnp.repeat(jc, heads, 0),
                                      interpret=True)

    def tt(j):
        return torch.from_numpy(np.asarray(j, np.float32)).to(getattr(torch, dtype))

    got = tops.ssd_chunk_intra(tt(jx), torch.as_tensor(a), tt(jb), tt(jc), heads=heads)
    assert got.dtype == torch.float32 and got.shape == (G, Q, hd)
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5 * scale, rtol=0)
    with pytest.raises(ValueError, match="heads"):
        tops.ssd_chunk_intra(tt(jx), torch.as_tensor(a), tt(jb)[:1], tt(jc)[:1], heads=heads)


def test_prefill_scan_takes_the_kernel_layout_on_cpu():
    """``ssd_chunked(kernel=True)`` is the plain path on CPU tensors, and
    ``ssd_intra``'s (batch, chunk, head) groups with shared b/c give the
    plain intra-chunk term (the layout the card's B9 launch reads)."""
    B, S, nh, hd, N, Q = 2, 64, 3, 8, 4, 32
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.standard_normal((B, S, nh, hd)), dtype=torch.float32)
    a = -torch.as_tensor(np.abs(rng.standard_normal((B, S, nh))), dtype=torch.float32) * 0.1
    b, c = (torch.as_tensor(rng.standard_normal((B, S, N)), dtype=torch.float32) for _ in range(2))
    before = tops.ssd_chunk_intra.launches
    y0, s0 = tssm.ssd_chunked(x, a, b, c, Q)
    y1, s1 = tssm.ssd_chunked(x, a, b, c, Q, kernel=True)
    assert torch.equal(y0, y1) and torch.equal(s0, s1)
    intra = tssm.ssd_intra(x, a.reshape(B, S // Q, Q, nh), b, c, Q)
    plain, _ = tssm.ssd_chunked(x.reshape(B * 2, Q, nh, hd), a.reshape(B * 2, Q, nh), b.reshape(B * 2, Q, N),
                                c.reshape(B * 2, Q, N), Q)  # one chunk each, no carried state: intra only
    torch.testing.assert_close(intra.reshape(B, S, nh, hd), plain.reshape(B, S, nh, hd), atol=1e-5, rtol=1e-5)
    assert tops.ssd_chunk_intra.launches == before


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_jax_arch_builds_in_the_port(arch):
    """Every name of the JAX registry is in the port's, with the same
    configuration, and builds there: its LoRA tree (drawn on the meta
    device) has JAX's leaves and shapes, its logical layers and LoRA group
    offsets are JAX's."""
    from repro.lora.lora import _group_offsets as j_group_offsets
    from repro_torch.lora.lora import _group_offsets

    cfg = T_ARCHS[arch]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ARCHS[arch])
    model = t_build_model(cfg)
    lora = model.init_lora(torch.Generator().manual_seed(0), "meta")
    want = jax.eval_shape(build_model(ARCHS[arch]).init_lora, jax.random.PRNGKey(0))
    assert {p: tuple(x.shape) for p, x in tree_items(lora)} == {p: tuple(x.shape) for p, x in tree_items(want)}
    assert lora_num_logical_layers(cfg) == j_num_layers(ARCHS[arch])
    assert _group_offsets(cfg) == j_group_offsets(ARCHS[arch])


def test_serve_launcher_runs_mamba2_on_cpu(capsys):
    from repro_torch.launch.serve import main

    res = main(["--arch", "mamba2-1.3b", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
                "--new-tokens", "3"])
    assert res.tokens.shape == (2, 3) and res.steps == 3
    assert "mamba2-1.3b: 3 steps x batch 2" in capsys.readouterr().out
