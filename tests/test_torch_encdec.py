"""The port's encoder-decoder family (``repro_torch.models.encdec``:
whisper-large-v3's bidirectional encoder and causal decoder with
cross-attention, its LoRA tree of two groups, the runner and
``ServeEngine`` on it) against the JAX package's ``repro.models.encdec``.

The world is ``ARCHS["whisper-large-v3"].reduced()``: 2 encoder and 2
decoder layers, d 128, 4 heads of 32, 16 frames, vocab 512, window 64, f32.
Params come from the JAX init through ``repro_torch.convert``, the adapters
get a non-zero ``b``, and tokens and frame embeddings are made from a seed
with numpy.

Tolerances: logits, the Le + Ld probe norms and the caches at atol 2e-5 /
rtol 1e-4 (the other families' files'); the runners at the slice gate
(losses rel 1e-4 / abs 1e-5, global LoRA atol 5e-5 / rtol 1e-4, identical
comm bytes, curriculum orders and GAL layers). Greedy token streams must be
equal.
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
from repro.lora import gal_mask_tree as j_gal_mask
from repro.lora import gather_adapter_slots as j_gather
from repro.lora import lora_layer_index_tree as j_layer_ids
from repro.lora import stack_adapter_trees as j_stack
from repro.models import build_model
from repro.models import encdec as jencdec
from repro.serve import Request as JRequest
from repro.serve import SamplingParams as JSamplingParams
from repro.serve import ServeEngine as JServeEngine
from repro.train import make_loss_fn

import repro_torch.config as tconfig
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.convert import lora_from_numpy, params_from_numpy, to_numpy
from repro_torch.federated import make_runner as t_make_runner
from repro_torch.lora import (
    gal_mask_tree,
    gather_adapter_slots,
    lora_layer_index_tree,
    lora_num_logical_layers,
    stack_adapter_trees,
)
from repro_torch.models import build_model as t_build_model
from repro_torch.models import encdec as tencdec
from repro_torch.serve import Request, SamplingParams, ServeEngine
from repro_torch.train import make_loss_fn as t_make_loss_fn
from repro_torch.utils.tree import tree_items, tree_leaves
from torch_jax_refs import release_jax_programs  # noqa: F401

ATOL, RTOL = 2e-5, 1e-4
CFG = ARCHS["whisper-large-v3"].reduced()
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
        for i in range(3)
    ]
    t_model = t_build_model(torch_config(CFG))
    return model, params, adapters, t_model, params_from_numpy(params, t_model.cfg, "cpu"), \
        [lora_from_numpy(a, "cpu") for a in adapters]


def _batch(n, S, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 512, (n, S)).astype(np.int32),
            "encoder_embeds": rng.standard_normal((n, CFG.encoder_seq_len, CFG.d_model)).astype(np.float32)}


def _t(batch):
    return {k: torch.as_tensor(v).long() if k == "tokens" else torch.as_tensor(v) for k, v in batch.items()}


def _close(t, j, what):
    np.testing.assert_allclose(t.detach().to(torch.float32).numpy(), np.asarray(j, np.float32), atol=ATOL,
                               rtol=RTOL, err_msg=what)


def test_config_and_init_follow_jax():
    """The registry's whisper-large-v3 is the JAX package's, and the seeded
    torch init draws every leaf (both stacks, the cross weights and their
    biases) at JAX's shape and dtype."""
    assert torch_config(ARCHS["whisper-large-v3"]) == T_ARCHS["whisper-large-v3"]
    jp = jax.eval_shape(build_model(CFG).init_params, jax.random.PRNGKey(0))
    tp = t_build_model(torch_config(CFG)).init_params(torch.Generator().manual_seed(0), "cpu")
    assert {p: (tuple(t.shape), str(t.dtype)[6:]) for p, t in tree_items(tp)} == \
        {p: (tuple(s.shape), str(s.dtype)) for p, s in tree_items(jp)}
    assert {"cwq", "cwo", "cbq", "cbk", "cbv"} <= set(tp["decoder"]["layers"])


def test_encode_forward_and_probe_match_jax(world):
    """The bidirectional encoder's output, the logits, the Le + Ld probe
    norms under the GAL probe's noise on the decoder's embeddings, and the
    loss."""
    model, params, adapters, t_model, t_params, t_adapters = world
    batch = _batch(2, 24)
    scale = CFG.lora_alpha / CFG.lora_rank
    enc = jencdec.encode(params, adapters[1], jnp.asarray(batch["encoder_embeds"]), CFG, scale)
    eps = np.random.default_rng(4).standard_normal((2, 24, CFG.d_model)).astype(np.float32) * 0.1
    jb = jax.tree.map(jnp.asarray, batch)
    logits, _, norms = model.forward_probe(params, adapters[1], jb, jnp.asarray(eps))
    tb = _t(batch)
    with torch.no_grad():
        t_enc = tencdec.encode(t_params, t_adapters[1], tb["encoder_embeds"], t_model.cfg, scale)
        t_logits, aux, t_norms = t_model.forward_probe(t_params, t_adapters[1], tb, torch.as_tensor(eps))
        t_loss = t_make_loss_fn(t_model)(t_params, t_adapters[1], tb)
    assert float(aux) == 0.0 and t_norms.shape == (CFG.encoder_layers + CFG.num_layers, 2)
    _close(t_enc, enc, "encoder output")
    _close(t_logits, logits, "logits")
    _close(t_norms, norms, "layer norms")
    np.testing.assert_allclose(float(t_loss), float(make_loss_fn(model)(params, adapters[1], jb)), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("S", [20, 45])
def test_prefill_and_decode_match_jax(world, S):
    """Prefill's last logits, the self cache (the last ``min(32, S)``
    positions, ring layout under the window) and the cross cache; then
    three decode steps with per-slot positions and per-slot adapters,
    teacher-forced with JAX's greedy tokens. The cross cache is the same
    after the steps."""
    model, params, adapters, t_model, t_params, t_adapters = world
    ids = np.array([2, 0, 1], np.int32)
    lora = j_gather(CFG, j_stack([jax.tree.map(jnp.asarray, a) for a in adapters]), jnp.asarray(ids))
    t_lora = gather_adapter_slots(t_model.cfg, stack_adapter_trees(t_adapters), torch.as_tensor(ids).long())
    batch = _batch(3, S, seed=S)
    logits, cache, pos = model.prefill(params, lora, jax.tree.map(jnp.asarray, batch), 32)
    with torch.no_grad():
        t_logits, t_cache, t_pos = t_model.prefill(t_params, t_lora, _t(batch), 32)
    assert t_pos == int(pos) == S
    _close(t_logits, logits, "prefill logits")
    assert sorted(t_cache) == sorted(cache) == ["cross_k", "cross_v", "k", "v"]
    for k in cache:
        assert tuple(t_cache[k].shape) == cache[k].shape, k
        _close(t_cache[k], cache[k], f"prefill cache {k}")
    cross = {k: t_cache[k].clone() for k in ("cross_k", "cross_v")}
    position = np.array([S, S - 5, S - 2], np.int32)
    for step in range(3):
        tok = np.argmax(np.asarray(logits, np.float32)[:, -1], -1)[:, None].astype(np.int32)
        logits, cache = model.decode_step(params, lora, jnp.asarray(tok), cache, jnp.asarray(position))
        with torch.no_grad():
            t_logits, t_cache = t_model.decode_step(t_params, t_lora, torch.as_tensor(tok).long(), t_cache,
                                                    torch.as_tensor(position).long())
        _close(t_logits, logits, f"decode step {step}")
        position = position + 1
    for k in cache:
        _close(t_cache[k], cache[k], f"decode cache {k}")
    for k, v in cross.items():
        assert torch.equal(t_cache[k], v), k


def test_decode_after_prefill_equals_the_forward(world):
    """Decoding after a prefill gives the forward's logits over the prompt
    and the new tokens (the cache holds the whole prompt)."""
    _, _, _, t_model, t_params, t_adapters = world
    batch = _t(_batch(2, 12, seed=7))
    with torch.no_grad():
        logits, cache, S = t_model.prefill(t_params, t_adapters[2], batch, 24)
        seq = batch["tokens"]
        for _ in range(3):
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            seq = torch.cat([seq, tok], 1)
            logits, cache = t_model.decode_step(t_params, t_adapters[2], tok, cache, S)
            S += 1
        full, _ = t_model.forward(t_params, t_adapters[2], {**batch, "tokens": seq})
    torch.testing.assert_close(logits[:, 0], full[:, -1], atol=ATOL, rtol=RTOL)


def test_lora_tree_and_masks_match_jax(world):
    """``init_lora``: the encoder's wq..wo (Le) and the decoder's wq..wo and
    cwq..cwo (Ld); Le + Ld logical layers, the decoder's from Le on; GAL
    masks and the per-slot gather of both groups equal JAX's trees."""
    model, params, adapters, t_model, t_params, t_adapters = world
    t_lora = t_model.init_lora(torch.Generator().manual_seed(0), "cpu")
    assert {p: tuple(x.shape) for p, x in tree_items(t_lora)} == {p: tuple(x.shape) for p, x in tree_items(adapters[0])}
    assert sorted(t_lora["decoder"]) == ["cwk", "cwo", "cwq", "cwv", "wk", "wo", "wq", "wv"]
    assert lora_num_logical_layers(t_model.cfg) == CFG.encoder_layers + CFG.num_layers == 4
    ids, j_ids = to_numpy(lora_layer_index_tree(t_model.cfg, t_lora)), j_layer_ids(CFG, adapters[0])
    for path, w in tree_items(jax.tree.map(np.asarray, j_ids)):
        np.testing.assert_array_equal(dict(tree_items(ids))[path], w, err_msg=path)
    pairs = [(gal_mask_tree(t_model.cfg, t_adapters[0], gal), j_gal_mask(CFG, adapters[0], gal))
             for gal in (np.array([1, 0, 0, 1], bool), np.array([0, 1, 1, 0], bool))]
    pairs.append((gather_adapter_slots(t_model.cfg, stack_adapter_trees(t_adapters), torch.tensor([1, 1, 0, 2])),
                  j_gather(CFG, j_stack([jax.tree.map(jnp.asarray, a) for a in adapters]), jnp.asarray([1, 1, 0, 2]))))
    for got, want in pairs:
        got_items, want_items = dict(tree_items(to_numpy(got))), dict(tree_items(jax.tree.map(np.asarray, want)))
        assert sorted(got_items) == sorted(want_items)
        for path, w in want_items.items():
            np.testing.assert_array_equal(np.broadcast_to(got_items[path], w.shape), w, err_msg=path)


@pytest.fixture(scope="module")
def clients():
    """4 clients of 4, 8, 12 and 8 samples, each sample with its own frame
    embeddings."""
    task = make_keyword_task(n_samples=32, seq_len=12, vocab_size=256, seed=0)
    frames = np.random.default_rng(2).standard_normal((32, CFG.encoder_seq_len, CFG.d_model)).astype(np.float32)
    data = {"tokens": task.data["tokens"], "encoder_embeds": frames}
    edges = np.cumsum([0, 4, 8, 12, 8])
    return [{k: v[a:b] for k, v in data.items()} for a, b in zip(edges[:-1], edges[1:])]


@pytest.fixture(scope="module")
def jax_loop_run(world, clients):
    model = world[0]
    ref = make_runner("fibecfed", model, make_loss_fn(model), FL, clients, optimizer="adamw", engine="loop", seed=7)
    ref.init_phase()
    rounds = [(ref.run_round(t), jax.tree.map(np.asarray, ref.global_lora)) for t in range(2)]
    return ref, rounds


@pytest.mark.parametrize("engine", ["loop", "vectorized"])
def test_runner_matches_jax_loop_engine(world, clients, jax_loop_run, engine):
    """FibecFed/AdamW on the encoder-decoder (4 logical layers, the encoder's
    first), 2 rounds, each port engine against the JAX loop engine: the same
    curriculum orders and GAL layers, losses, global LoRA and comm bytes.
    The frame embeddings ride the stacked client data; the vectorized
    engine's vmap finds a batching rule for every op."""
    ref, rounds = jax_loop_run
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
            assert port.gal_layers.shape == (CFG.encoder_layers + CFG.num_layers,)
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
    assert all(isinstance(b, int) for b in port.comm_bytes_per_round)


def test_serve_streams_match_jax(world):
    """ServeEngine: six requests over three adapters through three slots,
    each with its own frame embeddings (``extras``), prompts of 20 and 40
    tokens (one longer than the 32-token cache: its budget clamped to none,
    as in JAX), the queued ones reusing freed slots; greedy streams equal
    JAX's token for token."""
    model, params, adapters, t_model, t_params, t_adapters = world
    long, short = _batch(3, 40, seed=3), _batch(3, 20, seed=4)
    reqs = [(short, 0, 0, 10), (short, 1, 1, 5), (long, 0, 2, 6), (short, 2, 0, 12), (long, 1, 1, 4),
            (short, 0, 2, 7)]
    kw = dict(cache_len=32, num_slots=3, max_new_cap=12)

    def run(engine, req_cls, sp_cls):
        rids = [engine.submit(req_cls(tokens=b["tokens"][i], adapter_id=a, sampling=sp_cls(max_new_tokens=n),
                                      extras={"encoder_embeds": b["encoder_embeds"][i]}))
                for b, i, a, n in reqs]
        comps = {c.request_id: c for c in engine.drain()}
        return [comps[r] for r in rids]

    jc = run(JServeEngine(model, params, adapters[0], adapters=adapters[1:], **kw), JRequest, JSamplingParams)
    eng = ServeEngine(t_model, t_params, t_adapters[0], adapters=t_adapters[1:], device="cpu", **kw)
    tc = run(eng, Request, SamplingParams)
    for j, t in zip(jc, tc):
        np.testing.assert_array_equal(t.tokens, j.tokens)
        assert (t.finish_reason, t.steps, t.adapter_id) == (j.finish_reason, j.steps, j.adapter_id)
    assert [c.steps for c in tc] == [10, 5, 0, 12, 0, 7] and eng.stats["prefill_calls"] > 2
    # the cross cache rides the slot axis with the self cache
    template = t_model.init_cache(1, 32, "cpu")
    assert {k: tuple(v.shape) for k, v in eng._state["cache"].items()} == \
        {k: (v.shape[0], 3) + tuple(v.shape[2:]) for k, v in template.items()}
