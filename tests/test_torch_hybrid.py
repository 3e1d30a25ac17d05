"""The port's zamba2 hybrid (``repro_torch.models.hybrid``: Mamba2 layers
and one shared attention block, its LoRA tree with an unstacked group, the
runner and ``ServeEngine`` on it) against the JAX package's
``repro.models.hybrid``.

Two worlds of ``ARCHS["zamba2-7b"].reduced()`` (d 128, 4 heads of 32, the
SSM's state 16 and head_dim 32 in chunks of 32, f32): 2 layers with period
2 (one application of the shared block, no remainder) and 5 layers with
period 2 (two applications, one Mamba layer after the last); the forward
also runs a 1-layer world, where the shared block never runs. Params come
from the JAX init through ``repro_torch.convert``, LoRA adapters get a
non-zero ``b``, and tokens are made from a seed with numpy.

Tolerances: logits, the L + 1 probe norms and the caches at atol 2e-5 /
rtol 1e-4 (``test_torch_ssm.py``'s) in the worlds of up to 3 blocks, atol
4e-5 in the 5-layer world, whose 7 blocks (5 Mamba layers, 2 applications
of the shared block) add up more rounding (the two frameworks round exp,
rsqrt, softplus and the einsums' sums an ulp or so apart; measured at most
2.6e-5 there); the runners at the slice gate (losses
rel 1e-4 / abs 1e-5, global LoRA atol 5e-5 / rtol 1e-4, identical comm
bytes, curriculum orders and GAL layers). Greedy token streams must be
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
from repro.lora import lora_num_logical_layers as j_num_layers
from repro.lora import neuron_mask_tree as j_neuron_mask
from repro.lora import stack_adapter_trees as j_stack
from repro.models import build_model
from repro.models import hybrid as jhybrid
from repro.serve import Request as JRequest
from repro.serve import SamplingParams as JSamplingParams
from repro.serve import ServeEngine as JServeEngine
from repro.train import make_loss_fn

import repro_torch.config as tconfig
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.convert import lora_from_numpy, params_from_numpy, to_numpy
from repro_torch.kernels import masked_update, tree_launch
from repro_torch.federated import make_runner as t_make_runner
from repro_torch.lora import (
    gal_mask_tree,
    gather_adapter_slots,
    lora_layer_index_tree,
    lora_num_logical_layers,
    neuron_mask_tree,
    stack_adapter_trees,
)
from repro_torch.models import build_model as t_build_model
from repro_torch.models import hybrid as thybrid
from repro_torch.serve import Request, SamplingParams, ServeEngine
from repro_torch.train import make_loss_fn as t_make_loss_fn
from repro_torch.utils.tree import tree_items, tree_leaves
from torch_jax_refs import release_jax_programs  # noqa: F401

ATOL, RTOL = 2e-5, 1e-4
ATOL_DEEP = 4e-5  # the 5-layer world
WORLDS = {"2-layer": ARCHS["zamba2-7b"].reduced(), "5-layer": ARCHS["zamba2-7b"].reduced(num_layers=5)}
FL = FibecFedConfig(num_devices=4, devices_per_round=2, rounds=4, batch_size=4, learning_rate=5e-3,
                    fim_warmup_epochs=1, gal_fraction=0.5, sparse_ratio=0.5)


def torch_config(cfg):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["ssm"] = tconfig.SSMConfig(**dataclasses.asdict(cfg.ssm))
    return tconfig.ModelConfig(**kw)


def _world(cfg):
    model = build_model(cfg)
    rng = jax.random.PRNGKey(0)
    params = jax.tree.map(np.asarray, jax.jit(model.init_params)(rng))  # one compile, not one per op
    nrng = np.random.default_rng(0)
    adapters = [
        jax.tree.map(lambda x: (np.asarray(x) + 0.05 * nrng.standard_normal(x.shape)).astype(np.float32),
                     model.init_lora(jax.random.fold_in(rng, i)))
        for i in range(3)
    ]
    t_model = t_build_model(torch_config(cfg))
    return model, params, adapters, t_model, params_from_numpy(params, t_model.cfg, "cpu"), \
        [lora_from_numpy(a, "cpu") for a in adapters]


@pytest.fixture(scope="module")
def worlds():
    return {name: _world(cfg) for name, cfg in WORLDS.items()}


def _tokens(n, S, seed=1):
    return np.random.default_rng(seed).integers(0, 512, (n, S)).astype(np.int32)


def _close(t, j, what, atol=ATOL):
    np.testing.assert_allclose(t.detach().to(torch.float32).numpy(), np.asarray(j, np.float32), atol=atol,
                               rtol=RTOL, err_msg=what)


def _atol(cfg):
    return ATOL_DEEP if cfg.num_layers > 2 else ATOL


def test_config_init_and_convert_follow_jax(worlds):
    """The registry's zamba2-7b is the JAX package's (n_apps 13, a remainder
    of 3); the seeded torch init draws every leaf at JAX's shape and dtype;
    ``convert`` keeps the Mamba layers' A_log, D and dt_bias f32 beside the
    bf16 rest of a bf16 model."""
    assert torch_config(ARCHS["zamba2-7b"]) == T_ARCHS["zamba2-7b"]
    assert thybrid._split_counts(T_ARCHS["zamba2-7b"]) == jhybrid._split_counts(ARCHS["zamba2-7b"]) == (13, 6, 3)
    for name, cfg in WORLDS.items():
        jp = jax.eval_shape(lambda k, cfg=cfg: build_model(cfg).init_params(k), jax.random.PRNGKey(0))
        tp = t_build_model(torch_config(cfg)).init_params(torch.Generator().manual_seed(0), "cpu")
        assert {p: (tuple(t.shape), str(t.dtype)[6:]) for p, t in tree_items(tp)} == \
            {p: (tuple(s.shape), str(s.dtype)) for p, s in tree_items(jp)}
    cfg = dataclasses.replace(WORLDS["2-layer"], dtype="bfloat16")
    params = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)), worlds["2-layer"][1])
    tp = params_from_numpy(params, torch_config(cfg), "cpu")
    for path, leaf in tree_items(tp):
        assert leaf.dtype == (torch.float32 if path.rsplit("/", 1)[-1] in ("A_log", "D", "dt_bias")
                              else torch.bfloat16), path


@pytest.mark.parametrize("name", ["1-layer", "2-layer", "5-layer"])
def test_forward_and_probe_norms_match_jax(worlds, name):
    """Logits and the L + 1 probe norms (the Mamba layers', then the shared
    block's after its last application; the final normed state where it
    never runs) with the GAL probe's noise, and the loss."""
    if name == "1-layer":
        world = _world(ARCHS["zamba2-7b"].reduced(num_layers=1))
    else:
        world = worlds[name]
    model, params, adapters, t_model, t_params, t_adapters = world
    cfg = model.cfg
    toks = _tokens(2, 40)
    eps = np.random.default_rng(4).standard_normal((2, 40, cfg.d_model)).astype(np.float32) * 0.1
    logits, _, norms = model.forward_probe(params, adapters[1], {"tokens": jnp.asarray(toks)}, jnp.asarray(eps))
    batch = {"tokens": torch.as_tensor(toks).long()}
    with torch.no_grad():
        t_logits, aux, t_norms = t_model.forward_probe(t_params, t_adapters[1], batch, torch.as_tensor(eps))
        t_loss = t_make_loss_fn(t_model)(t_params, t_adapters[1], batch)
    assert float(aux) == 0.0 and t_norms.shape == (cfg.num_layers + 1, 2)
    _close(t_logits, logits, "logits", _atol(cfg))
    _close(t_norms, norms, "layer norms", _atol(cfg))
    loss = make_loss_fn(model)(params, adapters[1], {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(float(t_loss), float(loss), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", sorted(WORLDS))
@pytest.mark.parametrize("S", [20, 45])
def test_prefill_cache_and_decode_match_jax(worlds, name, S):
    """Prefill's last logits and every cache leaf (each application's KV,
    the last ``min(cache_len, S)`` positions then zeros; conv tails; f32
    states) at cache_len 32, above and below the prompt; then three
    decode steps teacher-forced with JAX's greedy tokens, one shared
    adapter."""
    model, params, adapters, t_model, t_params, t_adapters = worlds[name]
    atol = _atol(model.cfg)
    toks = _tokens(3, S, seed=S)
    logits, cache, pos = model.prefill(params, adapters[0], {"tokens": jnp.asarray(toks)}, 32)
    with torch.no_grad():
        t_logits, t_cache, t_pos = t_model.prefill(t_params, t_adapters[0], {"tokens": torch.as_tensor(toks).long()},
                                                   32)
    assert t_pos == int(pos) == S
    _close(t_logits, logits, "prefill logits", atol)
    assert sorted(t_cache) == sorted(cache)
    for k in cache:
        assert tuple(t_cache[k].shape) == cache[k].shape and str(t_cache[k].dtype)[6:] == str(cache[k].dtype), k
        _close(t_cache[k], cache[k], f"prefill cache {k}", atol)
    for step in range(3):
        tok = np.argmax(np.asarray(logits, np.float32)[:, -1], -1)[:, None].astype(np.int32)
        logits, cache = model.decode_step(params, adapters[0], jnp.asarray(tok), cache, pos)
        with torch.no_grad():
            t_logits, t_cache = t_model.decode_step(t_params, t_adapters[0], torch.as_tensor(tok).long(), t_cache,
                                                    t_pos)
        _close(t_logits, logits, f"decode step {step}", atol)
        pos, t_pos = pos + 1, t_pos + 1
    for k in cache:
        _close(t_cache[k], cache[k], f"decode cache {k}", atol)


def test_decode_after_prefill_equals_the_forward(worlds):
    """Decoding after a prefill gives the forward's logits over prompt and
    new tokens, in the port and in JAX alike (the cache holds the whole
    prompt)."""
    model, params, adapters, t_model, t_params, t_adapters = worlds["5-layer"]
    toks = _tokens(2, 12, seed=7)
    with torch.no_grad():
        logits, cache, S = t_model.prefill(t_params, t_adapters[2], {"tokens": torch.as_tensor(toks).long()}, 24)
        seq = torch.as_tensor(toks).long()
        for _ in range(3):
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            seq = torch.cat([seq, tok], 1)
            logits, cache = t_model.decode_step(t_params, t_adapters[2], tok, cache, S)
            S += 1
        full, _ = t_model.forward(t_params, t_adapters[2], {"tokens": seq})
    torch.testing.assert_close(logits[:, 0], full[:, -1], atol=ATOL, rtol=RTOL)
    want, _ = model.forward(params, adapters[2], {"tokens": jnp.asarray(seq.numpy().astype(np.int32))})
    _close(full, want, "forward over prompt and decoded tokens", ATOL_DEEP)


def test_per_slot_positions_and_adapters_match_jax(worlds):
    """Rows at their own depths with their own adapters (the shared block's
    unstacked LoRA gathered per slot): three decode steps against JAX."""
    model, params, adapters, t_model, t_params, t_adapters = worlds["5-layer"]
    ids = np.array([2, 0, 1], np.int32)
    lora = j_gather(WORLDS["5-layer"], j_stack([jax.tree.map(jnp.asarray, a) for a in adapters]), jnp.asarray(ids))
    t_lora = gather_adapter_slots(t_model.cfg, stack_adapter_trees(t_adapters), torch.as_tensor(ids).long())
    assert t_lora["shared"]["wq"]["a"].shape == (3, 128, 4)
    assert t_lora["mamba"]["in_proj"]["a"].shape[:2] == (5, 3)
    toks = _tokens(3, 16, seed=9)
    logits, cache, _ = model.prefill(params, lora, {"tokens": jnp.asarray(toks)}, 24)
    with torch.no_grad():
        t_logits, t_cache, _ = t_model.prefill(t_params, t_lora, {"tokens": torch.as_tensor(toks).long()}, 24)
    _close(t_logits, logits, "prefill logits", ATOL_DEEP)
    position = np.array([16, 11, 14], np.int32)
    for step in range(3):
        tok = np.argmax(np.asarray(logits, np.float32)[:, -1], -1)[:, None].astype(np.int32)
        logits, cache = model.decode_step(params, lora, jnp.asarray(tok), cache, jnp.asarray(position))
        with torch.no_grad():
            t_logits, t_cache = t_model.decode_step(t_params, t_lora, torch.as_tensor(tok).long(), t_cache,
                                                    torch.as_tensor(position).long())
        _close(t_logits, logits, f"decode step {step}", ATOL_DEEP)
        position = position + 1
    for k in cache:
        _close(t_cache[k], cache[k], f"cache {k}", ATOL_DEEP)


def test_lora_tree_and_masks_match_jax(worlds):
    """``init_lora``: the Mamba layers' stacked in_proj/out_proj and the
    shared block's unstacked wq/wk/wv/wo; L + 1 logical layers, the shared
    group's layer id L; GAL and neuron masks and the per-slot gather equal
    JAX's trees."""
    model, params, adapters, t_model, t_params, t_adapters = worlds["5-layer"]
    cfg = WORLDS["5-layer"]
    t_lora = t_model.init_lora(torch.Generator().manual_seed(0), "cpu")
    assert {p: tuple(x.shape) for p, x in tree_items(t_lora)} == {p: tuple(x.shape) for p, x in tree_items(adapters[0])}
    assert lora_num_logical_layers(t_model.cfg) == j_num_layers(cfg) == cfg.num_layers + 1
    ids = lora_layer_index_tree(t_model.cfg, t_lora)
    assert int(ids["shared"]["wq"]["a"]) == cfg.num_layers and ids["mamba"]["in_proj"]["b"].shape == (5, 1, 1)
    rng = np.random.default_rng(3)
    keep = {g: {t: rng.random(ab["b"].shape[:-2] + ab["b"].shape[-1:]) < 0.5 for t, ab in grp.items()}
            for g, grp in adapters[0].items()}
    pairs = [(gal_mask_tree(t_model.cfg, t_adapters[0], gal), j_gal_mask(cfg, adapters[0], gal))
             for gal in (np.array([1, 0, 1, 0, 0, 1], bool), np.array([0, 1, 0, 0, 1, 0], bool))]
    pairs.append((neuron_mask_tree(t_model.cfg, t_adapters[0],
                                   {g: {t: torch.as_tensor(k) for t, k in grp.items()} for g, grp in keep.items()}),
                  j_neuron_mask(cfg, adapters[0], jax.tree.map(jnp.asarray, keep))))
    pairs.append((gather_adapter_slots(t_model.cfg, stack_adapter_trees(t_adapters), torch.tensor([1, 1, 0, 2])),
                  j_gather(cfg, j_stack([jax.tree.map(jnp.asarray, a) for a in adapters]), jnp.asarray([1, 1, 0, 2]))))
    for got, want in pairs:
        got_items, want_items = dict(tree_items(to_numpy(got))), dict(tree_items(jax.tree.map(np.asarray, want)))
        assert sorted(got_items) == sorted(want_items)
        for path, w in want_items.items():
            np.testing.assert_array_equal(np.broadcast_to(got_items[path], w.shape), w, err_msg=path)


@pytest.mark.parametrize("clients", [1, 4])
def test_b1_plan_takes_the_stacked_and_unstacked_groups(clients):
    """B1's launch plan over zamba2-7b's full-width LoRA tree, per client and
    stacked over 4 clients: the Mamba layers' (L, d, r) leaves and the
    shared block's (d, r) ones in one launch, each leaf's blocks following
    the previous leaf's, each of its client rows cut into chunks that never
    straddle two rows."""
    cfg = T_ARCHS["zamba2-7b"]
    lora = t_build_model(cfg).init_lora(torch.Generator().manual_seed(0), "meta")
    leaves = tree_leaves(lora)
    assert sorted({x.dim() for x in leaves}) == [2, 3]  # unstacked and stacked
    sizes = tuple(clients * x.numel() for x in leaves)
    chunk = masked_update.ADAMW_CHUNK
    (launch,) = tree_launch.plan(sizes, clients, chunk)
    assert launch.leaves == tuple(range(len(leaves)))
    blocks = [clients * -(-(n // clients) // chunk) for n in sizes]
    assert list(launch.block0) == list(np.cumsum([0] + blocks[:-1])) and launch.grid == sum(blocks)


@pytest.fixture(scope="module")
def clients():
    """4 clients of 4, 8, 12 and 8 samples: padded steps on the vectorized
    engine, one batch shape for the JAX side to compile (the MoE tests hold
    a ragged batch, where the sample mask matters)."""
    task = make_keyword_task(n_samples=32, seq_len=12, vocab_size=256, seed=0)
    edges = np.cumsum([0, 4, 8, 12, 8])
    return [{k: v[a:b] for k, v in task.data.items() if k != "label"} for a, b in zip(edges[:-1], edges[1:])]


@pytest.fixture(scope="module")
def jax_loop_run(worlds, clients):
    model = worlds["2-layer"][0]
    ref = make_runner("fibecfed", model, make_loss_fn(model), FL, clients, optimizer="adamw", engine="loop",
                      seed=7)
    ref.init_phase()
    rounds = [(ref.run_round(t), jax.tree.map(np.asarray, ref.global_lora)) for t in range(2)]
    return ref, rounds


def _shared_comm_bytes(ref, chosen, gal):
    """A round's comm bytes recomputed from the GAL layers: each chosen
    client pulls and pushes the f32 values of the GAL Mamba layers' slices
    and, when the shared block is a GAL layer, the whole unstacked group."""
    per_client = 0
    for group, targets in ref._init_lora.items():
        for ab in targets.values():
            for leaf in ab.values():
                leaf = np.asarray(leaf)
                if group == "shared":
                    per_client += leaf.size * int(gal[-1])
                else:
                    per_client += leaf[0].size * int(gal[:-1].sum())
    return 2 * 4 * per_client * len(chosen)


@pytest.mark.parametrize("engine", ["loop", "vectorized"])
def test_runner_matches_jax_loop_engine(worlds, clients, jax_loop_run, engine):
    """FibecFed/AdamW on the 2-layer hybrid (3 logical layers), 2 rounds,
    each port engine against the JAX loop engine: the same curriculum
    orders and GAL layers (the shared block in or out as JAX chooses),
    losses, global LoRA, and the comm bytes of the stacked and the
    unstacked group, which equal their recount from the GAL layers. The
    vectorized engine's vmap finds a batching rule for every op."""
    ref, rounds = jax_loop_run
    t_model = worlds["2-layer"][3]
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
            assert port.gal_layers.shape == (WORLDS["2-layer"].num_layers + 1,)
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
    assert port.comm_bytes_per_round[-1] == _shared_comm_bytes(ref, port.last_round_info["chosen"], port.gal_layers)
    assert all(isinstance(b, int) for b in port.comm_bytes_per_round)


def test_serve_streams_match_jax(worlds):
    """ServeEngine on the 5-layer hybrid: six requests over three adapters
    through three slots, prompts of 20 and 40 tokens (one longer than the
    32-token cache: its budget is clamped to none, as in JAX), the queued
    ones reusing freed slots; greedy streams equal JAX's token for token."""
    model, params, adapters, t_model, t_params, t_adapters = worlds["5-layer"]
    long, short = _tokens(3, 40, seed=3), _tokens(3, 20, seed=4)
    reqs = [(short[0], 0, 10), (short[1], 1, 5), (long[0], 2, 6), (short[2], 0, 12), (long[1], 1, 4),
            (short[0], 2, 7)]
    kw = dict(cache_len=32, num_slots=3, max_new_cap=12)

    def run(engine, req_cls, sp_cls):
        rids = [engine.submit(req_cls(tokens=t, adapter_id=a, sampling=sp_cls(max_new_tokens=b))) for t, a, b in reqs]
        comps = {c.request_id: c for c in engine.drain()}
        return [comps[r] for r in rids]

    jc = run(JServeEngine(model, params, adapters[0], adapters=adapters[1:], **kw), JRequest, JSamplingParams)
    eng = ServeEngine(t_model, t_params, t_adapters[0], adapters=t_adapters[1:], device="cpu", **kw)
    tc = run(eng, Request, SamplingParams)
    for j, t in zip(jc, tc):
        np.testing.assert_array_equal(t.tokens, j.tokens)
        assert (t.finish_reason, t.steps, t.adapter_id) == (j.finish_reason, j.steps, j.adapter_id)
    assert [c.steps for c in tc] == [10, 5, 0, 12, 0, 7] and eng.stats["prefill_calls"] > 2
    # every cache leaf carries the batch on axis 1: the engine's slot state
    # is the model's cache at num_slots rows
    template = t_model.init_cache(1, 32, "cpu")
    assert {k: tuple(v.shape) for k, v in eng._state["cache"].items()} == \
        {k: (v.shape[0], 3) + tuple(v.shape[2:]) for k, v in template.items()}
