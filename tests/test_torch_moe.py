"""The port's MoE family (``repro_torch.models.moe``, the moe branch of the
decoder, its loss, LoRA, FedPrompt and ``ServeEngine``) against the JAX
package's.

The worlds are ``ARCHS[...].reduced()`` of granite-moe-3b-a800m (4 experts,
top-2, routing groups of 64, 2 layers, d 128, a 64-token window) and
llama4-maverick-400b-a17b (4 experts, top-1, a shared expert), f32, with
the JAX init's params carried into the port through
``repro_torch.convert`` and a non-zero LoRA ``b``; inputs are made from a
seed with numpy.

Tolerances: routing's dispatch masks equal exactly (slots are counts), its
combine weights and aux loss within 1e-6 (f32 softmax, one renormalizing
division); logits, probe norms, MoE outputs and KV caches at atol 2e-5 /
rtol 1e-4, the model tests' tolerance; the runners at the slice gate
(losses rel 1e-4 / abs 1e-5, global LoRA atol 5e-5 / rtol 1e-4, identical
comm bytes, curriculum orders and GAL layers). Greedy token streams must be
equal. The bf16 MoE block runs JAX op by op (``jax.disable_jit``), as
``test_torch_ssm.py`` does, and is held within 2 bf16 ulps of a row's
largest |value|.
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
from repro.federated.prompt_tuning import FedPrompt
from repro.lora import gather_adapter_slots as j_gather
from repro.lora import stack_adapter_trees as j_stack
from repro.models import build_model
from repro.models import moe as jmoe
from repro.serve import Request as JRequest
from repro.serve import SamplingParams as JSamplingParams
from repro.serve import ServeEngine as JServeEngine
from repro.train import make_loss_fn

import repro_torch.config as tconfig
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.convert import lora_from_numpy, params_from_numpy, to_numpy
from repro_torch.federated import FedPrompt as TFedPrompt
from repro_torch.federated import make_runner as t_make_runner
from repro_torch.lora import gather_adapter_slots, stack_adapter_trees
from repro_torch.models import build_model as t_build_model
from repro_torch.models import moe as tmoe
from repro_torch.serve import Request, SamplingParams, ServeEngine
from repro_torch.train import make_loss_fn as t_make_loss_fn
from repro_torch.utils.tree import tree_items, tree_leaves
from torch_jax_refs import release_jax_programs  # noqa: F401

ATOL, RTOL = 2e-5, 1e-4
WORLDS = {"granite": ARCHS["granite-moe-3b-a800m"].reduced(),
          "llama4": ARCHS["llama4-maverick-400b-a17b"].reduced()}
FL = FibecFedConfig(num_devices=4, devices_per_round=2, rounds=4, batch_size=4, learning_rate=5e-3,
                    fim_warmup_epochs=1, gal_fraction=0.5, sparse_ratio=0.5)


def torch_config(cfg):
    """The same architecture as the port's config dataclasses."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["moe"] = tconfig.MoEConfig(**dataclasses.asdict(cfg.moe))
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


def _tokens(n, S, seed=1, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (n, S)).astype(np.int32)


def _close(t, j, what):
    np.testing.assert_allclose(t.detach().to(torch.float32).numpy(), np.asarray(j, np.float32), atol=ATOL,
                               rtol=RTOL, err_msg=what)


def _mcfg(name):
    return torch_config(WORLDS[name]).moe


def _bf16_params(params):
    """A world's f32 params rounded to bf16, as the JAX package stores a
    bf16 model's (numpy arrays of ml_dtypes bfloat16)."""
    return jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)), params)


def test_configs_init_and_convert_follow_jax(worlds):
    """The registry's two MoE configs are the JAX package's; the seeded
    torch init draws every leaf at JAX's shape and dtype (f32 and bf16),
    and ``convert`` carries the router and expert trees at JAX's dtypes."""
    for arch in ("granite-moe-3b-a800m", "llama4-maverick-400b-a17b"):
        assert torch_config(ARCHS[arch]) == T_ARCHS[arch]
    for cfg in list(WORLDS.values()) + [dataclasses.replace(WORLDS["llama4"], dtype="bfloat16")]:
        jp = jax.eval_shape(lambda k, cfg=cfg: build_model(cfg).init_params(k), jax.random.PRNGKey(0))
        want = {p: (tuple(s.shape), str(s.dtype)) for p, s in tree_items(jp)}
        tp = t_build_model(torch_config(cfg)).init_params(torch.Generator().manual_seed(0), "cpu")
        assert {p: (tuple(t.shape), str(t.dtype)[6:]) for p, t in tree_items(tp)} == want
        for name in ("e_gate", "e_down"):  # N(0, 1/d_in), drawn an expert at a time
            w = tp["layers"][name].float()
            assert abs(float(w.std()) * np.sqrt(w.shape[-2]) - 1.0) < 0.05
    cfg = dataclasses.replace(WORLDS["llama4"], dtype="bfloat16")
    params = _bf16_params(worlds["llama4"][1])
    tp = params_from_numpy(params, torch_config(cfg), "cpu")
    for path, leaf in tree_items(tp):
        assert leaf.dtype == torch.bfloat16, path
    np.testing.assert_array_equal(to_numpy(tp["layers"]["e_up"]), np.asarray(params["layers"]["e_up"], np.float32))


@pytest.mark.parametrize("group", [1, 8, 64, 512])
def test_capacity_matches_jax(group):
    for name in WORLDS:
        assert tmoe.capacity(group, _mcfg(name)) == jmoe.capacity(group, WORLDS[name].moe)
    full = T_ARCHS["granite-moe-3b-a800m"].moe
    assert tmoe.capacity(8, full) == 2 and tmoe.capacity(512, full) == 128


def _route_inputs(name, shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    cfg = WORLDS[name]
    x = rng.standard_normal(shape + (cfg.d_model,)).astype(np.float32)
    w = (rng.standard_normal((cfg.d_model, cfg.moe.num_experts)) * scale).astype(np.float32)
    return x, w


@pytest.mark.parametrize("name", sorted(WORLDS))
@pytest.mark.parametrize("weighted", [False, True])
def test_route_matches_jax(name, weighted):
    """(B, n_groups, G, D) tokens with a router that overflows some experts'
    queues: dispatch equal exactly, combine and aux within 1e-6, with and
    without per-sample weights."""
    x, w = _route_inputs(name, (3, 2, 24), scale=0.5)
    sw = np.array([1.0, 0.0, 1.0], np.float32) if weighted else None
    jd, jc, ja = jmoe.route(jnp.asarray(x), jnp.asarray(w), WORLDS[name].moe,
                            sample_weight=None if sw is None else jnp.asarray(sw))
    td, tc, ta = tmoe.route(torch.as_tensor(x), torch.as_tensor(w), _mcfg(name),
                            sample_weight=None if sw is None else torch.as_tensor(sw))
    assert td.shape == jd.shape and tc.dtype == torch.float32
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6, rtol=1e-6)
    # some choice was dropped past capacity: fewer kept slots than choices
    assert float(td.sum()) < x.shape[0] * x.shape[1] * x.shape[2] * WORLDS[name].moe.top_k


def test_all_zero_router_breaks_ties_by_index():
    """An all-zero router gives every expert the same probability: each
    token picks experts 0..k-1 (the lower index first, as jax.lax.top_k),
    their queues fill in token order, and the tokens past the capacity get
    zero rows, as in JAX."""
    mcfg = _mcfg("granite")
    G, K, E = 16, mcfg.top_k, mcfg.num_experts
    C = tmoe.capacity(G, mcfg)
    x = np.random.default_rng(1).standard_normal((1, G, WORLDS["granite"].d_model)).astype(np.float32)
    w = np.zeros((x.shape[-1], E), np.float32)
    td, tc, ta = tmoe.route(torch.as_tensor(x), torch.as_tensor(w), mcfg)
    jd, jc, ja = jmoe.route(jnp.asarray(x), jnp.asarray(w), WORLDS["granite"].moe)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    d = td[0]  # (G, E, C)
    for g in range(G):
        for e in range(E):
            want = e < K and g < C
            assert float(d[g, e].sum()) == float(want), (g, e)
            if want:
                assert float(d[g, e, g]) == 1.0 and float(tc[0, g, e, g]) == pytest.approx(1.0 / K)
    assert float(ta) == pytest.approx(float(ja), abs=1e-7)


@pytest.mark.parametrize("name", sorted(WORLDS))
@pytest.mark.parametrize("S", [1, 128])
def test_apply_moe_matches_jax(worlds, name, S):
    """Layer 1's MoE (with llama4's shared expert, without granite's) at a
    decode step (S 1: the batch routed as one group) and two groups of 64
    (one group of fewer tokens is in the forward's test)."""
    model, params, _, t_model, t_params, _ = worlds[name]
    x = np.random.default_rng(S).standard_normal((3, S, WORLDS[name].d_model)).astype(np.float32)
    p = {k: v[1] for k, v in params["layers"].items()}
    tp = {k: v[1] for k, v in t_params["layers"].items()}
    want, jaux = jmoe.apply_moe(jnp.asarray(x), p, WORLDS[name].moe)
    got, taux = tmoe.apply_moe(torch.as_tensor(x), tp, _mcfg(name))
    assert ("s_gate" in tp) == (name == "llama4")
    _close(got, want, "moe output")
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="routing groups"):
        tmoe.apply_moe(torch.zeros((1, 96, WORLDS[name].d_model)), tp, _mcfg(name))


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_apply_moe_bf16_matches_jax_op_by_op(worlds, name):
    """The bf16 block keeps JAX's casts: the dispatch and the combine
    weights in bf16 before their einsums, SiLU in f32."""
    cfg = dataclasses.replace(WORLDS[name], dtype="bfloat16")
    params = _bf16_params(worlds[name][1])
    p = {k: jnp.asarray(v[0]) for k, v in params["layers"].items()}
    tp = {k: v[0] for k, v in params_from_numpy(params, torch_config(cfg), "cpu")["layers"].items()}
    x = np.random.default_rng(5).standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    with jax.disable_jit():
        want, _ = jmoe.apply_moe(jnp.asarray(x, jnp.bfloat16), p, cfg.moe)
    got, _ = tmoe.apply_moe(torch.as_tensor(x).bfloat16(), tp, _mcfg(name))
    assert got.dtype == torch.bfloat16
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    err = np.abs(g - w) / (2.0 ** -8 * np.abs(w).max(-1, keepdims=True))
    assert float(err.max()) <= 2.0, float(err.max())


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_padded_aux_equals_ragged(worlds, name):
    """The masked loss of a padded batch equals the plain loss of its
    ragged original, aux included (JAX ``tests/test_moe.py``), and both
    equal JAX's."""
    model, params, adapters, t_model, t_params, t_adapters = worlds[name]
    valid, junk = _tokens(3, 16, seed=2), _tokens(3, 16, seed=3)
    padded = np.concatenate([valid, junk])
    mask = np.array([1, 1, 1, 0, 0, 0], np.float32)
    loss = t_make_loss_fn(t_model)
    with torch.no_grad():
        plain = float(loss(t_params, t_adapters[0], {"tokens": torch.as_tensor(valid).long()}))
        masked = float(loss.masked(t_params, t_adapters[0], {"tokens": torch.as_tensor(padded).long()},
                                   torch.as_tensor(mask)))
        _, aux = t_model.forward(t_params, t_adapters[0], {"tokens": torch.as_tensor(valid).long()})
    assert masked == pytest.approx(plain, abs=1e-6) and float(aux) > 0
    j_loss = make_loss_fn(model)
    assert plain == pytest.approx(float(j_loss(params, adapters[0], {"tokens": jnp.asarray(valid)})), rel=1e-5)
    assert masked == pytest.approx(float(j_loss.masked(params, adapters[0], {"tokens": jnp.asarray(padded)},
                                                       jnp.asarray(mask))), rel=1e-5)


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_forward_probe_prefill_decode_match_jax(worlds, name):
    """forward (logits and the summed aux), the probe's norms, prefill's
    last logits and KV cache, and three teacher-forced decode steps with
    per-slot adapters at per-slot positions (the rows routed together)."""
    model, params, adapters, t_model, t_params, t_adapters = worlds[name]
    toks = _tokens(3, 40)
    eps = np.random.default_rng(4).standard_normal((3, 40, WORLDS[name].d_model)).astype(np.float32) * 0.1
    logits, aux, norms = model.forward_probe(params, adapters[1], {"tokens": jnp.asarray(toks)}, jnp.asarray(eps))
    with torch.no_grad():
        t_logits, t_aux, t_norms = t_model.forward_probe(t_params, t_adapters[1],
                                                         {"tokens": torch.as_tensor(toks).long()},
                                                         torch.as_tensor(eps))
    _close(t_logits, logits, "probe logits")
    _close(t_norms, norms, "layer norms")
    np.testing.assert_allclose(float(t_aux), float(aux), atol=1e-6, rtol=1e-6)
    ids = np.array([2, 0, 1], np.int32)
    lora = j_gather(WORLDS[name], j_stack([jax.tree.map(jnp.asarray, a) for a in adapters]), jnp.asarray(ids))
    t_lora = gather_adapter_slots(t_model.cfg, stack_adapter_trees(t_adapters), torch.as_tensor(ids).long())
    logits, cache, pos = model.prefill(params, lora, {"tokens": jnp.asarray(toks)}, 48)
    with torch.no_grad():
        t_logits, t_cache, t_pos = t_model.prefill(t_params, t_lora, {"tokens": torch.as_tensor(toks).long()}, 48)
    assert t_pos == int(pos) == 40
    _close(t_logits, logits, "prefill logits")
    for k in ("k", "v"):
        _close(t_cache[k], cache[k], f"prefill cache {k}")
    position = np.array([40, 38, 40], np.int32)  # rows at their own depths
    for step in range(3):
        tok = np.argmax(np.asarray(logits, np.float32)[:, -1], -1)[:, None].astype(np.int32)
        logits, cache = model.decode_step(params, lora, jnp.asarray(tok), cache, jnp.asarray(position))
        with torch.no_grad():
            t_logits, t_cache = t_model.decode_step(t_params, t_lora, torch.as_tensor(tok).long(), t_cache,
                                                    torch.as_tensor(position).long())
        _close(t_logits, logits, f"decode step {step}")
        position = position + 1
    for k in ("k", "v"):
        _close(t_cache[k], cache[k], f"decode cache {k}")


def test_lora_tree_is_the_attention_tree(worlds):
    """moe LoRA covers wq/wk/wv/wo only, stacked (the JAX package's code;
    the experts and router stay frozen)."""
    model, params, adapters, t_model, t_params, t_adapters = worlds["llama4"]
    t_lora = t_model.init_lora(torch.Generator().manual_seed(0), "cpu")
    want = {p: tuple(x.shape) for p, x in tree_items(adapters[0])}
    assert {p: tuple(x.shape) for p, x in tree_items(t_lora)} == want
    assert sorted(t_lora["layers"]) == ["wk", "wo", "wq", "wv"]


@pytest.fixture(scope="module")
def clients():
    """4 clients of 4, 8, 10 and 8 samples: the vectorized engine pads
    steps and a ragged last batch, and the JAX side compiles two batch
    shapes only."""
    task = make_keyword_task(n_samples=30, seq_len=12, vocab_size=256, seed=0)
    edges = np.cumsum([0, 4, 8, 10, 8])
    return [{k: v[a:b] for k, v in task.data.items() if k != "label"} for a, b in zip(edges[:-1], edges[1:])]


@pytest.fixture(scope="module")
def jax_loop_run(worlds, clients):
    """The JAX loop engine (the semantic spec) on reduced granite, 2 rounds:
    its decisions, per-round stats, global LoRA and comm bytes."""
    model = worlds["granite"][0]
    ref = make_runner("fibecfed", model, make_loss_fn(model), FL, clients, optimizer="adamw", engine="loop",
                      seed=7)
    ref.init_phase()
    rounds = [(ref.run_round(t), jax.tree.map(np.asarray, ref.global_lora)) for t in range(2)]
    return ref, rounds


@pytest.mark.parametrize("engine", ["loop", "vectorized"])
def test_runner_matches_jax_loop_engine(worlds, clients, jax_loop_run, engine):
    """FibecFed/AdamW on reduced granite, 2 rounds, each port engine against
    the JAX loop engine (ROADMAP C5: JAX's own engines part on this world
    only in float noise, so both port engines answer to its semantic spec):
    the same curriculum orders and GAL layers, losses, global LoRA and comm
    bytes. The vectorized engine's masked loss threads the sample mask to
    the router, and its vmap over clients finds a batching rule for every
    op of the MoE (none falls back to a loop, which would warn)."""
    ref, rounds = jax_loop_run
    t_model = worlds["granite"][3]
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
    assert all(isinstance(b, int) for b in port.comm_bytes_per_round)


def test_fedprompt_on_moe_matches_jax(worlds, clients):
    """FedPrompt on reduced granite (the soft prompt ahead of the MoE
    decoder, its aux loss in the objective): 2 rounds, losses, prompt and
    the exact comm bytes."""
    cfg = WORLDS["granite"]
    fl = dataclasses.replace(FL, learning_rate=5e-2)
    ref = FedPrompt(worlds["granite"][0], fl, clients, n_prompt=4, seed=3)
    port = TFedPrompt(worlds["granite"][3], tconfig.FibecFedConfig(**dataclasses.asdict(fl)), clients, n_prompt=4,
                      seed=3, device="cpu", init_params=jax.tree.map(np.asarray, ref.params),
                      init_prompt=np.asarray(ref.prompt))
    for t in range(2):
        hr, hp = ref.run_round(t), port.run_round(t)
        assert hp["loss"] == pytest.approx(hr["loss"], rel=1e-4, abs=1e-5)
        np.testing.assert_allclose(port.prompt.numpy(), np.asarray(ref.prompt), atol=5e-5, rtol=1e-4)
    assert port.comm_bytes_per_round == ref.comm_bytes_per_round == [2 * 2 * 4 * cfg.d_model * 4] * 2


def test_serve_streams_match_jax_with_done_and_idle_slots(worlds):
    """ServeEngine on reduced granite, 4 slots, three adapters: three
    requests, one stopped by an EOS early (a done slot that stays in the
    decode batch until its segment ends) and one slot never filled (an idle
    row). A decode step routes all 4 rows as one group, so every stream
    depends on what the other rows hold: the greedy streams equal JAX's
    token for token only if the port decodes the same rows with the same
    tokens, caches and positions."""
    model, params, adapters, t_model, t_params, t_adapters = worlds["granite"]
    prompts = [_tokens(1, 20, seed=11)[0], _tokens(1, 8, seed=12)[0], _tokens(1, 20, seed=13)[0]]
    kw = dict(cache_len=48, num_slots=4, max_new_cap=12)
    jax_eng = JServeEngine(model, params, adapters[0], adapters=adapters[1:], **kw)

    def run(engine, req_cls, sp_cls, eos=None):
        spec = [(prompts[0], 0, 12, None), (prompts[1], 1, 12, eos), (prompts[2], 2, 9, None)]
        rids = [engine.submit(req_cls(tokens=t, adapter_id=a, sampling=sp_cls(max_new_tokens=b, eos_id=e)))
                for t, a, b, e in spec]
        comps = {c.request_id: c for c in engine.drain()}
        return [comps[r] for r in rids]

    # the stop token: the first token of request 1's free stream that first
    # appears at index 2 or later
    free = run(jax_eng, JRequest, JSamplingParams)[1]
    eos = int(next(t for j, t in enumerate(free.tokens) if j >= 2 and t not in free.tokens[:j]))
    jax_eng.reset()
    jc = run(jax_eng, JRequest, JSamplingParams, eos)
    tc = run(ServeEngine(t_model, t_params, t_adapters[0], adapters=t_adapters[1:], device="cpu", **kw), Request,
             SamplingParams, eos)
    for j, t in zip(jc, tc):
        np.testing.assert_array_equal(t.tokens, j.tokens)
        assert (t.finish_reason, t.steps) == (j.finish_reason, j.steps)
    assert tc[1].finish_reason == "eos" and tc[1].steps < 12 and [c.steps for c in tc][::2] == [12, 9]
