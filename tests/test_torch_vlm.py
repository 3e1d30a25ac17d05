"""The port's vlm family (paligemma-3b: the decoder's vlm branch, token
embeddings scaled by sqrt(d_model) and the prefix rows not, the text loss
after the prefix, the runner, FedPrompt and ``ServeEngine`` on it, B8's
plain version at head_dim 256) against the JAX package.

The world is ``ARCHS["paligemma-3b"].reduced()``: 2 layers, d 128, 4 heads
of 32 over 1 KV head, 8 prefix rows, vocab 512, window 64, f32. Params come
from the JAX init through ``repro_torch.convert``, the adapters get a
non-zero ``b``, and tokens and prefix embeddings are made from a seed with
numpy.

Tolerances: logits, probe norms, caches and losses at atol 2e-5 / rtol 1e-4
(the other families' files'); the runners at the slice gate (losses rel
1e-4 / abs 1e-5, global LoRA atol 5e-5 / rtol 1e-4, identical comm bytes,
curriculum orders and GAL layers); FedPrompt as ``test_torch_prompt.py``
holds it (losses rel 1e-5, prompt atol 1e-6); B8 within 1e-5 of the
largest |v|, bf16 one ulp beyond. Greedy token streams must be equal.
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
from repro.federated.prompt_tuning import FedPrompt as JFedPrompt
from repro.federated import make_runner
from repro.kernels import ops as jops
from repro.lora import gather_adapter_slots as j_gather
from repro.lora import stack_adapter_trees as j_stack
from repro.models import build_model
from repro.serve import Request as JRequest
from repro.serve import SamplingParams as JSamplingParams
from repro.serve import ServeEngine as JServeEngine
from repro.train import make_loss_fn

import repro_torch.config as tconfig
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.convert import lora_from_numpy, params_from_numpy, to_numpy
from repro_torch.federated import FedPrompt
from repro_torch.federated import make_runner as t_make_runner
from repro_torch.kernels import ops as tops
from repro_torch.lora import gather_adapter_slots, stack_adapter_trees
from repro_torch.models import build_model as t_build_model
from repro_torch.serve import Request, SamplingParams, ServeEngine
from repro_torch.train import make_loss_fn as t_make_loss_fn
from repro_torch.utils.tree import flatten_dict, tree_items, tree_leaves, unflatten_dict
from torch_jax_refs import jax_in_child, release_jax_programs  # noqa: F401

ATOL, RTOL = 2e-5, 1e-4
CFG = ARCHS["paligemma-3b"].reduced()
P = CFG.num_prefix_embeddings
FL = FibecFedConfig(num_devices=4, devices_per_round=2, rounds=4, batch_size=4, learning_rate=5e-3,
                    fim_warmup_epochs=1, gal_fraction=0.5, sparse_ratio=0.5)


def torch_config(cfg):
    return tconfig.ModelConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def _jax_init():
    """JAX's params of the world and its three adapters (b made non-zero),
    flat: the world fixture computes them in a child process."""
    model = build_model(CFG)
    rng = jax.random.PRNGKey(0)
    nrng = np.random.default_rng(0)
    adapters = {f"adapter{i}": jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * nrng.standard_normal(x.shape)).astype(np.float32),
        model.init_lora(jax.random.fold_in(rng, i))) for i in range(3)}
    return flatten_dict({"params": jax.jit(model.init_params)(rng), **adapters})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    model = build_model(CFG)
    init = unflatten_dict(jax_in_child("test_torch_vlm", "_jax_init", out=tmp_path_factory.mktemp("vlm") / "init.npz"))
    params, adapters = init["params"], [init[f"adapter{i}"] for i in range(3)]
    t_model = t_build_model(torch_config(CFG))
    return model, params, adapters, t_model, params_from_numpy(params, t_model.cfg, "cpu"), \
        [lora_from_numpy(a, "cpu") for a in adapters]


def _batch(n, S, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 512, (n, S)).astype(np.int32),
            "prefix_embeds": rng.standard_normal((n, P, CFG.d_model)).astype(np.float32)}


def _t(batch):
    return {k: torch.as_tensor(v).long() if k == "tokens" else torch.as_tensor(v) for k, v in batch.items()}


def _close(t, j, what):
    np.testing.assert_allclose(t.detach().to(torch.float32).numpy(), np.asarray(j, np.float32), atol=ATOL,
                               rtol=RTOL, err_msg=what)


def test_config_and_init_follow_jax():
    assert torch_config(ARCHS["paligemma-3b"]) == T_ARCHS["paligemma-3b"]
    jp = jax.eval_shape(build_model(CFG).init_params, jax.random.PRNGKey(0))
    tp = t_build_model(torch_config(CFG)).init_params(torch.Generator().manual_seed(0), "cpu")
    assert {p: (tuple(t.shape), str(t.dtype)[6:]) for p, t in tree_items(tp)} == \
        {p: (tuple(s.shape), str(s.dtype)) for p, s in tree_items(jp)}


def test_forward_loss_and_probe_match_jax(world):
    """Logits over prefix + text (the tokens' embeddings scaled by
    sqrt(d_model), the prefix's not: scaling both would move every logit),
    the text loss after the P prefix positions (plain and masked), and the
    probe norms with the GAL probe's noise over P + T positions."""
    model, params, adapters, t_model, t_params, t_adapters = world
    batch = _batch(3, 24)
    jb, tb = jax.tree.map(jnp.asarray, batch), _t(batch)
    eps = np.random.default_rng(4).standard_normal((3, P + 24, CFG.d_model)).astype(np.float32) * 0.1
    logits, _, norms = model.forward_probe(params, adapters[1], jb, jnp.asarray(eps))
    loss_fn = t_make_loss_fn(t_model)
    with torch.no_grad():
        t_logits, _, t_norms = t_model.forward_probe(t_params, t_adapters[1], tb, torch.as_tensor(eps))
        t_loss = loss_fn(t_params, t_adapters[1], tb)
        t_masked = loss_fn.masked(t_params, t_adapters[1], tb, torch.tensor([1.0, 0.0, 1.0]))
        unscaled = t_model.forward(t_params, t_adapters[1], {**tb, "prefix_embeds": tb["prefix_embeds"] * 128 ** 0.5})
    assert t_logits.shape == (3, P + 24, CFG.vocab_size)
    _close(t_logits, logits, "logits")
    _close(t_norms, norms, "layer norms")
    j_loss = make_loss_fn(model)
    np.testing.assert_allclose(float(t_loss), float(j_loss(params, adapters[1], jb)), atol=ATOL, rtol=RTOL)
    sub = {k: v[np.array([0, 2])] for k, v in jb.items()}
    np.testing.assert_allclose(float(t_masked), float(j_loss(params, adapters[1], sub)), atol=ATOL, rtol=RTOL)
    assert float((unscaled[0] - t_logits).abs().max()) > 1e-2


def test_runner_gal_probe_counts_the_prefix(world):
    """The runner's layer-sensitivity probe draws its noise over P + T
    positions, as the JAX runner's does, and gives JAX's scores."""
    model, params, adapters, t_model, t_params, t_adapters = world
    clients = [{k: v for k, v in _batch(4, 12, seed=5).items()}]
    ref = make_runner("fibecfed", model, make_loss_fn(model), FL, clients, optimizer="adamw", engine="loop", seed=0)
    port = t_make_runner("fibecfed", t_model, t_make_loss_fn(t_model), tconfig.FibecFedConfig(**dataclasses.asdict(FL)),
                         clients, optimizer="adamw", engine="loop", seed=0, device="cpu",
                         init_params=jax.tree.map(np.asarray, ref.params))
    batch = _batch(4, 12, seed=6)
    want = ref._sensitivity_fn()(ref.params, adapters[2], jax.tree.map(jnp.asarray, batch))
    got = port._sensitivity(t_adapters[2], _t(batch))
    assert got.shape == (CFG.num_layers,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_prefill_and_decode_match_jax(world):
    """Prefill with the prefix (S counts P: 8 + 20 positions in a 32-slot
    ring cache), the caches, then three decode steps with per-slot positions
    and adapters, teacher-forced with JAX's greedy tokens."""
    model, params, adapters, t_model, t_params, t_adapters = world
    ids = np.array([2, 0, 1], np.int32)
    lora = j_gather(CFG, j_stack([jax.tree.map(jnp.asarray, a) for a in adapters]), jnp.asarray(ids))
    t_lora = gather_adapter_slots(t_model.cfg, stack_adapter_trees(t_adapters), torch.as_tensor(ids).long())
    batch = _batch(3, 20, seed=8)
    logits, cache, pos = model.prefill(params, lora, jax.tree.map(jnp.asarray, batch), 32)
    with torch.no_grad():
        t_logits, t_cache, t_pos = t_model.prefill(t_params, t_lora, _t(batch), 32)
    assert t_pos == int(pos) == P + 20
    _close(t_logits, logits, "prefill logits")
    for k in cache:
        _close(t_cache[k], cache[k], f"prefill cache {k}")
    position = np.array([P + 20, P + 15, P + 18], np.int32)
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


@pytest.fixture(scope="module")
def clients():
    """4 clients of 4, 8, 12 and 8 samples, tokens and prefix embeddings, no
    label token: the loss is the next-token CE after the prefix."""
    task = make_keyword_task(n_samples=32, seq_len=12, vocab_size=256, seed=0)
    prefix = np.random.default_rng(2).standard_normal((32, P, CFG.d_model)).astype(np.float32)
    data = {"tokens": task.data["tokens"], "prefix_embeds": prefix}
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
    """FibecFed/AdamW on the vlm, 2 rounds, each port engine against the JAX
    loop engine: the same curriculum orders and GAL layers, losses, global
    LoRA and comm bytes; the prefix rides the stacked client data."""
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


def test_fedprompt_on_vlm_matches_jax(world):
    """FedPrompt on the vlm: the soft prompt takes the prefix's place; 2
    rounds and ``evaluate`` equal JAX's FedPrompt from its params and
    prompt."""
    model, params, _, t_model, _, _ = world
    fl = FibecFedConfig(num_devices=4, devices_per_round=2, rounds=2, batch_size=4, learning_rate=0.05)
    task = make_keyword_task(n_samples=24, seq_len=10, vocab_size=256, seed=1)
    data = {k: v for k, v in task.data.items() if k != "label"}
    clients = [{k: v[i::4] for k, v in data.items()} for i in range(4)]
    ref = JFedPrompt(model, fl, clients, n_prompt=P, seed=3)
    port = FedPrompt(t_model, tconfig.FibecFedConfig(**dataclasses.asdict(fl)), clients, n_prompt=P, seed=3,
                     device="cpu", init_params=jax.tree.map(np.asarray, ref.params),
                     init_prompt=np.asarray(ref.prompt))
    for t in range(2):
        hr, hp = ref.run_round(t), port.run_round(t)
        assert hp["loss"] == pytest.approx(hr["loss"], rel=1e-5)
    np.testing.assert_allclose(port.prompt.numpy(), np.asarray(ref.prompt), atol=1e-6, rtol=0)
    assert port.comm_bytes_per_round == ref.comm_bytes_per_round
    assert port.evaluate(data) == ref.evaluate(data)


@pytest.mark.parametrize("arch", ["whisper-large-v3", "roberta-large", "mamba2-1.3b"])
def test_fedprompt_refuses_what_jax_refuses(arch):
    clients = [{"tokens": np.zeros((4, 8), np.int32), "label_token": np.zeros(4, np.int32)}]
    fl = FibecFedConfig(num_devices=1, devices_per_round=1)
    with pytest.raises(AssertionError, match="prompt tuning needs a decoder"):
        JFedPrompt(build_model(ARCHS[arch].reduced()), fl, clients)
    t_model = t_build_model(T_ARCHS[arch].reduced())
    with pytest.raises(ValueError, match="prompt tuning needs a decoder"):
        FedPrompt(t_model, tconfig.FibecFedConfig(**dataclasses.asdict(fl)), clients, device="cpu")


def test_serve_streams_match_jax(world):
    """ServeEngine: six requests over three adapters through three slots,
    each with its own prefix embeddings (``extras``); prompts of 10 and 30
    tokens make 18 and 38 positions with the prefix, so in a 32-token cache
    the long ones get no budget, as in JAX; greedy streams equal JAX's."""
    model, params, adapters, t_model, t_params, t_adapters = world
    long, short = _batch(3, 30, seed=3), _batch(3, 10, seed=4)
    reqs = [(short, 0, 0, 10), (short, 1, 1, 5), (long, 0, 2, 6), (short, 2, 0, 12), (long, 1, 1, 4),
            (short, 0, 2, 7)]
    kw = dict(cache_len=32, num_slots=3, max_new_cap=12)

    def run(engine, req_cls, sp_cls):
        rids = [engine.submit(req_cls(tokens=b["tokens"][i], adapter_id=a, sampling=sp_cls(max_new_tokens=n),
                                      extras={"prefix_embeds": b["prefix_embeds"][i]}))
                for b, i, a, n in reqs]
        comps = {c.request_id: c for c in engine.drain()}
        return [comps[r] for r in rids]

    jc = run(JServeEngine(model, params, adapters[0], adapters=adapters[1:], **kw), JRequest, JSamplingParams)
    eng = ServeEngine(t_model, t_params, t_adapters[0], adapters=t_adapters[1:], device="cpu", **kw)
    tc = run(eng, Request, SamplingParams)
    for j, t in zip(jc, tc):
        np.testing.assert_array_equal(t.tokens, j.tokens)
        assert (t.finish_reason, t.steps, t.adapter_id) == (j.finish_reason, j.steps, j.adapter_id)
    assert [c.steps for c in tc] == [10, 5, 0, 12, 0, 7]


@pytest.mark.parametrize("S,causal,window,dtype", [(256, True, None, "float32"), (200, True, 64, "float32"),
                                                   (256, False, None, "float32"), (256, True, 64, "bfloat16")])
def test_flash_attention_head_dim_256_matches_jax(S, causal, window, dtype):
    """``ops.flash_attention`` at paligemma-3b's head_dim 256 with its 1 KV
    head (its plain version on the CPU) against
    ``repro.kernels.ops.flash_attention`` run as the JAX tests run it
    (interpret mode; a ragged S takes its dense oracle): within 1e-5 of the
    largest |v|, bf16 one ulp beyond."""
    rng = np.random.default_rng(S + 7 * causal)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jq = jnp.asarray(rng.standard_normal((1, S, 4, 256), dtype=np.float32), jdt)
    jk, jv = (jnp.asarray(rng.standard_normal((1, S, 1, 256), dtype=np.float32), jdt) for _ in range(2))
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch, dtype)) for x in (jq, jk, jv))
    want = np.asarray(jops.flash_attention(jq, jk, jv, causal=causal, window=window), np.float32)
    got = tops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    g = got.to(torch.float32).numpy()
    allowed = 1e-5 * float(np.abs(np.asarray(jv, np.float32)).max())
    if dtype == "bfloat16":
        _, e = np.frexp(np.maximum(np.abs(g), np.abs(want)))
        allowed = allowed + np.ldexp(1.0, e - 8)
    assert np.all(np.abs(g - want) <= allowed)
