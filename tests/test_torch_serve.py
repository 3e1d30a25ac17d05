"""The port's serving path (``repro_torch.serve``) against the JAX package's.

The reduced qwen2-0.5b world of ``tests/test_serve.py``: params from the
JAX init and LoRA adapters with a non-zero ``b`` (so that every adapter
moves the logits), carried into the port through ``repro_torch.convert``;
prompts made from a seed with numpy and handed to both packages.

Prefill and decode logits are compared in f32 at atol 2e-5, rtol 1e-4, the
model tests' tolerance (the frameworks round rsqrt, exp and the matmul sums
differently by an ulp or so, and two layers add those up); caches likewise.
Greedy token streams must be equal. Sampled streams cannot be: the port
draws from ``torch.Generator`` s, not ``jax.random``; there the port is held
to its own reference engine and to per-request independence.
"""
import dataclasses

import pytest

pytest.importorskip("torch").set_num_threads(1)  # xdist workers share the cores: no thread pool each

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS
from repro.lora import gather_adapter_slots as j_gather
from repro.lora import stack_adapter_trees as j_stack
from repro.models import build_model
from repro.serve import Request as JRequest
from repro.serve import SamplingParams as JSamplingParams
from repro.serve import ServeEngine as JServeEngine
from repro.serve import SlotScheduler as JSlotScheduler

import repro_torch.config as tconfig
from repro_torch.convert import lora_from_numpy, params_from_numpy
from repro_torch.lora import gather_adapter_slots, stack_adapter_trees
from repro_torch.models import build_model as t_build_model
from repro_torch.obs import Telemetry, check_spans
from repro_torch.serve import (
    ReferenceEngine,
    Request,
    SamplingParams,
    ServeEngine,
    SlotScheduler,
    make_prompt_batch,
)
from torch_jax_refs import release_jax_programs  # noqa: F401

ATOL, RTOL = 2e-5, 1e-4
CFG = ARCHS["qwen2-0.5b"].reduced()  # 2 layers, d 128, window 64: cache_len <= 64 is a ring


def torch_config(cfg):
    return tconfig.ModelConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


@pytest.fixture(scope="module")
def world():
    model = build_model(CFG)
    rng = jax.random.PRNGKey(0)
    params = jax.tree.map(np.asarray, model.init_params(rng))
    nrng = np.random.default_rng(0)
    adapters = [
        jax.tree.map(lambda x: (np.asarray(x) + 0.05 * nrng.standard_normal(x.shape)).astype(np.float32),
                     model.init_lora(jax.random.fold_in(rng, i)))
        for i in range(3)
    ]
    t_model = t_build_model(torch_config(CFG))
    t_params = params_from_numpy(params, t_model.cfg, "cpu")
    t_adapters = [lora_from_numpy(a, "cpu") for a in adapters]
    return model, params, adapters, t_model, t_params, t_adapters


def _prompts(n, S, seed=1):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (n, S)).astype(np.int32)


def _close(t, j, what):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=ATOL, rtol=RTOL, err_msg=what)


def _drain(engine, request_cls, reqs):
    rids = [engine.submit(request_cls(**r)) for r in reqs]
    comps = {c.request_id: c for c in engine.drain()}
    assert sorted(comps) == sorted(rids)
    return [comps[r] for r in rids]


def _engines(world, **kw):
    model, params, adapters, t_model, t_params, t_adapters = world
    n = kw.pop("n_adapters", 1)
    jax_eng = JServeEngine(model, params, adapters[0], adapters=adapters[1:n], **kw)
    port_eng = ServeEngine(t_model, t_params, t_adapters[0], adapters=t_adapters[1:n], device="cpu", **kw)
    return jax_eng, port_eng


def _same_streams(jax_comps, port_comps):
    for jc, tc in zip(jax_comps, port_comps):
        np.testing.assert_array_equal(tc.tokens, jc.tokens)
        assert (tc.finish_reason, tc.steps, tc.adapter_id, tc.prompt_len) == \
            (jc.finish_reason, jc.steps, jc.adapter_id, jc.prompt_len)


@pytest.mark.parametrize("S,cache_len", [(8, 32), (40, 32), (8, 80)], ids=["ring", "ring-S>T", "flat"])
@pytest.mark.parametrize("per_slot", [False, True], ids=["one-adapter", "per-slot"])
def test_prefill_and_decode_logits_match_jax(world, S, cache_len, per_slot):
    """Prefill logits and cache, then three decode steps at per-slot
    positions (teacher-forced with JAX's greedy tokens), in the ring layout
    (a prompt longer than the cache included) and the flat one, with one
    shared adapter and with each row's own gathered adapter."""
    model, params, adapters, t_model, t_params, t_adapters = world
    toks = _prompts(3, S)
    if per_slot:
        ids = np.array([2, 0, 1], np.int32)
        lora = j_gather(CFG, j_stack([jax.tree.map(jnp.asarray, a) for a in adapters]), jnp.asarray(ids))
        t_lora = gather_adapter_slots(t_model.cfg, stack_adapter_trees(t_adapters), torch.as_tensor(ids).long())
        assert t_lora["layers"]["wq"]["a"].shape == (CFG.num_layers, 3, CFG.d_model, CFG.lora_rank)
    else:
        lora, t_lora = adapters[0], t_adapters[0]
    logits, cache, pos = model.prefill(params, lora, {"tokens": jnp.asarray(toks)}, cache_len)
    t_logits, t_cache, t_pos = t_model.prefill(t_params, t_lora, {"tokens": torch.as_tensor(toks).long()},
                                                cache_len)
    assert t_pos == int(pos) == S
    _close(t_logits, logits, "prefill logits")
    for name in ("k", "v"):
        _close(t_cache[name], cache[name], f"prefill cache {name}")
    position = np.full(3, S, np.int32)
    for step in range(3):
        tok = np.argmax(np.asarray(logits)[:, -1], -1)[:, None].astype(np.int32)
        logits, cache = model.decode_step(params, lora, jnp.asarray(tok), cache, jnp.asarray(position))
        t_logits, t_cache = t_model.decode_step(t_params, t_lora, torch.as_tensor(tok).long(), t_cache,
                                                torch.as_tensor(position).long())
        _close(t_logits, logits, f"decode step {step} logits")
        position = position + 1
    for name in ("k", "v"):
        _close(t_cache[name], cache[name], f"decode cache {name}")


def test_flat_cache_decode_keeps_the_window(world):
    """C10 (ROADMAP.md §C): a flat cache longer than the 64-token window
    (96 slots) after a 70-token prompt. The JAX package's decode step
    attends to every cached position, so its logits leave its own forward's
    (which masks keys at or before position - window); the port's decode
    masks the window and equals that forward."""
    model, params, adapters, t_model, t_params, t_adapters = world
    toks = _prompts(2, 70)
    logits, cache, pos = model.prefill(params, adapters[0], {"tokens": jnp.asarray(toks)}, 96)
    tok = np.argmax(np.asarray(logits)[:, -1], -1)[:, None].astype(np.int32)
    j_dec, _ = model.decode_step(params, adapters[0], jnp.asarray(tok), cache, pos)
    j_full, _ = model.forward(params, adapters[0], {"tokens": jnp.asarray(np.concatenate([toks, tok], 1))})
    with torch.no_grad():
        _, t_cache, t_pos = t_model.prefill(t_params, t_adapters[0], {"tokens": torch.as_tensor(toks).long()}, 96)
        t_dec, _ = t_model.decode_step(t_params, t_adapters[0], torch.as_tensor(tok).long(), t_cache, t_pos)
    _close(t_dec[:, 0], j_full[:, -1], "the port's decode against JAX's forward")
    assert float(np.max(np.abs(np.asarray(j_dec[:, 0]) - np.asarray(j_full[:, -1])))) > 1e-2


def test_generate_matches_jax_and_reference(world):
    """generate(): greedy equal to JAX's token for token, with and without
    EOS; greedy and sampled equal to the port's ReferenceEngine."""
    model, params, adapters, t_model, t_params, t_adapters = world
    jax_eng, port_eng = _engines(world, cache_len=32, num_slots=2)
    ref = ReferenceEngine(t_model, t_params, t_adapters[0], cache_len=32, device="cpu")
    batch = {"tokens": _prompts(2, 8)}
    free = jax_eng.generate(batch, max_new_tokens=6)
    eos = int(free.tokens[0, 2])
    for kw in ({}, {"eos_id": eos}):
        want = jax_eng.generate(batch, max_new_tokens=6, **kw)
        got = port_eng.generate(batch, max_new_tokens=6, **kw)
        np.testing.assert_array_equal(got.tokens, want.tokens)
        assert got.steps == want.steps
    for kw in ({}, {"eos_id": eos}, {"temperature": 0.8, "seed": 5}):
        r = ref.generate(batch, max_new_tokens=6, **kw)
        s = port_eng.generate(batch, max_new_tokens=6, **kw)
        np.testing.assert_array_equal(s.tokens, r.tokens)
        assert s.steps == r.steps
    assert port_eng.stats["batch_loop_calls"] == 5


def test_continuous_slot_reuse_matches_jax(world):
    """5 requests through 2 slots: every slot is reused, the greedy streams
    equal JAX's, and every completion (the sampled one too) equals a solo
    ReferenceEngine run of its request."""
    model, params, adapters, t_model, t_params, t_adapters = world
    toks = _prompts(5, 8)
    budgets = [6, 3, 6, 4, 6]
    greedy = [i for i in range(5) if i != 3]
    jax_eng, port_eng = _engines(world, cache_len=32, num_slots=2, max_new_cap=8)
    jc = _drain(jax_eng, JRequest, [dict(tokens=toks[i], sampling=JSamplingParams(max_new_tokens=budgets[i]))
                                    for i in greedy])
    samplings = [SamplingParams(max_new_tokens=b) for b in budgets]
    samplings[3] = SamplingParams(max_new_tokens=4, temperature=0.5, seed=3)
    tc = _drain(port_eng, Request, [dict(tokens=toks[i], sampling=sp) for i, sp in enumerate(samplings)])
    assert port_eng.stats["completed"] == 5 and port_eng.scheduler.active == 0
    _same_streams(jc, [tc[i] for i in greedy])
    ref = ReferenceEngine(t_model, t_params, t_adapters[0], cache_len=32, device="cpu")
    for i, (c, sp) in enumerate(zip(tc, samplings)):
        solo = ref.generate({"tokens": toks[i:i + 1]}, max_new_tokens=sp.max_new_tokens,
                            temperature=sp.temperature, seed=sp.seed)
        np.testing.assert_array_equal(c.tokens, solo.tokens[0])
        assert c.finish_reason == "length" and c.steps == sp.max_new_tokens
        assert c.ttft_s is not None and c.ttft_s >= 0.0


def test_continuous_eos_finish_matches_jax(world):
    """A request whose EOS fires mid-stream retires early with reason 'eos'
    and a truncated stream while its co-resident runs to budget, as in JAX."""
    model, params, adapters, t_model, t_params, t_adapters = world
    toks = _prompts(2, 8)
    ref = ReferenceEngine(t_model, t_params, t_adapters[0], cache_len=32, device="cpu")
    free = ref.generate({"tokens": toks[:1]}, max_new_tokens=6).tokens[0]
    eos = int(free[2])
    jax_eng, port_eng = _engines(world, cache_len=32, num_slots=2, max_new_cap=8)
    reqs = [(toks[0], dict(max_new_tokens=6, eos_id=eos)), (toks[1], dict(max_new_tokens=6))]
    jc = _drain(jax_eng, JRequest, [dict(tokens=t, sampling=JSamplingParams(**kw)) for t, kw in reqs])
    tc = _drain(port_eng, Request, [dict(tokens=t, sampling=SamplingParams(**kw)) for t, kw in reqs])
    _same_streams(jc, tc)
    first_hit = int(np.where(free == eos)[0][0])
    assert tc[0].finish_reason == "eos"
    np.testing.assert_array_equal(tc[0].tokens, free[:first_hit + 1])
    assert tc[1].finish_reason == "length" and tc[1].steps == 6


def test_multi_adapter_routing_matches_jax(world):
    """Co-resident requests on three adapters: greedy streams equal JAX's,
    and each equals a dedicated single-adapter engine (the per-row LoRA
    branch computes what the shared one does, exactly on the CPU)."""
    model, params, adapters, t_model, t_params, t_adapters = world
    toks = _prompts(3, 8)
    jax_eng, port_eng = _engines(world, cache_len=32, num_slots=4, max_new_cap=8, n_adapters=3)
    jc = _drain(jax_eng, JRequest, [dict(tokens=toks[i], sampling=JSamplingParams(max_new_tokens=5),
                                         adapter_id=i) for i in range(3)])
    tc = _drain(port_eng, Request, [dict(tokens=toks[i], sampling=SamplingParams(max_new_tokens=5),
                                         adapter_id=i) for i in range(3)])
    _same_streams(jc, tc)
    for i, c in enumerate(tc):
        solo = ReferenceEngine(t_model, t_params, t_adapters[i], cache_len=32, device="cpu")
        np.testing.assert_array_equal(c.tokens, solo.generate({"tokens": toks[i:i + 1]}, max_new_tokens=5).tokens[0])
    assert len({tuple(c.tokens) for c in tc}) == 3
    with pytest.raises(ValueError):
        port_eng.submit(Request(tokens=toks[0], adapter_id=3))


def test_ring_prompt_longer_than_cache_matches_jax(world):
    """Prompts longer than the cache (S 40 > cache_len 32, ring layout: the
    prefill keeps the last 32 positions, rolled) beside short ones, in two
    shape groups; budgets clamp to the cache's room, none for the long
    prompts (JAX's rule)."""
    toks_long, toks_short = _prompts(2, 40, seed=3), _prompts(2, 8, seed=4)
    jax_eng, port_eng = _engines(world, cache_len=32, num_slots=4, max_new_cap=12, n_adapters=2)
    reqs = [(toks_long[0], 0, 12), (toks_short[0], 1, 5), (toks_long[1], 1, 6), (toks_short[1], 0, 12)]
    jc = _drain(jax_eng, JRequest, [dict(tokens=t, adapter_id=a, sampling=JSamplingParams(max_new_tokens=b))
                                    for t, a, b in reqs])
    tc = _drain(port_eng, Request, [dict(tokens=t, adapter_id=a, sampling=SamplingParams(max_new_tokens=b))
                                    for t, a, b in reqs])
    _same_streams(jc, tc)
    assert [c.steps for c in tc] == [0, 5, 0, 12]  # 32 - 40 clamps to 0; 32 - 8 leaves the budgets


def test_sampled_stream_is_independent_of_coresidents(world):
    """A sampled request's tokens depend on its own seed alone: alone, with
    greedy co-residents, and with other sampled co-residents that admit
    and retire around it."""
    model, params, adapters, t_model, t_params, t_adapters = world
    toks = _prompts(4, 8, seed=7)
    target = dict(tokens=toks[0], sampling=SamplingParams(max_new_tokens=7, temperature=0.8, seed=11),
                  adapter_id=1)
    mixes = [
        [],
        [dict(tokens=toks[1], sampling=SamplingParams(max_new_tokens=2))],
        [dict(tokens=toks[2], sampling=SamplingParams(max_new_tokens=3, temperature=1.0, seed=1), adapter_id=2),
         dict(tokens=toks[3], sampling=SamplingParams(max_new_tokens=5, temperature=0.5, seed=2))],
    ]
    streams = []
    for others in mixes:
        _, port_eng = _engines(world, cache_len=32, num_slots=2, max_new_cap=8, n_adapters=3)
        comps = _drain(port_eng, Request, [dict(target)] + [dict(o) for o in others])
        streams.append(comps[0].tokens)
    for s in streams[1:]:
        np.testing.assert_array_equal(s, streams[0])
    greedy = _drain(_engines(world, cache_len=32, num_slots=2, max_new_cap=8, n_adapters=3)[1], Request,
                    [dict(target, sampling=SamplingParams(max_new_tokens=7))])[0].tokens
    assert not np.array_equal(streams[0], greedy)  # it did sample


def test_serve_telemetry_is_bit_identical_and_reconciles(world):
    """Serving with telemetry gives the same tokens; its spans nest, and its
    counters equal the engine's own accounting."""
    toks = _prompts(5, 8, seed=9)
    reqs = [dict(tokens=toks[i], adapter_id=i % 3,
                 sampling=SamplingParams(max_new_tokens=3 + i, temperature=0.7 if i == 2 else 0.0, seed=i))
            for i in range(5)]
    _, off = _engines(world, cache_len=32, num_slots=2, max_new_cap=8, n_adapters=3)
    tel = Telemetry(run_id="serve")
    model, params, adapters, t_model, t_params, t_adapters = world
    on = ServeEngine(t_model, t_params, t_adapters[0], adapters=t_adapters[1:], cache_len=32, num_slots=2,
                     max_new_cap=8, telemetry=tel, device="cpu")
    c_off, c_on = _drain(off, Request, [dict(r) for r in reqs]), _drain(on, Request, [dict(r) for r in reqs])
    for a, b in zip(c_off, c_on):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    check_spans(tel.tracer.events)
    snap = tel.snapshot()
    names = [e["name"] for e in tel.tracer.events if e["type"] == "span"]
    assert names.count("segment") == on.stats["segment_calls"]
    assert names.count("prefill") == on.stats["prefill_calls"]
    assert snap["counters"]["serve.completed"] == on.stats["completed"] == 5
    assert snap["counters"]["serve.tokens_emitted"] == sum(c.steps for c in c_on)
    assert snap["counters"]["serve.decode_steps"] == on.stats["decode_steps"]
    assert snap["histograms"]["serve.ttft_s"]["count"] == 5
    assert snap["gauges"]["serve.useful_tokens_per_s"] > 0


@pytest.mark.parametrize("sched_cls", [JSlotScheduler, SlotScheduler], ids=["jax", "port"])
def test_scheduler_invariants(sched_cls):
    req_cls = JRequest if sched_cls is JSlotScheduler else Request
    sched = sched_cls(2)
    reqs = [req_cls(tokens=np.zeros(8, np.int32)) for _ in range(3)]
    for r in reqs:
        sched.enqueue(r)
    groups = sched.admissions()
    assert len(groups) == 1
    slots, admitted = groups[0]
    assert slots == [0, 1] and admitted == reqs[:2]
    assert sched.queued == 1 and sched.free == 0
    assert sched.admissions() == []
    assert sched.release(0) is reqs[0]
    with pytest.raises(RuntimeError):
        sched.release(0)
    (slots2, admitted2), = sched.admissions()
    assert slots2 == [0] and admitted2 == [reqs[2]]
    with pytest.raises(ValueError):
        sched_cls(0)


@pytest.mark.parametrize("sched_cls", [JSlotScheduler, SlotScheduler], ids=["jax", "port"])
def test_scheduler_groups_by_shape_signature(sched_cls):
    req_cls = JRequest if sched_cls is JSlotScheduler else Request
    sched = sched_cls(8)
    short = [req_cls(tokens=np.zeros(4, np.int32)) for _ in range(2)]
    long = [req_cls(tokens=np.zeros(16, np.int32)) for _ in range(2)]
    for r in short + long:
        sched.enqueue(r)
    groups = sched.admissions()
    assert [len(rs) for _s, rs in groups] == [2, 2]
    assert groups[0][1] == short and groups[1][1] == long
    used = [s for slots, _rs in groups for s in slots]
    assert len(used) == len(set(used))


def test_engines_need_cuda_unless_asked_for_cpu(world, monkeypatch):
    model, params, adapters, t_model, t_params, t_adapters = world
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(t_model, t_params, t_adapters[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        ReferenceEngine(t_model, t_params, t_adapters[0])
    assert ServeEngine(t_model, t_params, t_adapters[0], device="cpu").device.type == "cpu"


def test_make_prompt_batch_takes_torch_and_numpy_rngs():
    cfg = torch_config(CFG)
    a = make_prompt_batch(cfg, 3, 2, 5)
    b = make_prompt_batch(cfg, np.random.default_rng(3), 2, 5)
    c = make_prompt_batch(cfg, torch.Generator().manual_seed(3), 2, 5)
    assert a["tokens"].dtype == c["tokens"].dtype == np.int32 and c["tokens"].shape == (2, 5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert c["tokens"].min() >= 0 and c["tokens"].max() < cfg.vocab_size


def test_serve_launcher_runs_reduced_on_cpu(capsys):
    from repro_torch.launch.serve import main

    res = main(["--arch", "qwen2-0.5b", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
                "--new-tokens", "3"])
    assert res.tokens.shape == (2, 3) and res.steps == 3
    assert "qwen2-0.5b: 3 steps x batch 2" in capsys.readouterr().out


def test_batch_from_requests_defaults_to_the_card(monkeypatch):
    """``batch_from_requests`` without a device puts the batch on the card:
    without one it raises the port's no-device error, and ``device="cpu"``
    must be asked for."""
    from repro_torch.serve import batch_from_requests

    reqs = [Request(tokens=np.arange(4, dtype=np.int32) + i, extras={"encoder_embeds": np.ones((2, 3), np.float32)})
            for i in range(2)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch_from_requests(reqs)
    batch = batch_from_requests(reqs, "cpu", torch.bfloat16)
    assert batch["tokens"].device.type == "cpu" and batch["tokens"].dtype == torch.int64
    assert torch.equal(batch["tokens"], torch.arange(4)[None] + torch.arange(2)[:, None])
    assert batch["encoder_embeds"].shape == (2, 2, 3) and batch["encoder_embeds"].dtype == torch.bfloat16
