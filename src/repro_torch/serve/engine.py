"""Serving engines: the continuous-batching :class:`ServeEngine` and the
seed :class:`ReferenceEngine` (port of ``repro.serve.engine``).

:class:`ReferenceEngine` is the seed host loop: one decode call (plus a
sample) per token, every request barriered on the longest sequence, one
adapter. It is the oracle of :meth:`ServeEngine.generate`.

:class:`ServeEngine` is the production path:

* **Decode segments on the card.** The JAX package runs a segment as one
  jitted ``while_loop``. Here it is a loop of decode steps over device
  tensors: recording, EOS, budgets and per-slot positions stay on the card,
  and each step brings one small tensor to the host, the loop condition
  with the live-row mask, so the host knows whether to go on and which
  sampled rows draw.
* **Continuous batching.** Requests enter through :meth:`submit`; a
  :class:`~repro_torch.serve.scheduler.SlotScheduler` admits queued
  requests into freed cache slots between segments (:meth:`step`). A
  segment stops early only when a slot frees up and the queue is not
  empty.
* **Multi-adapter routing.** Each request names an adapter of the engine's
  registry (``adapters``); slots gather their adapter's LoRA out of a
  stacked tree (:func:`repro_torch.lora.gather_adapter_slots`), so one
  decode step serves every tenant. On the card that per-row LoRA delta is
  the multi-adapter kernel (B7) and prefill's prompt attention the flash
  attention kernel (B8), through the model (``models/transformer.py``).

Sampling cannot replay ``jax.random``. Every stream here is drawn from an
explicit ``torch.Generator`` seeded from ``SamplingParams.seed``: a token is
``argmax(logits / T + g)`` with Gumbel noise ``g`` made from ``V`` uniforms
of that generator (the Gumbel-max form of a categorical draw, as
``jax.random.categorical`` samples). The batch path (:meth:`generate`) draws
the whole batch from one generator per step, exactly as
:class:`ReferenceEngine` does. In continuous batching each request owns its
generator, advanced only by its own draws (its first token and each decode
step while it is live), so a request's stream is a function of that request
alone, as the JAX package's chained ``fold_in`` keys make it.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.fibecfed import resolve_device
from repro_torch.lora import gather_adapter_slots, stack_adapter_trees
from repro_torch.models.model_api import ModelFns
from repro_torch.models.transformer import torch_dtype
from repro_torch.obs import ensure as ensure_telemetry
from repro_torch.serve.requests import (
    Completion,
    Request,
    SamplingParams,
    batch_from_requests,
    device_batch,
    requests_from_batch,
)
from repro_torch.serve.scheduler import SlotScheduler
from repro_torch.utils.tree import tree_map


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray  # (B, max_new_tokens) int32
    steps: int


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def _gumbel(gen: torch.Generator, shape, device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))


def _stochastic(lg: torch.Tensor, temps: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Categorical draws of rows ``lg`` (n, V) f32 at temperatures ``temps``
    (n,) f32 from Gumbel ``noise`` (n, V): the one formula of every path."""
    return torch.argmax(lg / temps[:, None] + noise, dim=-1)


def _sample_batch(logits: torch.Tensor, gen: torch.Generator, temperature: float) -> torch.Tensor:
    """The batch paths' sample: argmax, or one (B, V) draw of ``gen``."""
    lg = logits[:, -1].to(torch.float32)
    if temperature == 0.0:
        return torch.argmax(lg, dim=-1)
    temps = torch.full((lg.shape[0],), temperature, dtype=torch.float32, device=lg.device)
    return _stochastic(lg, temps, _gumbel(gen, lg.shape, lg.device))


def _on(tree, device):
    return tree_map(lambda t: t.to(device), tree)


class ReferenceEngine:
    """The seed synchronous engine (a host-side decode loop), kept as the
    oracle of :meth:`ServeEngine.generate`. Do not optimize.

    ``device=None`` is the CUDA device (an error without one); the params
    and LoRA trees are moved there."""

    def __init__(self, model: ModelFns, params, lora, *, cache_len: int = 1024, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.params = _on(params, self.device)
        self.lora = _on(lora, self.device)
        self.cache_len = cache_len

    @torch.no_grad()
    def generate(self, batch: Dict[str, Any], *, max_new_tokens: int = 32, temperature: float = 0.0,
                 eos_id: Optional[int] = None, seed: int = 0) -> GenerationResult:
        batch = device_batch(batch, self.device, torch_dtype(self.model.cfg.dtype))
        logits, cache, pos = self.model.prefill(self.params, self.lora, batch, self.cache_len)
        gen = _generator(self.device, seed)
        B = logits.shape[0]
        out = np.zeros((B, max_new_tokens), np.int32)
        token = _sample_batch(logits, gen, temperature)[:, None]
        done = np.zeros(B, bool)
        steps = 0
        for i in range(max_new_tokens):
            tok = token[:, 0].cpu().numpy()
            if eos_id is not None:
                # finished rows stay pinned at EOS while the rest of the
                # batch keeps decoding: their post-EOS samples never reach
                # the output
                tok = np.where(done, eos_id, tok).astype(np.int32)
                done |= tok == eos_id
            out[:, i] = tok
            if eos_id is not None and done.all():
                steps = i + 1
                break
            logits, cache = self.model.decode_step(self.params, self.lora, token, cache, pos)
            token = _sample_batch(logits, gen, temperature)[:, None]
            pos = pos + 1
            steps = i + 1
        return GenerationResult(tokens=out, steps=steps)


class ServeEngine:
    """Continuous-batching engine over a decode-capable ModelFns.

    Two surfaces:

    * :meth:`generate(batch, ...)`: the blocking batch call, a thin
      batch-of-requests wrapper over :class:`Request`; it reproduces
      :class:`ReferenceEngine` token for token (the same generator, the same
      draws in the same order, the same EOS pinning).
    * :meth:`submit` / :meth:`step` / :meth:`drain`: continuous batching.
      ``submit`` enqueues a Request; ``step`` admits queued requests into
      free slots (one batched prefill per shape group), runs one decode
      segment and returns the finished :class:`Completion` s; ``drain``
      steps until idle. Requests route to per-request adapters
      (``adapter_id`` indexes ``[lora, *adapters]``).

    ``max_new_cap`` bounds a request's ``max_new_tokens`` (it sizes the
    per-slot output buffer); with cached attention (every family but ssm,
    whose state has a constant size) budgets are also clamped to the
    cache's room, ``cache_len - S``, S the prefill's length (a vlm's prefix
    rows included). A request's ``extras`` (a vlm's ``prefix_embeds``, an
    encoder-decoder's ``encoder_embeds``) reach its group's prefill; an
    encoder-decoder's cross-attention cache rides the slot axis with the
    self cache. The encoder family has no decode path: its prefill raises. ``device=None`` is the CUDA device (an error
    without one); the params and adapters are moved there.
    """

    def __init__(self, model: ModelFns, params, lora, *, cache_len: int = 1024, num_slots: int = 8,
                 adapters: Optional[List[Any]] = None, max_new_cap: int = 128, telemetry: Any = None,
                 device=None):
        self.device = resolve_device(device)
        self.model = model
        self.tel = ensure_telemetry(telemetry)
        self.params = _on(params, self.device)
        self.lora = _on(lora, self.device)
        self.cache_len = cache_len
        self.num_slots = num_slots
        self.max_new_cap = max_new_cap
        self.adapters = [self.lora] + [_on(a, self.device) for a in adapters or []]
        self._single = len(self.adapters) == 1
        self._stacked = None if self._single else stack_adapter_trees(self.adapters)
        self.scheduler = SlotScheduler(num_slots, telemetry=self.tel)
        self._state: Optional[Dict[str, Any]] = None
        self._gens: List[Optional[torch.Generator]] = [None] * num_slots
        self._temps: List[float] = [0.0] * num_slots
        self._ttft: Dict[int, float] = {}
        self._serve_t0: Optional[float] = None  # first admission (wall)
        self._rid = itertools.count()
        self.stats = {
            "prefill_calls": 0,
            "batch_loop_calls": 0,
            "segment_calls": 0,
            "decode_steps": 0,
            "admitted": 0,
            "completed": 0,
        }

    # ------------------------------------------------------------------
    # batch path (token for token ReferenceEngine)
    # ------------------------------------------------------------------

    def _batch_loop(self, token, gen, cache, pos, eos: int, max_new: int, temperature: float):
        """The reference loop with its state on the card. The host reads one
        flag per step, and only with an EOS (whether every row is done)."""
        B = token.shape[0]
        out = torch.zeros((B, max_new), dtype=torch.int64, device=self.device)
        done = torch.zeros((B,), dtype=torch.bool, device=self.device)
        steps = 0
        more = max_new > 0
        while more:
            tok = token[:, 0]
            if eos >= 0:
                tok = torch.where(done, eos, tok)
                done = done | (tok == eos)
            out[:, steps] = tok
            steps += 1
            # the reference runs one final wasted decode before its loop
            # exits; skipping it only drops discarded state
            more = steps < max_new and not (eos >= 0 and bool(done.all()))
            if more:
                logits, cache = self.model.decode_step(self.params, self.lora, token, cache, pos)
                token = _sample_batch(logits, gen, temperature)[:, None]
                pos = pos + 1
        return out, steps

    def generate(self, batch: Dict[str, Any], *, max_new_tokens: int = 32, temperature: float = 0.0,
                 eos_id: Optional[int] = None, seed: int = 0) -> GenerationResult:
        """Blocking batch call: one Request per row, run as a uniform batch
        (token for token :class:`ReferenceEngine`)."""
        sp = SamplingParams(max_new_tokens=max_new_tokens, temperature=temperature, eos_id=eos_id, seed=seed)
        return self.generate_requests(requests_from_batch(batch, sp))

    @torch.no_grad()
    def generate_requests(self, reqs: List[Request]) -> GenerationResult:
        """Run same-shape, same-SamplingParams requests as one batch."""
        sp = reqs[0].sampling
        if any(r.sampling != sp for r in reqs):
            raise ValueError("generate_requests needs uniform SamplingParams")
        if any(r.adapter_id != 0 for r in reqs):
            raise ValueError("the batch path serves adapter 0; use submit()")
        batch = batch_from_requests(reqs, self.device, torch_dtype(self.model.cfg.dtype))
        logits, cache, pos = self.model.prefill(self.params, self.lora, batch, self.cache_len)
        self.stats["prefill_calls"] += 1
        gen = _generator(self.device, sp.seed)
        token = _sample_batch(logits, gen, sp.temperature)[:, None]
        eos = -1 if sp.eos_id is None else sp.eos_id
        out, steps = self._batch_loop(token, gen, cache, pos, eos, sp.max_new_tokens, sp.temperature)
        self.stats["batch_loop_calls"] += 1
        return GenerationResult(tokens=out.cpu().numpy().astype(np.int32), steps=steps)

    # ------------------------------------------------------------------
    # continuous batching: submit / step / drain
    # ------------------------------------------------------------------

    def submit(self, req: Request) -> int:
        """Enqueue a request; returns its request_id."""
        if not (0 <= req.adapter_id < len(self.adapters)):
            raise ValueError(f"adapter_id {req.adapter_id} outside registry [0, {len(self.adapters)})")
        if req.request_id is None:
            req.request_id = next(self._rid)
        req.submit_time = time.perf_counter()
        self.scheduler.enqueue(req)
        if self.tel.enabled:
            self.tel.metrics.counter("serve.submitted").inc()
            self.tel.instant("submit", cat="serve", track="serve",
                             args={"request_id": req.request_id, "adapter_id": req.adapter_id})
        return req.request_id

    @torch.no_grad()
    def step(self) -> List[Completion]:
        """Admit queued requests into free slots, run one decode segment,
        retire finished slots. Returns completions (maybe [])."""
        for slots, reqs in self.scheduler.admissions():
            self._admit_group(slots, reqs)
        if self._state is None or self.scheduler.active == 0:
            return []
        with self.tel.span("segment", cat="serve", track="serve") as sargs:
            nsteps = self._segment(stop_on_free=self.scheduler.queued > 0)
            sargs["nsteps"] = nsteps  # the segment read its last flag: the span covers device time
        if self.tel.enabled:
            m = self.tel.metrics
            m.counter("serve.segments").inc()
            m.counter("serve.decode_steps").inc(nsteps)
        self.stats["segment_calls"] += 1
        self.stats["decode_steps"] += nsteps
        return self._retire()

    def drain(self) -> List[Completion]:
        """Step until every queued and resident request has completed."""
        comps: List[Completion] = []
        while self.scheduler.queued or self.scheduler.active:
            comps.extend(self.step())
        return comps

    def reset(self) -> None:
        """Drop all slot state and queued work."""
        self.scheduler = SlotScheduler(self.num_slots, telemetry=self.tel)
        self._state = None
        self._gens = [None] * self.num_slots
        self._temps = [0.0] * self.num_slots
        self._ttft = {}
        self._serve_t0 = None
        self.stats = {k: 0 for k in self.stats}

    # -- internals ------------------------------------------------------

    def _first_tokens(self, logits, gens: List[torch.Generator], temps: List[float]) -> torch.Tensor:
        """Per-row first tokens from prefill logits: argmax, or a draw of the
        row's own generator where its temperature is above 0."""
        lg = logits[:, -1].to(torch.float32)
        tok = torch.argmax(lg, dim=-1)
        rows = [i for i, t in enumerate(temps) if t > 0.0]
        if rows:
            noise = torch.stack([_gumbel(gens[i], lg.shape[-1:], lg.device) for i in rows])
            t = torch.tensor([temps[i] for i in rows], dtype=torch.float32, device=lg.device)
            idx = torch.tensor(rows, device=lg.device)
            tok[idx] = _stochastic(lg[idx], t, noise)
        return tok

    def _ensure_state(self, cache_template) -> None:
        if self._state is not None:
            return
        B, W, dev = self.num_slots, self.max_new_cap, self.device

        def zeros(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self._state = {
            "token": zeros(B, 1),
            "pos": zeros(B),
            "done": zeros(B, dtype=torch.bool),
            "active": zeros(B, dtype=torch.bool),
            "emitted": zeros(B),
            "budget": zeros(B),
            "eos": torch.full((B,), -1, dtype=torch.int64, device=dev),
            "temp": zeros(B, dtype=torch.float32),
            "out": zeros(B, W),
            "aidx": zeros(B),
            # every cache leaf carries the batch on axis 1
            "cache": tree_map(lambda c: zeros(c.shape[0], B, *c.shape[2:], dtype=c.dtype), cache_template),
        }

    def _admit_group(self, slots: List[int], reqs: List[Request]) -> None:
        with self.tel.span("admit", cat="serve", track="serve", args={"group": len(reqs)}):
            self._admit_group_body(slots, reqs)

    def _admit_group_body(self, slots: List[int], reqs: List[Request]) -> None:
        cfg = self.model.cfg
        dev = self.device
        if self.tel.enabled:
            t_admit = time.perf_counter()
            if self._serve_t0 is None:
                self._serve_t0 = t_admit
        batch = batch_from_requests(reqs, dev, torch_dtype(cfg.dtype))
        ids = torch.tensor([r.adapter_id for r in reqs], dtype=torch.int64, device=dev)
        lora_g = self.lora if self._single else gather_adapter_slots(cfg, self._stacked, ids)
        temps = [float(r.sampling.temperature) for r in reqs]
        gens = [_generator(dev, r.sampling.seed) for r in reqs]
        with self.tel.span("prefill", cat="serve", track="serve"):
            logits, cache_g, S = self.model.prefill(self.params, lora_g, batch, self.cache_len)
            self.stats["prefill_calls"] += 1
            tok0 = self._first_tokens(logits, gens, temps)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)  # the first token exists now: the TTFT point
        now = time.perf_counter()
        for r in reqs:
            self._ttft[r.request_id] = now - (r.submit_time or now)
        if self.tel.enabled:
            m = self.tel.metrics
            for r in reqs:
                m.histogram("serve.ttft_s").observe(self._ttft[r.request_id])
                m.histogram("serve.queue_s").observe(max(0.0, t_admit - (r.submit_time or t_admit)))
        budgets = []
        for r in reqs:
            b = min(r.sampling.max_new_tokens, self.max_new_cap)
            if cfg.family != "ssm":  # cached attention: bounded by the cache's room
                b = min(b, self.cache_len - S)
            budgets.append(max(b, 0))
        self._ensure_state(cache_g)
        st = self._state
        sl = torch.tensor(slots, dtype=torch.int64, device=dev)

        def put(name, values, dtype=torch.int64):
            st[name][sl] = torch.as_tensor(values, dtype=dtype).to(dev)

        for name in st["cache"]:
            st["cache"][name][:, sl] = cache_g[name].to(st["cache"][name].dtype)
        st["token"][sl] = tok0[:, None]
        put("pos", [S] * len(reqs))
        put("done", [False] * len(reqs), torch.bool)
        put("active", [True] * len(reqs), torch.bool)
        put("emitted", [0] * len(reqs))
        put("budget", budgets)
        put("eos", [-1 if r.sampling.eos_id is None else r.sampling.eos_id for r in reqs])
        put("temp", temps, torch.float32)
        st["out"][sl] = 0
        st["aidx"][sl] = ids
        for slot, g, t in zip(slots, gens, temps):
            self._gens[slot], self._temps[slot] = g, t
        self.stats["admitted"] += len(reqs)

    def _segment(self, *, stop_on_free: bool) -> int:
        """Decode until no row is live, or (with ``stop_on_free``) until a
        slot frees up; returns the number of decode steps."""
        st = self._state
        # gather each slot's adapter once per segment; with a single
        # registered adapter the plain (unbatched) tree is shared by all
        # slots and the decode matches the batch path exactly
        lora_t = self.lora if self._single else gather_adapter_slots(self.model.cfg, self._stacked, st["aidx"])
        B, W = st["out"].shape
        rows = torch.arange(B, device=self.device)
        sampled = [s for s in range(B) if self._temps[s] > 0.0 and self._gens[s] is not None]
        token, pos, done, emitted = st["token"], st["pos"], st["done"], st["emitted"]
        active, budget, eos, out = st["active"], st["budget"], st["eos"], st["out"]
        fin = torch.zeros((), dtype=torch.bool, device=self.device)
        nsteps = 0
        if not bool((active & ~done & (emitted < budget)).any()):
            return 0
        while True:
            tok = token[:, 0]
            # record the pending token for rows that still owe output
            rec = active & ~done & (emitted < budget)
            cols = torch.clamp(emitted, 0, W - 1)
            out[rows, cols] = torch.where(rec, tok, out[rows, cols])
            done = done | (rec & (eos >= 0) & (tok == eos))
            emitted = emitted + rec.to(torch.int64)
            lv = active & ~done & (emitted < budget)
            fin = fin | (active & ~lv).any()
            # live rows always decode their next pending token, even on the
            # step that ends the segment, or the next segment would record a
            # stale one; the segment stops early only when a slot just freed
            # and the queue has work for it
            do_dec = lv.any()
            more = do_dec & ~(fin & stop_on_free)
            flags = torch.cat([torch.stack([do_dec, more]), lv[sampled]]).tolist()  # one host read
            if flags[0]:
                nsteps += 1
                logits, st["cache"] = self.model.decode_step(self.params, lora_t, token, st["cache"], pos)
                lg = logits[:, -1].to(torch.float32)
                tok2 = torch.argmax(lg, dim=-1)
                draw = [s for s, live in zip(sampled, flags[2:]) if live]
                if draw:
                    noise = torch.stack([_gumbel(self._gens[s], lg.shape[-1:], lg.device) for s in draw])
                    idx = torch.tensor(draw, device=self.device)
                    tok2[idx] = _stochastic(lg[idx], st["temp"][idx], noise)
                token = torch.where(lv[:, None], tok2[:, None], token)
                pos = pos + lv.to(torch.int64)
            if not flags[1]:
                break
        st.update(token=token, pos=pos, done=done, emitted=emitted)
        return nsteps

    def _retire(self) -> List[Completion]:
        st = self._state
        active = st["active"].cpu().numpy()
        done = st["done"].cpu().numpy()
        emitted = st["emitted"].cpu().numpy()
        budget = st["budget"].cpu().numpy()
        fin_slots = np.flatnonzero(active & (done | (emitted >= budget)))
        if fin_slots.size == 0:
            return []
        out = st["out"].cpu().numpy().astype(np.int32)
        comps = []
        for slot in fin_slots:
            slot = int(slot)
            req = self.scheduler.release(slot)
            self._gens[slot], self._temps[slot] = None, 0.0
            n = int(emitted[slot])
            comps.append(Completion(
                request_id=req.request_id,
                tokens=out[slot, :n].copy(),
                prompt_len=int(np.asarray(req.tokens).shape[-1]),
                adapter_id=req.adapter_id,
                finish_reason="eos" if done[slot] else "length",
                steps=n,
                ttft_s=self._ttft.pop(req.request_id, None),
            ))
        st["active"][torch.as_tensor(fin_slots, device=self.device)] = False
        self.stats["completed"] += len(comps)
        if self.tel.enabled and comps:
            m = self.tel.metrics
            m.counter("serve.completed").inc(len(comps))
            for c in comps:
                m.counter("serve.tokens_emitted").inc(c.steps)
                m.histogram("serve.tokens_per_completion").observe(float(c.steps))
                self.tel.instant("complete", cat="serve", track="serve", args={
                    "request_id": c.request_id, "adapter_id": c.adapter_id, "steps": c.steps,
                    "finish_reason": c.finish_reason,
                })
            now = time.perf_counter()
            elapsed = now - (self._serve_t0 or now)
            if elapsed > 0:
                m.gauge("serve.useful_tokens_per_s").set(m.counter("serve.tokens_emitted").value / elapsed)
        return comps
