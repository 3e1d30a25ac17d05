"""Decoder-only transformer, dense, MoE and vlm (port of
``repro.models.transformer``); its layers also make the encoder family's
bidirectional stack and the encoder-decoder's blocks.

Per-layer weights are stacked on a leading layer axis, as in the JAX
package, and the layer loop is a Python loop over those slices. LoRA trees
mirror the stacked layout. Supported knobs: GQA, QKV bias, qk-norm, RoPE,
parallel residual, RMS/layer norm, SwiGLU/GELU MLP, an MoE FFN (with a
shared expert, :mod:`repro_torch.models.moe`), sliding-window attention,
logit soft-cap, tied embeddings; vlm token embeddings scaled by
sqrt(d_model), the prefix (``prefix_embeds``, the stubbed vision tower's
patch embeddings) not.

Serving: :func:`decoder_prefill` runs a prompt and fills a KV cache (in the
JAX package's ring layout when a sliding window covers the cache), and
:func:`decoder_decode_step` decodes one token per row against it, each row
at its own position. On the card the prompt attention is the flash
attention kernel (B8, ``kernels.ops.flash_attention``) and LoRA leaves with
a per-slot batch axis take the multi-adapter kernel (B7, through
``layers.linear``); on the CPU both are the plain versions the training
path uses.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models import sharding_ctx
from repro_torch.models.layers import (
    apply_rope,
    init_embed,
    init_stacked_dense,
    layer_norm,
    linear,
    rms_norm,
    soft_cap,
)
from repro_torch.models.mlp import apply_mlp, init_mlp
from repro_torch.models.moe import apply_moe, init_moe

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def init_attn_layer_stack(gen: torch.Generator, L: int, cfg: ModelConfig, dtype, device) -> Dict[str, Any]:
    """One attention's projections stacked over ``L`` layers: wq/wk/wv/wo,
    the QKV biases (zeros) and the qk-norm weights (ones) where ``cfg``
    has them."""
    hd = cfg.resolved_head_dim
    H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.d_model
    p: Dict[str, Any] = {
        "wq": init_stacked_dense(gen, L, D, H * hd, dtype, device),
        "wk": init_stacked_dense(gen, L, D, KVH * hd, dtype, device),
        "wv": init_stacked_dense(gen, L, D, KVH * hd, dtype, device),
        "wo": init_stacked_dense(gen, L, H * hd, D, dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((L, H * hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((L, KVH * hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((L, KVH * hd), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm_w"] = torch.ones((L, hd), dtype=dtype, device=device)
        p["k_norm_w"] = torch.ones((L, hd), dtype=dtype, device=device)
    return p


def init_decoder(gen: torch.Generator, cfg: ModelConfig, device) -> Dict[str, Any]:
    """Frozen base weights drawn from ``gen`` (a generator on ``device``)."""
    dtype = torch_dtype(cfg.dtype)
    D, L = cfg.d_model, cfg.num_layers
    layers = init_attn_layer_stack(gen, L, cfg, dtype, device)
    for name in ("attn_norm", "mlp_norm"):
        layers[f"{name}_w"] = torch.ones((L, D), dtype=dtype, device=device)
        if cfg.norm == "layernorm":
            layers[f"{name}_b"] = torch.zeros((L, D), dtype=dtype, device=device)
    if cfg.family == "moe":
        layers.update(init_moe(gen, L, D, cfg.moe, dtype, device))
    else:
        layers.update(init_mlp(gen, L, D, cfg.d_ff, cfg.mlp, dtype, device))
    params = {
        "embed": init_embed(gen, cfg.vocab_size, D, dtype, device),
        "layers": layers,
        "final_norm_w": torch.ones((D,), dtype=dtype, device=device),
    }
    if cfg.norm == "layernorm":
        params["final_norm_b"] = torch.zeros((D,), dtype=dtype, device=device)
    if not cfg.tie_embeddings:
        params["lm_head"] = init_stacked_dense(gen, 1, D, cfg.vocab_size, dtype, device)[0]
    return params


def _norm(h, p, name, kind):
    if kind == "layernorm":
        return layer_norm(h, p[f"{name}_w"], p[f"{name}_b"])
    return rms_norm(h, p[f"{name}_w"])


def _project_qkv(x, p, lora, cfg: ModelConfig, lora_scale):
    hd = cfg.resolved_head_dim
    lget = (lambda k: lora.get(k) if lora else None)

    def proj(w, b):
        return linear(x, {"w": p[w], **({"b": p[b]} if b in p else {})}, lget(w), lora_scale)

    B, S = x.shape[0], x.shape[1]
    # a tensor-parallel projection keeps its shards only over whole KV heads
    heads = lambda t, n: sharding_ctx.unshard_unless(t, -1, cfg.num_kv_heads).reshape(B, S, n, hd)  # noqa: E731
    q = heads(proj("wq", "bq"), cfg.num_heads)
    k = heads(proj("wk", "bk"), cfg.num_kv_heads)
    v = heads(proj("wv", "bv"), cfg.num_kv_heads)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm_w"])
        k = rms_norm(k, p["k_norm_w"])
    return q, k, v


def attention_sublayer(x, p, lora, cfg: ModelConfig, positions, *, lora_scale: float,
                       causal: bool = True, cache=None, cache_position=None, ring: bool = False):
    """Self-attention over ``x``. Returns ``(out, cache_or_None)``; with
    ``cache``, a (k_cache, v_cache) pair of (B, T, KVH, D), it decodes one
    token per row at ``cache_position`` (scalar or (B,)) and writes its KV
    into the caches in place."""
    q, k, v = _project_qkv(x, p, lora, cfg, lora_scale)
    q = apply_rope(q, positions, theta=cfg.rope_theta, mode=cfg.rope)
    k = apply_rope(k, positions, theta=cfg.rope_theta, mode=cfg.rope)
    if cache is not None:
        k_cache, v_cache = cache
        T = k_cache.shape[1]
        slot = (cache_position % T) if ring else cache_position
        attn.scatter_decode_kv(*sharding_ctx.local_write(k_cache, k), slot)
        attn.scatter_decode_kv(*sharding_ctx.local_write(v_cache, v), slot)
        o = sharding_ctx.local_heads(attn.decode_attention, q, k_cache, v_cache, cache_position, ring=ring,
                                     window=cfg.attention_window)
    else:
        o = sharding_ctx.local_heads(attn.blockwise_attention, q, k, v, causal=causal,
                                     window=cfg.attention_window, score_dtype=torch_dtype(cfg.attn_score_dtype))
    B, S = x.shape[0], x.shape[1]
    o = o.reshape(B, S, cfg.num_heads * cfg.resolved_head_dim)
    out = linear(o, {"w": p["wo"]}, lora.get("wo") if lora else None, lora_scale)
    return out, cache


def decoder_layer(h, p, lora, cfg: ModelConfig, positions, *, lora_scale, causal=True,
                  cache=None, cache_position=None, ring=False, sample_weight=None):
    """One transformer block over one layer's slices. Returns ``(h,
    aux_loss, cache_or_None)`` (see :func:`attention_sublayer`; the aux loss
    is the MoE router's, None for a dense FFN)."""
    x = _norm(h, p, "attn_norm", cfg.norm)
    attn_out, cache = attention_sublayer(x, p, lora, cfg, positions, lora_scale=lora_scale, causal=causal,
                                         cache=cache, cache_position=cache_position, ring=ring)
    h, aux = _residual(h, x, attn_out, p, lora, cfg, lora_scale, sample_weight)
    return h, aux, cache


def _ffn(x, p, cfg: ModelConfig, lora, lora_scale, sample_weight=None):
    """The block's FFN: ``(out, aux_loss)``, the MoE's (``sample_weight``
    (B,) restricting its aux loss to valid samples) or the MLP's with no
    aux loss (None)."""
    if cfg.family == "moe":
        return apply_moe(x, p, cfg.moe, sample_weight=sample_weight)
    return apply_mlp(x, p, cfg.mlp, lora, lora_scale), None


def _residual(h, x, attn_out, p, lora, cfg: ModelConfig, lora_scale, sample_weight=None):
    """A block's residual step after attention: ``(h, aux_loss)``, ``h``
    plus ``attn_out`` and the FFN, the FFN over the attention's input ``x``
    under ``cfg.parallel_residual``, else over the normed ``h + attn_out``."""
    if cfg.parallel_residual:
        out, aux = _ffn(x, p, cfg, lora, lora_scale, sample_weight)
        return h + attn_out + out, aux
    h = h + attn_out
    out, aux = _ffn(_norm(h, p, "mlp_norm", cfg.norm), p, cfg, lora, lora_scale, sample_weight)
    return h + out, aux


def _layer_slices(params, lora, i):
    p_slice = {k: v[i] for k, v in params["layers"].items()}
    lora_slice = {t: {n: x[i] for n, x in ab.items()} for t, ab in lora.items()}
    return p_slice, lora_slice


def _lm_logits(h, params, cfg: ModelConfig):
    if cfg.norm == "layernorm":
        h = layer_norm(h, params["final_norm_w"], params["final_norm_b"])
    else:
        h = rms_norm(h, params["final_norm_w"])
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return soft_cap(h @ w.to(h.dtype), cfg.logit_soft_cap)


def _embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Token embeddings, scaled by sqrt(d_model) for the vlm family (Gemma's
    convention: the scale, an f32 sqrt, cast to the embedding dtype first)."""
    h = sharding_ctx.replicate_partial(torch.nn.functional.embedding(tokens, params["embed"]))
    if cfg.family == "vlm":
        h = h * torch.sqrt(torch.tensor(float(cfg.d_model), dtype=torch.float32)).to(h.dtype)
    return h


def _embed_inputs(params, tokens: torch.Tensor, cfg: ModelConfig,
                  prefix_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings (B, S, D) (:func:`_embed_tokens`), with
    ``prefix_embeds`` (B, P, D), cast to the embedding dtype and not
    scaled, prepended: (B, P + S, D)."""
    h = _embed_tokens(params, tokens, cfg)
    if prefix_embeds is not None:
        h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
    return h


def decoder_forward(params, lora, tokens: torch.Tensor, cfg: ModelConfig, *,
                    prefix_embeds: Optional[torch.Tensor] = None,
                    lora_scale: Optional[float] = None,
                    embed_noise: Optional[torch.Tensor] = None,
                    collect_layer_norms: bool = False,
                    sample_weight: Optional[torch.Tensor] = None):
    """Training/eval forward. Returns ``(logits (B, S_total, V), aux_loss)``,
    S_total the prefix's P (``prefix_embeds`` (B, P, D), prepended to the
    token embeddings: FedPrompt's soft prompt) plus the tokens' S.

    ``embed_noise`` (B, S_total, D) is added to the embedding output (the
    FibecFed GAL-sensitivity probe, paper Eq. 6-9). With
    ``collect_layer_norms`` the per-layer per-sample Frobenius norms of the
    hidden states come back as a third output (num_layers, B).
    ``sample_weight`` (B,) restricts the MoE load-balance aux loss (the sum
    over layers) to valid samples (padded-batch training); logits are
    unaffected.
    """
    lora_scale = lora_scale if lora_scale is not None else cfg.lora_alpha / cfg.lora_rank
    h = _embed_inputs(params, tokens, cfg, prefix_embeds)
    if embed_noise is not None:
        h = h + embed_noise.to(h.dtype)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    norms = []
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(cfg.num_layers):
        p_slice, lora_slice = _layer_slices(params, lora, i)
        h, aux_l, _ = decoder_layer(h, p_slice, lora_slice, cfg, positions, lora_scale=lora_scale,
                                    sample_weight=sample_weight)
        if cfg.seq_parallel:
            h = sharding_ctx.constrain(h, ("dp", "model", None))
        if aux_l is not None:
            aux = aux + aux_l
        if collect_layer_norms:
            norms.append(torch.sqrt(torch.sum(torch.square(h.to(torch.float32)), dim=(1, 2))))
    logits = _lm_logits(h, params, cfg)
    if collect_layer_norms:
        return logits, aux, torch.stack(norms)
    return logits, aux


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, device, dtype=None):
    """Zero K and V caches, (num_layers, batch, max_len, KVH, head_dim) each."""
    dtype = dtype or torch_dtype(cfg.dtype)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prompt_attention(q, k, v, cfg: ModelConfig, causal: bool = True):
    """Causal (windowed) attention of a prompt, or bidirectional attention
    of an encoder's frames (``causal=False``, no window), f32 scores: the
    flash attention kernel (B8) on the card, :func:`attn.blockwise_attention`
    on the CPU."""
    window = cfg.attention_window if causal else None
    fn = kops.flash_attention if q.is_cuda else attn.blockwise_attention
    return sharding_ctx.local_heads(fn, q, k, v, causal=causal, window=window)


def decoder_prefill(params, lora, tokens: torch.Tensor, cfg: ModelConfig, cache_len: int, *,
                    prefix_embeds: Optional[torch.Tensor] = None,
                    lora_scale: Optional[float] = None):
    """Run the prompt and fill a KV cache. Returns ``(last_logits (B, 1, V),
    cache, S)``, S the prompt length (``prefix_embeds``' P included, as in
    :func:`decoder_forward`) as a Python int.

    The cache keeps the prompt's last ``min(cache_len, S)`` positions; when
    a sliding window covers the cache (``cache_len <= window``, the ring
    layout), position p lives at slot ``p % cache_len``. Each layer ends in
    :func:`decoder_layer`'s residual step, ``cfg.parallel_residual``
    included: the JAX package's prefill always adds the attention and MLP
    outputs in turn (ROADMAP.md §C, C8), so for a parallel-residual model
    (stablelm-3b) its prompt would run another network than its decode
    steps and forward.
    """
    lora_scale = lora_scale if lora_scale is not None else cfg.lora_alpha / cfg.lora_rank
    h = _embed_inputs(params, tokens, cfg, prefix_embeds)
    B, S = h.shape[0], h.shape[1]
    positions = torch.arange(S, device=h.device)[None, :]
    ring = cfg.attention_window is not None and cache_len <= cfg.attention_window
    cache = init_kv_cache(cfg, B, cache_len, h.device)
    keep = min(cache_len, S)
    for i in range(cfg.num_layers):
        p_slice, lora_slice = _layer_slices(params, lora, i)
        x = _norm(h, p_slice, "attn_norm", cfg.norm)
        q, k, v = _project_qkv(x, p_slice, lora_slice, cfg, lora_scale)
        q = apply_rope(q, positions, theta=cfg.rope_theta, mode=cfg.rope)
        k = apply_rope(k, positions, theta=cfg.rope_theta, mode=cfg.rope)
        o = prompt_attention(q, k, v, cfg).reshape(B, S, cfg.num_heads * cfg.resolved_head_dim)
        attn_out = linear(o, {"w": p_slice["wo"]}, lora_slice.get("wo"), lora_scale)
        h, _ = _residual(h, x, attn_out, p_slice, lora_slice, cfg, lora_scale)
        for name, t in (("k", k), ("v", v)):
            tail = t[:, S - keep:]
            if keep == cache_len and ring and S % cache_len:
                tail = torch.roll(tail, S % cache_len, dims=1)
            # a tensor-parallel prefill's (DTensor) tail is gathered into the plain cache
            sharding_ctx.put(cache[name][i, :, :keep], tail)
    return _lm_logits(h[:, -1:], params, cfg), cache, S


def decoder_decode_step(params, lora, token: torch.Tensor, cfg: ModelConfig, cache, position, *,
                        lora_scale: Optional[float] = None, ring: bool = False):
    """One-token step. token: (B, 1) ints; ``position`` a scalar (uniform
    batch) or a (B,) tensor of per-slot positions. Writes each row's KV into
    ``cache`` in place; returns ``(logits (B, 1, V), cache)``."""
    lora_scale = lora_scale if lora_scale is not None else cfg.lora_alpha / cfg.lora_rank
    h = _embed_tokens(params, token, cfg)
    positions = torch.as_tensor(position, device=h.device).reshape(-1, 1)
    # a cache sharded over its time axis is gathered first: a rank cannot
    # write a slot that another holds in place (a plain cache stays as it is)
    cache = {name: sharding_ctx.unshard_unless(c, 2, 1) for name, c in cache.items()}
    for i in range(cfg.num_layers):
        p_slice, lora_slice = _layer_slices(params, lora, i)
        h, _, _ = decoder_layer(h, p_slice, lora_slice, cfg, positions, lora_scale=lora_scale,
                                cache=(cache["k"][i], cache["v"][i]), cache_position=position, ring=ring)
    return _lm_logits(h, params, cfg), cache
