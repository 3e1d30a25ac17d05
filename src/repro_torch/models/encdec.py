"""Whisper-style encoder-decoder backbone (port of ``repro.models.encdec``).
[arXiv:2212.04356]

The mel-spectrogram and conv feature extractor are stubbed, as in the JAX
package: the batch's ``encoder_embeds`` (B, encoder_seq_len, d_model) are
the frame embeddings. Downstream everything is real: a bidirectional
encoder, a causal decoder with cross-attention, LayerNorm, GELU and
attention biases. Positions are sinusoidal (computed, not stored), the JAX
package's deviation from Whisper's learned decoder positions.

Parameters: ``{"encoder": {"layers", "final_norm_w", "final_norm_b"},
"decoder": {"embed", "layers", "final_norm_w", "final_norm_b"}}``, the
decoder's layers holding the self-attention's wq..wo (bq..bv) and the
cross-attention's cwq..cwo (cbq..cbv). The LoRA tree is ``{"encoder":
wq..wo (Le), "decoder": wq..wo, cwq..cwo (Ld)}``; an MLP finds no adapter.

Serving: :func:`encdec_prefill` encodes the frames once, runs the prompt
and fills the self-attention's KV cache (the ring layout under a window
that covers it) and the cross-attention's K/V (one per layer, fixed for the
request); :func:`encdec_decode_step` decodes one token per row at its own
position and writes the self cache in place. On the card the prefill's
encoder attention (bidirectional) and prompt attention (causal) are the
flash attention kernel (B8) and per-slot LoRA leaves take the multi-adapter
kernel (B7); the cross attention stays plain, as the JAX package computes
it outside any kernel (its keys are not its queries).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import sharding_ctx
from repro_torch.models.layers import init_embed, layer_norm, linear, sinusoidal_positions, sinusoidal_rows
from repro_torch.models.mlp import apply_mlp, init_mlp
from repro_torch.models.transformer import (
    _layer_slices,
    _norm,
    _project_qkv,
    init_attn_layer_stack,
    prompt_attention,
    torch_dtype,
)

def init_encdec(gen: torch.Generator, cfg: ModelConfig, device) -> Dict[str, Any]:
    """Frozen base weights drawn from ``gen`` (a generator on ``device``)."""
    dtype = torch_dtype(cfg.dtype)
    Le, Ld, D = cfg.encoder_layers, cfg.num_layers, cfg.d_model

    def norms(L, names):
        out = {}
        for nm in names:
            out[f"{nm}_w"] = torch.ones((L, D), dtype=dtype, device=device)
            out[f"{nm}_b"] = torch.zeros((L, D), dtype=dtype, device=device)
        return out

    enc_layers = init_attn_layer_stack(gen, Le, cfg, dtype, device)
    enc_layers.update(init_mlp(gen, Le, D, cfg.d_ff, "gelu", dtype, device))
    enc_layers.update(norms(Le, ("attn_norm", "mlp_norm")))
    dec_layers = init_attn_layer_stack(gen, Ld, cfg, dtype, device)
    dec_layers.update({f"c{k}": v for k, v in init_attn_layer_stack(gen, Ld, cfg, dtype, device).items()})
    dec_layers.update(init_mlp(gen, Ld, D, cfg.d_ff, "gelu", dtype, device))
    dec_layers.update(norms(Ld, ("attn_norm", "cross_norm", "mlp_norm")))

    def final():
        return {"final_norm_w": torch.ones((D,), dtype=dtype, device=device),
                "final_norm_b": torch.zeros((D,), dtype=dtype, device=device)}

    return {"encoder": {"layers": enc_layers, **final()},
            "decoder": {"embed": init_embed(gen, cfg.vocab_size, D, dtype, device), "layers": dec_layers, **final()}}


def _proj(x, p, w: str, b: str, lora, lora_scale):
    return linear(x, {"w": p[w], **({"b": p[b]} if b in p else {})}, lora.get(w) if lora else None, lora_scale)


def _heads(t, n: int, cfg: ModelConfig):
    """(B, S, n·hd) -> (B, S, n, hd); a tensor-parallel projection keeps its
    shards only over whole KV heads (``sharding_ctx.unshard_unless``)."""
    t = sharding_ctx.unshard_unless(t, -1, cfg.num_kv_heads)
    return t.reshape(t.shape[0], t.shape[1], n, cfg.resolved_head_dim)


def _cross_q(x, p, lora, cfg: ModelConfig, lora_scale):
    return _heads(_proj(x, p, "cwq", "cbq", lora, lora_scale), cfg.num_heads, cfg)


def _encode_kv(enc_out, p, lora, cfg: ModelConfig, lora_scale):
    """The cross-attention's K and V of one decoder layer over the encoder's
    output, (B, S_enc, KVH, hd) each."""
    k = _heads(_proj(enc_out, p, "cwk", "cbk", lora, lora_scale), cfg.num_kv_heads, cfg)
    v = _heads(_proj(enc_out, p, "cwv", "cbv", lora, lora_scale), cfg.num_kv_heads, cfg)
    return k, v


def _layer_norms(h):
    return torch.sqrt(torch.sum(torch.square(h.to(torch.float32)), dim=(1, 2)))


def encode(params, lora, frame_embeds: torch.Tensor, cfg: ModelConfig, lora_scale: float, *,
           collect_layer_norms: bool = False, kernel: bool = False):
    """The bidirectional encoder over ``frame_embeds`` (B, S_enc, D), the
    sinusoidal table added in their dtype. Returns (B, S_enc, D), and with
    ``collect_layer_norms`` also the per-layer Frobenius norms (Le, B).
    ``kernel``: the attention is B8 (``causal=False``) on CUDA tensors, the
    prefill's route; otherwise blockwise attention, the training path's.
    An encoder layer's LoRA group holds only attention targets, so the MLP
    finds no adapter (as in the JAX package)."""
    B, S, D = frame_embeds.shape
    h = frame_embeds + sinusoidal_positions(S, D, frame_embeds.dtype, frame_embeds.device)[None]
    enc = params["encoder"]
    norms = []
    for i in range(cfg.encoder_layers):
        p, lr = _layer_slices(enc, lora["encoder"], i)
        x = _norm(h, p, "attn_norm", "layernorm")
        q, k, v = _project_qkv(x, p, lr, cfg, lora_scale)
        if kernel:
            o = prompt_attention(q, k, v, cfg, causal=False)
        else:
            o = sharding_ctx.local_heads(attn.blockwise_attention, q, k, v, causal=False)
        h = h + linear(o.reshape(B, S, cfg.num_heads * cfg.resolved_head_dim), {"w": p["wo"]},
                       lr.get("wo") if lr else None, lora_scale)
        h = h + apply_mlp(_norm(h, p, "mlp_norm", "layernorm"), p, "gelu", lr, lora_scale)
        if collect_layer_norms:
            norms.append(_layer_norms(h))
    h = layer_norm(h, enc["final_norm_w"], enc["final_norm_b"])
    if collect_layer_norms:
        return h, torch.stack(norms)
    return h


def _cross_mlp(h, enc_out, p, lr, cfg: ModelConfig, lora_scale, cross_kv=None):
    """A decoder block after its self-attention: cross-attention over the
    encoder's K/V (``cross_kv``, or projected from ``enc_out``), then the
    MLP, each a residual step."""
    B, S = h.shape[0], h.shape[1]
    qc = _cross_q(_norm(h, p, "cross_norm", "layernorm"), p, lr, cfg, lora_scale)
    kc, vc = cross_kv if cross_kv is not None else _encode_kv(enc_out, p, lr, cfg, lora_scale)
    oc = sharding_ctx.local_heads(attn.full_attention, qc, kc, vc, causal=False)
    h = h + _proj(oc.reshape(B, S, cfg.num_heads * cfg.resolved_head_dim), p, "cwo", "", lr, lora_scale)
    return h + apply_mlp(_norm(h, p, "mlp_norm", "layernorm"), p, "gelu", lr, lora_scale)


def _decoder_layer(h, enc_out, p, lr, cfg: ModelConfig, lora_scale, *, self_cache=None, cross_kv=None,
                   cache_position=None, ring: bool = False):
    """One decoder block: causal self-attention (over ``h``, or, with
    ``self_cache`` (k, v) of (B, T, KVH, hd), one token per row at
    ``cache_position`` written into it in place), cross-attention, MLP."""
    B, S = h.shape[0], h.shape[1]
    q, k, v = _project_qkv(_norm(h, p, "attn_norm", "layernorm"), p, lr, cfg, lora_scale)
    if self_cache is not None:
        k_c, v_c = self_cache
        slot = (cache_position % k_c.shape[1]) if ring else cache_position
        attn.scatter_decode_kv(*sharding_ctx.local_write(k_c, k), slot)
        attn.scatter_decode_kv(*sharding_ctx.local_write(v_c, v), slot)
        o = sharding_ctx.local_heads(attn.decode_attention, q, k_c, v_c, cache_position, ring=ring,
                                     window=cfg.attention_window)
    else:
        o = sharding_ctx.local_heads(attn.blockwise_attention, q, k, v, causal=True, window=cfg.attention_window)
    h = h + _proj(o.reshape(B, S, cfg.num_heads * cfg.resolved_head_dim), p, "wo", "", lr, lora_scale)
    return _cross_mlp(h, enc_out, p, lr, cfg, lora_scale, cross_kv)


def _embed_tokens(dec, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = sharding_ctx.replicate_partial(torch.nn.functional.embedding(tokens, dec["embed"]))
    return h + sinusoidal_positions(tokens.shape[1], cfg.d_model, h.dtype, h.device)[None]


def _logits(h, dec):
    h = layer_norm(h, dec["final_norm_w"], dec["final_norm_b"])
    return h @ dec["embed"].T.to(h.dtype)  # tied


def encdec_forward(params, lora, batch, cfg: ModelConfig, *, lora_scale: Optional[float] = None,
                   embed_noise=None, collect_layer_norms: bool = False):
    """Training forward. batch: ``{"encoder_embeds", "tokens"}``. Returns
    ``(logits (B, S, V), aux 0)``.

    Probe mode: ``embed_noise`` is added to the decoder's token embeddings
    (a dict may give ``"encoder"`` and ``"decoder"`` noise apart); the
    layer norms come back for the encoder's layers, then the decoder's
    (Le + Ld rows, the LoRA tree's logical layers)."""
    lora_scale = lora_scale if lora_scale is not None else cfg.lora_alpha / cfg.lora_rank
    enc_in = batch["encoder_embeds"]
    if isinstance(embed_noise, dict) and "encoder" in embed_noise:
        enc_in = enc_in + embed_noise["encoder"].to(enc_in.dtype)
    enc = encode(params, lora, enc_in, cfg, lora_scale, collect_layer_norms=collect_layer_norms)
    enc_out, enc_norms = enc if collect_layer_norms else (enc, None)
    dec = params["decoder"]
    h = _embed_tokens(dec, batch["tokens"], cfg)
    if embed_noise is not None:
        noise = embed_noise["decoder"] if isinstance(embed_noise, dict) else embed_noise
        h = h + noise.to(h.dtype)
    norms = []
    for i in range(cfg.num_layers):
        p, lr = _layer_slices(dec, lora["decoder"], i)
        h = _decoder_layer(h, enc_out, p, lr, cfg, lora_scale)
        if collect_layer_norms:
            norms.append(_layer_norms(h))
    logits = _logits(h, dec)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if collect_layer_norms:
        return logits, aux, torch.cat([enc_norms, torch.stack(norms)], dim=0)
    return logits, aux


def init_encdec_cache(cfg: ModelConfig, batch: int, max_len: int, device, dtype=None):
    """Zero caches: the self-attention's ``k``/``v`` (Ld, B, max_len, KVH,
    hd) and the cross-attention's ``cross_k``/``cross_v`` (Ld, B, S_enc,
    KVH, hd)."""
    dtype = dtype or torch_dtype(cfg.dtype)
    tail = (cfg.num_kv_heads, cfg.resolved_head_dim)
    self_shape = (cfg.num_layers, batch, max_len) + tail
    cross_shape = (cfg.num_layers, batch, cfg.encoder_seq_len) + tail
    return {"k": torch.zeros(self_shape, dtype=dtype, device=device),
            "v": torch.zeros(self_shape, dtype=dtype, device=device),
            "cross_k": torch.zeros(cross_shape, dtype=dtype, device=device),
            "cross_v": torch.zeros(cross_shape, dtype=dtype, device=device)}


def encdec_prefill(params, lora, batch, cfg: ModelConfig, cache_len: int, *, lora_scale: Optional[float] = None):
    """Encode the frames, run the prompt, fill the caches. Returns
    ``(last_logits (B, 1, V), cache, S)``, S the prompt's token count.

    The self cache keeps the prompt's last ``min(cache_len, S)`` positions
    (position p at slot ``p % cache_len`` in the ring layout, when the
    window covers the cache); the cross cache holds each layer's K/V over
    the encoder's output."""
    lora_scale = lora_scale if lora_scale is not None else cfg.lora_alpha / cfg.lora_rank
    enc_out = encode(params, lora, batch["encoder_embeds"], cfg, lora_scale, kernel=True)
    dec = params["decoder"]
    tokens = batch["tokens"]
    h = _embed_tokens(dec, tokens, cfg)
    B, S = tokens.shape
    ring = cfg.attention_window is not None and cache_len <= cfg.attention_window
    cache = init_encdec_cache(cfg, B, cache_len, h.device)
    keep = min(cache_len, S)
    for i in range(cfg.num_layers):
        p, lr = _layer_slices(dec, lora["decoder"], i)
        q, k, v = _project_qkv(_norm(h, p, "attn_norm", "layernorm"), p, lr, cfg, lora_scale)
        o = prompt_attention(q, k, v, cfg).reshape(B, S, cfg.num_heads * cfg.resolved_head_dim)
        h = h + _proj(o, p, "wo", "", lr, lora_scale)
        kc, vc = _encode_kv(enc_out, p, lr, cfg, lora_scale)
        h = _cross_mlp(h, None, p, lr, cfg, lora_scale, (kc, vc))
        for name, t in (("k", k), ("v", v)):
            tail = t[:, S - keep:]
            if keep == cache_len and ring and S % cache_len:
                tail = torch.roll(tail, S % cache_len, dims=1)
            # a tensor-parallel prefill's (DTensor) tails are gathered into the plain cache
            sharding_ctx.put(cache[name][i, :, :keep], tail)
        sharding_ctx.put(cache["cross_k"][i], kc)
        sharding_ctx.put(cache["cross_v"][i], vc)
    return _logits(h[:, -1:], dec), cache, S


def encdec_decode_step(params, lora, token: torch.Tensor, cfg: ModelConfig, cache, position, *,
                       lora_scale: Optional[float] = None, ring: bool = False):
    """One decoder token per row against the caches. token: (B, 1);
    ``position`` a scalar or a (B,) tensor of per-slot positions, whose
    sinusoid rows are computed in f32 and cast to the embedding dtype.
    Writes the self cache in place (the cross cache is only read); returns
    ``(logits (B, 1, V), cache)``."""
    lora_scale = lora_scale if lora_scale is not None else cfg.lora_alpha / cfg.lora_rank
    dec = params["decoder"]
    h = sharding_ctx.replicate_partial(torch.nn.functional.embedding(token, dec["embed"]))
    pos = torch.as_tensor(position, device=h.device).reshape(-1, 1).to(torch.float32)
    h = h + sinusoidal_rows(pos, cfg.d_model).to(h.dtype)[:, None, :]
    # a cache sharded over its time axis is gathered first: a rank cannot
    # write a slot that another holds in place (a plain cache stays as it is)
    cache = {name: sharding_ctx.unshard_unless(c, 2, 1) for name, c in cache.items()}
    for i in range(cfg.num_layers):
        p, lr = _layer_slices(dec, lora["decoder"], i)
        h = _decoder_layer(h, None, p, lr, cfg, lora_scale, self_cache=(cache["k"][i], cache["v"][i]),
                           cross_kv=(cache["cross_k"][i], cache["cross_v"][i]), cache_position=position, ring=ring)
    return _logits(h, dec), cache
