"""Zamba2-style hybrid: stacked Mamba2 layers and one SHARED attention
block (port of ``repro.models.hybrid``). [arXiv:2411.15242]

The shared transformer block (attention and a SwiGLU MLP, one parameter
set) runs after every ``hybrid_period`` Mamba2 layers: ``n_apps =
num_layers // hybrid_period`` super-blocks of (period Mamba layers, the
shared block), then the remaining Mamba layers. For FibecFed the shared
block counts as one logical layer, the last of ``num_layers + 1``. Its LoRA
is one unstacked tree: ``{"mamba": stacked (L), "shared": unstacked}``.

Serving keeps a KV cache per application point, although the weights are
shared, beside the Mamba layers' conv buffers and states; every cache leaf
carries the batch on axis 1. There is no ring layout: the prefill keeps the
prompt's last ``min(cache_len, S)`` positions. On the card the prefill's
shared attention is the flash attention kernel (B8), the Mamba layers'
intra-chunk scan the SSD kernel (B9), and LoRA leaves with a per-slot batch
axis take the multi-adapter kernel (B7); the training forward is plain
PyTorch, as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models import sharding_ctx
from repro_torch.models.layers import apply_rope, init_embed, init_stacked_dense, linear, rms_norm
from repro_torch.models.mlp import apply_mlp, init_mlp
from repro_torch.models.ssm import init_ssm_layers, mamba2_block, mamba2_decode, mamba2_prefill, ssm_dims
from repro_torch.models.ssm_model import _scale
from repro_torch.models.transformer import _lm_logits, torch_dtype


def _split_counts(cfg: ModelConfig) -> Tuple[int, int, int]:
    period = cfg.hybrid_period
    n_apps = cfg.num_layers // period
    return n_apps, period, cfg.num_layers - n_apps * period


def init_hybrid(gen: torch.Generator, cfg: ModelConfig, device) -> Dict[str, Any]:
    """Frozen base weights drawn from ``gen`` (a generator on ``device``)."""
    dtype = torch_dtype(cfg.dtype)
    hd = cfg.resolved_head_dim
    H, KVH, D, L = cfg.num_heads, cfg.num_kv_heads, cfg.d_model, cfg.num_layers
    shared = {
        "wq": init_stacked_dense(gen, 1, D, H * hd, dtype, device)[0],
        "wk": init_stacked_dense(gen, 1, D, KVH * hd, dtype, device)[0],
        "wv": init_stacked_dense(gen, 1, D, KVH * hd, dtype, device)[0],
        "wo": init_stacked_dense(gen, 1, H * hd, D, dtype, device)[0],
        "attn_norm_w": torch.ones((D,), dtype=dtype, device=device),
        "mlp_norm_w": torch.ones((D,), dtype=dtype, device=device),
    }
    shared.update({k: v[0] for k, v in init_mlp(gen, 1, D, cfg.d_ff, "swiglu", dtype, device).items()})
    mamba = init_ssm_layers(gen, L, cfg, dtype, device)
    mamba["norm_w"] = torch.ones((L, D), dtype=dtype, device=device)
    return {
        "embed": init_embed(gen, cfg.vocab_size, D, dtype, device),
        "mamba": mamba,
        "shared": shared,
        "final_norm_w": torch.ones((D,), dtype=dtype, device=device),
        "lm_head": init_stacked_dense(gen, 1, D, cfg.vocab_size, dtype, device)[0],
    }


def _mamba_slices(params, lora, i: int):
    p = {k: v[i] for k, v in params["mamba"].items()}
    lo = {t: {n: x[i] for n, x in ab.items()} for t, ab in lora["mamba"].items()}
    return p, lo


def _shared_attn_block(h, p, lora, cfg: ModelConfig, positions, lora_scale, *, cache=None, cache_position=None,
                       prompt: bool = False):
    """The shared attention + MLP block. Returns ``(h, (k, v))``: without
    ``cache`` the block's own causal attention over ``h`` and its k, v (B,
    S, KVH, hd); with ``cache``, a (k_cache, v_cache) pair of (B, T, KVH,
    hd), one decode step per row at ``cache_position`` (scalar or (B,)),
    its KV written into the caches in place. ``prompt`` (serving's prefill)
    takes the flash attention kernel (B8) on the card."""
    B, S = h.shape[0], h.shape[1]
    hd = cfg.resolved_head_dim
    lget = (lambda k: lora.get(k) if lora else None)
    x = rms_norm(h, p["attn_norm_w"])

    def heads(w, n):
        # a tensor-parallel projection keeps its shards only over whole KV heads
        y = sharding_ctx.unshard_unless(linear(x, {"w": p[w]}, lget(w), lora_scale), -1, cfg.num_kv_heads)
        return y.reshape(B, S, n, hd)

    q = apply_rope(heads("wq", cfg.num_heads), positions, theta=cfg.rope_theta, mode="full")
    k = apply_rope(heads("wk", cfg.num_kv_heads), positions, theta=cfg.rope_theta, mode="full")
    v = heads("wv", cfg.num_kv_heads)
    if cache is not None:
        k_c, v_c = cache
        attn.scatter_decode_kv(*sharding_ctx.local_write(k_c, k), cache_position)
        attn.scatter_decode_kv(*sharding_ctx.local_write(v_c, v), cache_position)
        o = sharding_ctx.local_heads(attn.decode_attention, q, k_c, v_c, cache_position)
    elif prompt and q.is_cuda:
        o = sharding_ctx.local_heads(kops.flash_attention, q, k, v, causal=True, window=None)
    else:
        o = sharding_ctx.local_heads(attn.blockwise_attention, q, k, v, causal=True)
    h = h + linear(o.reshape(B, S, cfg.num_heads * hd), {"w": p["wo"]}, lget("wo"), lora_scale)
    h = h + apply_mlp(rms_norm(h, p["mlp_norm_w"]), p, "swiglu", lora, lora_scale)
    return h, (k, v)


def _hnorm(h: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.square(h.to(torch.float32)), dim=(1, 2)))


def hybrid_forward(params, lora, tokens: torch.Tensor, cfg: ModelConfig, *, lora_scale: Optional[float] = None,
                   embed_noise: Optional[torch.Tensor] = None, collect_layer_norms: bool = False):
    """Training forward (plain PyTorch, no kernel). ``lora`` = {"mamba":
    stacked (L), "shared": unstacked}. Returns ``(logits (B, S, V),
    aux_loss)``; ``embed_noise`` (B, S, D) is added to the embeddings (the
    GAL probe).

    With ``collect_layer_norms`` a third output holds per-sample Frobenius
    norms of the hidden states, (L + 1, B): the L Mamba layers', then ONE
    for the shared block, taken after its last application (with no
    application, of the final normed hidden state), matching
    ``lora_num_logical_layers`` = L + 1.
    """
    scale = _scale(cfg, lora_scale)
    n_apps, period, _ = _split_counts(cfg)
    h = sharding_ctx.replicate_partial(torch.nn.functional.embedding(tokens, params["embed"]))
    if embed_noise is not None:
        h = h + embed_noise.to(h.dtype)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    norms, shared_norm = [], None
    for i in range(cfg.num_layers):
        p, lo = _mamba_slices(params, lora, i)
        h = h + mamba2_block(rms_norm(h, p["norm_w"]), p, cfg, lo, scale)
        if collect_layer_norms:
            norms.append(_hnorm(h))
        if i < n_apps * period and (i + 1) % period == 0:
            h, _ = _shared_attn_block(h, params["shared"], lora["shared"], cfg, positions, scale)
            if collect_layer_norms:
                shared_norm = _hnorm(h)
    logits = _lm_logits(h, params, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if collect_layer_norms:
        norms.append(_hnorm(rms_norm(h, params["final_norm_w"])) if shared_norm is None else shared_norm)
        return logits, aux, torch.stack(norms)
    return logits, aux


def init_hybrid_cache(cfg: ModelConfig, batch: int, max_len: int, device, dtype=None) -> Dict[str, torch.Tensor]:
    """A zero cache: ``attn_k``/``attn_v`` (n_apps, B, max_len, KVH, hd),
    ``conv`` (L, B, W-1, conv_ch) and ``state`` (L, B, nh, hd, N) f32."""
    dtype = dtype or torch_dtype(cfg.dtype)
    n_apps = _split_counts(cfg)[0]
    hd, dims, L = cfg.resolved_head_dim, ssm_dims(cfg), cfg.num_layers
    kv = (n_apps, batch, max_len, cfg.num_kv_heads, hd)
    return {
        "attn_k": torch.zeros(kv, dtype=dtype, device=device),
        "attn_v": torch.zeros(kv, dtype=dtype, device=device),
        "conv": torch.zeros((L, batch, cfg.ssm.conv_width - 1, dims["conv_ch"]), dtype=dtype, device=device),
        "state": torch.zeros((L, batch, dims["nheads"], cfg.ssm.head_dim, cfg.ssm.d_state), dtype=torch.float32,
                             device=device),
    }


def hybrid_prefill(params, lora, tokens: torch.Tensor, cfg: ModelConfig, cache_len: int, *,
                   lora_scale: Optional[float] = None):
    """Run the prompt and build the cache. Returns ``(last_logits (B, 1,
    V), cache, S)``, S the prompt length as a Python int. Each application's
    KV cache keeps the prompt's last ``min(cache_len, S)`` positions at its
    first slots, zeros after them."""
    scale = _scale(cfg, lora_scale)
    n_apps, period, _ = _split_counts(cfg)
    h = sharding_ctx.replicate_partial(torch.nn.functional.embedding(tokens, params["embed"]))
    B, S = tokens.shape
    positions = torch.arange(S, device=h.device)[None, :]
    cache = init_hybrid_cache(cfg, B, cache_len, h.device)
    keep = min(cache_len, S)
    for i in range(cfg.num_layers):
        p, lo = _mamba_slices(params, lora, i)
        out, (conv_tail, state) = mamba2_prefill(rms_norm(h, p["norm_w"]), p, cfg, lo, scale)
        h = h + out
        # a tensor-parallel layer's state and tails (DTensors) are gathered into the plain cache
        sharding_ctx.put(cache["conv"][i], conv_tail)
        sharding_ctx.put(cache["state"][i], state)
        if i < n_apps * period and (i + 1) % period == 0:
            app = i // period
            h, (k, v) = _shared_attn_block(h, params["shared"], lora["shared"], cfg, positions, scale, prompt=True)
            sharding_ctx.put(cache["attn_k"][app, :, :keep], k[:, S - keep:])
            sharding_ctx.put(cache["attn_v"][app, :, :keep], v[:, S - keep:])
    return _lm_logits(h[:, -1:], params, cfg), cache, S


def hybrid_decode_step(params, lora, token: torch.Tensor, cfg: ModelConfig, cache, position, *,
                       lora_scale: Optional[float] = None):
    """One-token step. token: (B, 1) ints; ``position`` a scalar (uniform
    batch) or a (B,) tensor of per-slot positions, read by the shared
    block's RoPE and KV caches. Writes the conv buffers, states and KV
    caches in place; returns ``(logits (B, 1, V), cache)``."""
    scale = _scale(cfg, lora_scale)
    n_apps, period, _ = _split_counts(cfg)
    h = sharding_ctx.replicate_partial(torch.nn.functional.embedding(token, params["embed"]))
    positions = torch.as_tensor(position, device=h.device).reshape(-1, 1)
    # a KV cache sharded over its time axis is gathered first: a rank cannot
    # write a slot that another holds in place (a plain cache stays as it is)
    cache = dict(cache, **{name: sharding_ctx.unshard_unless(cache[name], 2, 1) for name in ("attn_k", "attn_v")})
    for i in range(cfg.num_layers):
        p, lo = _mamba_slices(params, lora, i)
        out, (conv, state) = mamba2_decode(rms_norm(h, p["norm_w"]), p, cfg, (cache["conv"][i], cache["state"][i]),
                                           lo, scale)
        h = h + out
        sharding_ctx.put(cache["conv"][i], conv)
        sharding_ctx.put(cache["state"][i], state)
        if i < n_apps * period and (i + 1) % period == 0:
            app = i // period
            h, _ = _shared_attn_block(h, params["shared"], lora["shared"], cfg, positions, scale,
                                      cache=(cache["attn_k"][app], cache["attn_v"][app]), cache_position=position)
    return _lm_logits(h, params, cfg), cache
