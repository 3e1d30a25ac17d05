"""Mamba2 decoder-only language model, attention-free (port of
``repro.models.ssm_model``). [arXiv:2405.21060]

Per-layer weights are stacked on a leading layer axis, as in the JAX
package, and the layer loop is a Python loop over those slices. The serving
cache is ``{"conv": (L, B, W-1, conv_ch), "state": (L, B, nh, hd, N) f32}``:
its size does not grow with the sequence, and its batch is on axis 1, as
the KV cache's is.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import sharding_ctx
from repro_torch.models.layers import init_embed, init_stacked_dense, rms_norm
from repro_torch.models.ssm import init_ssm_layers, mamba2_block, mamba2_decode, mamba2_prefill, ssm_dims
from repro_torch.models.transformer import _layer_slices, _lm_logits, torch_dtype


def init_ssm_model(gen: torch.Generator, cfg: ModelConfig, device) -> Dict[str, Any]:
    """Frozen base weights drawn from ``gen`` (a generator on ``device``)."""
    dtype = torch_dtype(cfg.dtype)
    D, L = cfg.d_model, cfg.num_layers
    embed = init_embed(gen, cfg.vocab_size, D, dtype, device)
    layers = init_ssm_layers(gen, L, cfg, dtype, device)
    layers["norm_w"] = torch.ones((L, D), dtype=dtype, device=device)
    return {
        "embed": embed,
        "layers": layers,
        "final_norm_w": torch.ones((D,), dtype=dtype, device=device),
        "lm_head": init_stacked_dense(gen, 1, D, cfg.vocab_size, dtype, device)[0],
    }


def _scale(cfg: ModelConfig, lora_scale: Optional[float]) -> float:
    return lora_scale if lora_scale is not None else cfg.lora_alpha / cfg.lora_rank


def ssm_forward(params, lora, tokens: torch.Tensor, cfg: ModelConfig, *,
                lora_scale: Optional[float] = None, embed_noise: Optional[torch.Tensor] = None,
                collect_layer_norms: bool = False):
    """Training/eval forward (plain PyTorch, no kernel). Returns ``(logits
    (B, S, V), aux_loss)``; with ``collect_layer_norms`` also the per-layer
    per-sample Frobenius norms of the hidden states (num_layers, B), and
    ``embed_noise`` (B, S, D) is added to the embeddings (the GAL probe)."""
    scale = _scale(cfg, lora_scale)
    h = sharding_ctx.replicate_partial(torch.nn.functional.embedding(tokens, params["embed"]))
    if embed_noise is not None:
        h = h + embed_noise.to(h.dtype)
    norms = []
    for i in range(cfg.num_layers):
        p, lo = _layer_slices(params, lora, i)
        h = h + mamba2_block(rms_norm(h, p["norm_w"]), p, cfg, lo, scale)
        if collect_layer_norms:
            norms.append(torch.sqrt(torch.sum(torch.square(h.to(torch.float32)), dim=(1, 2))))
    logits = _lm_logits(h, params, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if collect_layer_norms:
        return logits, aux, torch.stack(norms)
    return logits, aux


def init_ssm_cache(cfg: ModelConfig, batch: int, max_len: int, device, dtype=None):
    """A zero cache; ``max_len`` is unused, the state has a constant size."""
    del max_len
    dtype = dtype or torch_dtype(cfg.dtype)
    dims, s, L = ssm_dims(cfg), cfg.ssm, cfg.num_layers
    return {
        "conv": torch.zeros((L, batch, s.conv_width - 1, dims["conv_ch"]), dtype=dtype, device=device),
        "state": torch.zeros((L, batch, dims["nheads"], s.head_dim, s.d_state), dtype=torch.float32,
                             device=device),
    }


def ssm_prefill(params, lora, tokens: torch.Tensor, cfg: ModelConfig, cache_len: int, *,
                lora_scale: Optional[float] = None):
    """Run the prompt and build the cache. Returns ``(last_logits (B, 1, V),
    cache, S)``, S the prompt length as a Python int. On the card each
    layer's intra-chunk scan is the B9 kernel (``mamba2_prefill``)."""
    del cache_len
    scale = _scale(cfg, lora_scale)
    h = sharding_ctx.replicate_partial(torch.nn.functional.embedding(tokens, params["embed"]))
    B, S = tokens.shape
    cache = init_ssm_cache(cfg, B, S, h.device)
    for i in range(cfg.num_layers):
        p, lo = _layer_slices(params, lora, i)
        out, (conv_tail, state) = mamba2_prefill(rms_norm(h, p["norm_w"]), p, cfg, lo, scale)
        h = h + out
        sharding_ctx.put(cache["conv"][i], conv_tail)
        # a tensor-parallel state (DTensor, by head) is gathered into the plain cache
        sharding_ctx.put(cache["state"][i], state)
    return _lm_logits(h[:, -1:], params, cfg), cache, S


def ssm_decode_step(params, lora, token: torch.Tensor, cfg: ModelConfig, cache, position, *,
                    lora_scale: Optional[float] = None):
    """One-token step. token: (B, 1) ints; ``position`` is unused (the
    recurrence has none). Writes the new conv buffer and state into
    ``cache`` in place; returns ``(logits (B, 1, V), cache)``."""
    del position
    scale = _scale(cfg, lora_scale)
    h = sharding_ctx.replicate_partial(torch.nn.functional.embedding(token, params["embed"]))
    for i in range(cfg.num_layers):
        p, lo = _layer_slices(params, lora, i)
        out, (conv, state) = mamba2_decode(rms_norm(h, p["norm_w"]), p, cfg, (cache["conv"][i], cache["state"][i]),
                                           lo, scale)
        h = h + out
        sharding_ctx.put(cache["conv"][i], conv)
        sharding_ctx.put(cache["state"][i], state)
    return _lm_logits(h, params, cfg), cache
