"""Model interface of the port (the dense, moe, ssm and hybrid families).

``build_model(cfg)`` returns a :class:`ModelFns` bundle:

- ``init_params(generator, device)``: frozen base model;
- ``init_lora(generator, device)``: trainable LoRA tree (see repro_torch.lora);
- ``forward(params, lora, batch)`` -> (logits (B, S, V), aux_loss); a
  dense or moe batch may carry ``prefix_embeds`` (B, P, D), prepended to
  the token embeddings (S then counts P), and ``sample_mask`` (B,), which
  restricts the MoE load-balance aux loss to valid samples, as in the JAX
  package;
- ``forward_probe(params, lora, batch, embed_noise=None)`` -> (logits, aux,
  layer_norms (L, B)), the FibecFed GAL sensitivity probe;
- ``init_cache(batch, cache_len, device)`` / ``prefill`` / ``decode_step``
  for serving.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.config import ModelConfig
from repro_torch.lora import init_lora as _init_lora_tree
from repro_torch.models import hybrid as _hybrid
from repro_torch.models import ssm_model as _ssm
from repro_torch.models import transformer as _tf


@dataclasses.dataclass(frozen=True)
class ModelFns:
    cfg: ModelConfig
    init_params: Callable[..., Any]
    init_lora: Callable[..., Any]
    forward: Callable[..., Any]
    forward_probe: Callable[..., Any]
    init_cache: Callable[..., Any]  # (batch, cache_len, device) -> cache
    # (params, lora, batch, cache_len) -> (last logits (B, 1, V), cache, S)
    prefill: Callable[..., Any]
    # (params, lora, token, cache, position) -> (logits, cache), the cache
    # written in place. ``position`` is a scalar (uniform batch) or a (B,)
    # tensor of per-slot positions (continuous batching). ``lora`` leaves
    # may carry a per-slot batch axis, a (L, B, d_in, r) and b (L, B, r,
    # d_out) (see repro_torch.lora.gather_adapter_slots), giving every batch
    # row its own adapter; unbatched leaves mean one shared adapter.
    decode_step: Callable[..., Any]


def _ssm_fns(cfg: ModelConfig) -> ModelFns:
    def forward(params, lora, batch):
        return _ssm.ssm_forward(params, lora["layers"], batch["tokens"], cfg)

    def forward_probe(params, lora, batch, embed_noise=None):
        return _ssm.ssm_forward(params, lora["layers"], batch["tokens"], cfg,
                                embed_noise=embed_noise, collect_layer_norms=True)

    return ModelFns(
        cfg=cfg,
        init_params=lambda gen, device: _ssm.init_ssm_model(gen, cfg, device),
        init_lora=lambda gen, device: _init_lora_tree(gen, cfg, device),
        forward=forward,
        forward_probe=forward_probe,
        init_cache=lambda batch, cache_len, device: _ssm.init_ssm_cache(cfg, batch, cache_len, device),
        prefill=lambda params, lora, batch, cache_len: _ssm.ssm_prefill(
            params, lora["layers"], batch["tokens"], cfg, cache_len),
        decode_step=lambda params, lora, token, cache, position: _ssm.ssm_decode_step(
            params, lora["layers"], token, cfg, cache, position),
    )


def _hybrid_fns(cfg: ModelConfig) -> ModelFns:
    def forward(params, lora, batch):
        return _hybrid.hybrid_forward(params, lora, batch["tokens"], cfg)

    def forward_probe(params, lora, batch, embed_noise=None):
        return _hybrid.hybrid_forward(params, lora, batch["tokens"], cfg, embed_noise=embed_noise,
                                      collect_layer_norms=True)

    return ModelFns(
        cfg=cfg,
        init_params=lambda gen, device: _hybrid.init_hybrid(gen, cfg, device),
        init_lora=lambda gen, device: _init_lora_tree(gen, cfg, device),
        forward=forward,
        forward_probe=forward_probe,
        init_cache=lambda batch, cache_len, device: _hybrid.init_hybrid_cache(cfg, batch, cache_len, device),
        prefill=lambda params, lora, batch, cache_len: _hybrid.hybrid_prefill(
            params, lora, batch["tokens"], cfg, cache_len),
        decode_step=lambda params, lora, token, cache, position: _hybrid.hybrid_decode_step(
            params, lora, token, cfg, cache, position),
    )


def build_model(cfg: ModelConfig) -> ModelFns:
    if cfg.family == "ssm":
        return _ssm_fns(cfg)
    if cfg.family == "hybrid":
        return _hybrid_fns(cfg)
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md, Queue A item 12)"
        )

    def forward(params, lora, batch):
        # the masked loss passes the (B,) validity weights of a padded batch
        # for the MoE aux loss; the dense FFN has none
        return _tf.decoder_forward(params, lora["layers"], batch["tokens"], cfg,
                                   prefix_embeds=batch.get("prefix_embeds"),
                                   sample_weight=batch.get("sample_mask"))

    def forward_probe(params, lora, batch, embed_noise=None):
        return _tf.decoder_forward(
            params, lora["layers"], batch["tokens"], cfg, prefix_embeds=batch.get("prefix_embeds"),
            embed_noise=embed_noise, collect_layer_norms=True,
        )

    def prefill(params, lora, batch, cache_len):
        return _tf.decoder_prefill(params, lora["layers"], batch["tokens"], cfg, cache_len,
                                   prefix_embeds=batch.get("prefix_embeds"))

    def decode_step(params, lora, token, cache, position):
        ring = cfg.attention_window is not None and cache["k"].shape[2] <= cfg.attention_window
        return _tf.decoder_decode_step(params, lora["layers"], token, cfg, cache, position, ring=ring)

    return ModelFns(
        cfg=cfg,
        init_params=lambda gen, device: _tf.init_decoder(gen, cfg, device),
        init_lora=lambda gen, device: _init_lora_tree(gen, cfg, device),
        forward=forward,
        forward_probe=forward_probe,
        init_cache=lambda batch, cache_len, device: _tf.init_kv_cache(cfg, batch, cache_len, device),
        prefill=prefill,
        decode_step=decode_step,
    )
