"""Model interface of the port, over every architecture family (port of
``repro.models.model_api``).

``build_model(cfg)`` returns a :class:`ModelFns` bundle:

- ``init_params(generator, device)``: frozen base model;
- ``init_lora(generator, device)``: trainable LoRA tree (see repro_torch.lora);
- ``forward(params, lora, batch)`` -> (logits, aux_loss): (B, S, V) token
  logits for the LM families, (B, num_classes) for the encoder family; a
  dense, moe or vlm batch may carry ``prefix_embeds`` (B, P, D), prepended
  to the token embeddings (S then counts P), and ``sample_mask`` (B,),
  which restricts the MoE load-balance aux loss to valid samples, as in
  the JAX package; an encoder-decoder batch carries ``encoder_embeds``;
- ``forward_probe(params, lora, batch, embed_noise=None)`` -> (logits, aux,
  layer_norms (L_logical, B)), the FibecFed GAL sensitivity probe;
- ``init_cache(batch, cache_len, device)`` / ``prefill`` / ``decode_step``
  for serving (the encoder family has none: each raises);
- ``input_specs(shape)``: ``device="meta"`` tensors (the stand-in for
  ``jax.ShapeDtypeStruct``) for every data input of an :class:`InputShape`;
- ``supports(shape)``: whether the (arch, shape) pair is runnable
  (long_500k needs sub-quadratic attention; the encoder has no decode).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.config import InputShape, ModelConfig
from repro_torch.lora import init_lora as _init_lora_tree
from repro_torch.models import encdec as _encdec
from repro_torch.models import hybrid as _hybrid
from repro_torch.models import sharding_ctx
from repro_torch.models import ssm_model as _ssm
from repro_torch.models import transformer as _tf
from repro_torch.models.layers import layer_norm, rms_norm


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
    input_specs: Callable[[InputShape], Dict[str, torch.Tensor]]
    supports: Callable[[InputShape], bool]


def _text_len(cfg: ModelConfig, seq_len: int) -> int:
    """Text tokens after reserving room for the prefix (patch) embeddings."""
    if cfg.family == "vlm" and cfg.num_prefix_embeddings:
        return seq_len - cfg.num_prefix_embeddings
    return seq_len


def _make_input_specs(cfg: ModelConfig):
    def input_specs(shape: InputShape) -> Dict[str, torch.Tensor]:
        B, S = shape.global_batch, shape.seq_len
        meta = dict(device="meta")
        emb = dict(meta, dtype=_tf.torch_dtype(cfg.dtype))
        if shape.kind not in ("train", "prefill"):
            # decode: one new token against a cache of length S
            return {"token": torch.empty((B, 1), dtype=torch.int32, **meta)}
        specs = {"tokens": torch.empty((B, _text_len(cfg, S)), dtype=torch.int32, **meta)}
        if cfg.family == "vlm":
            specs["prefix_embeds"] = torch.empty((B, cfg.num_prefix_embeddings, cfg.d_model), **emb)
        if cfg.family in ("encdec", "audio"):
            specs["encoder_embeds"] = torch.empty((B, cfg.encoder_seq_len, cfg.d_model), **emb)
        if cfg.family == "encoder" and shape.kind == "train":
            specs["labels"] = torch.empty((B,), dtype=torch.int32, **meta)
        return specs

    return input_specs


def _make_supports(cfg: ModelConfig):
    def supports(shape: InputShape) -> bool:
        if shape.kind == "decode":
            if cfg.family == "encoder":
                return False  # encoder-only: no autoregressive decode
            if shape.seq_len > 65536 and not cfg.supports_long_context:
                return False  # long_500k needs sub-quadratic attention
        return True

    return supports


def _fns(cfg: ModelConfig, **fns) -> ModelFns:
    return ModelFns(cfg=cfg, init_lora=lambda gen, device: _init_lora_tree(gen, cfg, device),
                    input_specs=_make_input_specs(cfg), supports=_make_supports(cfg), **fns)


def _decoder_fns(cfg: ModelConfig) -> ModelFns:
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

    return _fns(
        cfg,
        init_params=lambda gen, device: _tf.init_decoder(gen, cfg, device),
        forward=forward,
        forward_probe=forward_probe,
        init_cache=lambda batch, cache_len, device: _tf.init_kv_cache(cfg, batch, cache_len, device),
        prefill=prefill,
        decode_step=decode_step,
    )


def _encoder_fns(cfg: ModelConfig) -> ModelFns:
    """Encoder-only classifier (RoBERTa-style, the paper's own model): the
    decoder's blocks made bidirectional, no position information (rope
    "none" and no learned table, as in the JAX package), mean pooling and a
    class head."""

    def init_params(gen, device):
        params = _tf.init_decoder(gen, cfg, device)
        params.pop("lm_head", None)
        head = torch.randn((cfg.d_model, cfg.num_classes), generator=gen, device=device) * 0.02
        params["cls_head"] = head.to(_tf.torch_dtype(cfg.dtype))
        return params

    def forward_impl(params, lora, batch, embed_noise=None, collect=False):
        lora_scale = cfg.lora_alpha / cfg.lora_rank
        h = sharding_ctx.replicate_partial(torch.nn.functional.embedding(batch["tokens"], params["embed"]))
        if embed_noise is not None:
            h = h + embed_noise.to(h.dtype)
        positions = torch.arange(h.shape[1], device=h.device)[None, :]
        norms = []
        for i in range(cfg.num_layers):
            p, lr = _tf._layer_slices(params, lora["layers"], i)
            h, _, _ = _tf.decoder_layer(h, p, lr, cfg, positions, lora_scale=lora_scale, causal=False)
            if collect:
                norms.append(torch.sqrt(torch.sum(torch.square(h.to(torch.float32)), dim=(1, 2))))
        if cfg.norm == "layernorm":
            h = layer_norm(h, params["final_norm_w"], params["final_norm_b"])
        else:
            h = rms_norm(h, params["final_norm_w"])
        logits = torch.mean(h, dim=1) @ params["cls_head"].to(h.dtype)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        if collect:
            return logits, aux, torch.stack(norms)
        return logits, aux

    def no_decode(*args, **kwargs):
        raise NotImplementedError("encoder-only model has no decode path")

    return _fns(
        cfg,
        init_params=init_params,
        forward=lambda params, lora, batch: forward_impl(params, lora, batch),
        forward_probe=lambda params, lora, batch, embed_noise=None: forward_impl(params, lora, batch, embed_noise,
                                                                                collect=True),
        init_cache=no_decode,
        prefill=no_decode,
        decode_step=no_decode,
    )


def _encdec_fns(cfg: ModelConfig) -> ModelFns:
    def decode_step(params, lora, token, cache, position):
        ring = cfg.attention_window is not None and cache["k"].shape[2] <= cfg.attention_window
        return _encdec.encdec_decode_step(params, lora, token, cfg, cache, position, ring=ring)

    return _fns(
        cfg,
        init_params=lambda gen, device: _encdec.init_encdec(gen, cfg, device),
        forward=lambda params, lora, batch: _encdec.encdec_forward(params, lora, batch, cfg),
        forward_probe=lambda params, lora, batch, embed_noise=None: _encdec.encdec_forward(
            params, lora, batch, cfg, embed_noise=embed_noise, collect_layer_norms=True),
        init_cache=lambda batch, cache_len, device: _encdec.init_encdec_cache(cfg, batch, cache_len, device),
        prefill=lambda params, lora, batch, cache_len: _encdec.encdec_prefill(params, lora, batch, cfg, cache_len),
        decode_step=decode_step,
    )


def _ssm_fns(cfg: ModelConfig) -> ModelFns:
    def forward(params, lora, batch):
        return _ssm.ssm_forward(params, lora["layers"], batch["tokens"], cfg)

    def forward_probe(params, lora, batch, embed_noise=None):
        return _ssm.ssm_forward(params, lora["layers"], batch["tokens"], cfg,
                                embed_noise=embed_noise, collect_layer_norms=True)

    return _fns(
        cfg,
        init_params=lambda gen, device: _ssm.init_ssm_model(gen, cfg, device),
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

    return _fns(
        cfg,
        init_params=lambda gen, device: _hybrid.init_hybrid(gen, cfg, device),
        forward=forward,
        forward_probe=forward_probe,
        init_cache=lambda batch, cache_len, device: _hybrid.init_hybrid_cache(cfg, batch, cache_len, device),
        prefill=lambda params, lora, batch, cache_len: _hybrid.hybrid_prefill(
            params, lora, batch["tokens"], cfg, cache_len),
        decode_step=lambda params, lora, token, cache, position: _hybrid.hybrid_decode_step(
            params, lora, token, cfg, cache, position),
    )


def build_model(cfg: ModelConfig) -> ModelFns:
    if cfg.family in ("dense", "moe", "vlm"):
        return _decoder_fns(cfg)
    if cfg.family in ("encdec", "audio"):
        return _encdec_fns(cfg)
    if cfg.family == "ssm":
        return _ssm_fns(cfg)
    if cfg.family == "hybrid":
        return _hybrid_fns(cfg)
    if cfg.family == "encoder":
        return _encoder_fns(cfg)
    raise ValueError(f"unknown family {cfg.family}")
