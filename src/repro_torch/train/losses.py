"""Loss functions (f32 softmax cross-entropy whatever the model dtype)."""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch
from torch.func import vmap

from repro_torch.config import ModelConfig
from repro_torch.models.model_api import ModelFns


def _xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-element cross entropy. logits (..., V), targets (...) int."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.to(torch.int64)[..., None])[..., 0]
    return logz - gold


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor, text_offset: int = 0) -> torch.Tensor:
    """Mean next-token CE over the text region starting at ``text_offset``."""
    pred = logits[:, text_offset : text_offset + tokens.shape[1] - 1]
    return torch.mean(_xent(pred, tokens[:, 1:]))


def cls_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE of class logits (B, C) against labels (B,)."""
    return torch.mean(_xent(logits, labels))


def label_token_loss(logits: torch.Tensor, label_tokens: torch.Tensor) -> torch.Tensor:
    """CE of the next token after the sequence against a class-label token,
    the prompt-style classification objective of the paper's LLM runs."""
    return torch.mean(_xent(logits[:, -1], label_tokens))


def _text_offset(cfg: ModelConfig) -> int:
    """Where the text's logits start: after the vlm family's prefix rows."""
    return cfg.num_prefix_embeddings if cfg.family == "vlm" else 0


def make_logits_loss(cfg: ModelConfig) -> Callable:
    """``loss(logits, batch)``, used by the GAL probe (gradient w.r.t. noise):
    the class CE for the encoder family, else the label-token CE where the
    batch has ``label_token``, else the next-token CE over the text."""
    offset = _text_offset(cfg)

    def fn(logits, batch: Dict[str, Any]):
        if cfg.family == "encoder":
            return cls_loss(logits, batch["labels"])
        if "label_token" in batch:
            return label_token_loss(logits, batch["label_token"])
        return lm_loss(logits, batch["tokens"], offset)

    return fn


def make_loss_fn(model: ModelFns) -> Callable:
    """``(params, lora, batch) -> scalar``: the forward plus its loss.

    The returned function carries ``.masked(params, lora, batch,
    sample_mask)``: the same loss restricted to the mask's valid samples
    with one batched forward (per-sample CE weighted by the mask). It equals
    the plain loss of the ragged sub-batch, which is what lets the
    vectorized engine train on padded fixed-shape batches. For moe the mask
    also reaches the router as per-sample weights, so the load-balance aux
    loss of a padded batch equals its ragged original's too.
    """
    cfg = model.cfg
    logits_loss = make_logits_loss(cfg)
    offset = _text_offset(cfg)

    def loss_fn(params, lora, batch: Dict[str, Any]):
        logits, aux = model.forward(params, lora, batch)
        return logits_loss(logits, batch) + aux

    def masked(params, lora, batch: Dict[str, Any], sample_mask):
        if cfg.family == "moe":
            batch = dict(batch, sample_mask=sample_mask)
        logits, aux = model.forward(params, lora, batch)
        m = sample_mask.to(torch.float32)
        denom = torch.clamp(torch.sum(m), min=1.0)
        if cfg.family == "encoder":
            per = _xent(logits, batch["labels"])
        elif "label_token" in batch:
            per = _xent(logits[:, -1], batch["label_token"])
        else:
            tokens = batch["tokens"]
            per = torch.mean(_xent(logits[:, offset : offset + tokens.shape[1] - 1], tokens[:, 1:]), dim=-1)
        return torch.sum(per * m) / denom + aux

    loss_fn.masked = masked
    return loss_fn


def per_sample_losses(loss_fn: Callable, params, lora, batch: Dict[str, Any]) -> torch.Tensor:
    """(B,) per-sample losses from a mean-over-samples batch ``loss_fn``:
    the loss of each singleton-batch slice, under ``torch.func.vmap``. For
    every loss here the batch loss is the mean of these values (all samples
    of a batch share one sequence length)."""
    return vmap(lambda s: loss_fn(params, lora, s))({k: v[:, None] for k, v in batch.items()})


def masked_mean_loss(loss_fn: Callable, params, lora, batch: Dict[str, Any], sample_mask) -> torch.Tensor:
    """Batch loss restricted to ``sample_mask``'s (B,) valid samples."""
    per = per_sample_losses(loss_fn, params, lora, batch)
    m = sample_mask.to(torch.float32)
    return torch.sum(per * m) / torch.clamp(torch.sum(m), min=1.0)


def make_label_token_loss(model: ModelFns) -> Callable:
    """``(params, lora, batch) -> scalar``: the label-token CE whatever the
    batch holds besides ``label_token``."""

    def loss_fn(params, lora, batch: Dict[str, Any]):
        logits, aux = model.forward(params, lora, batch)
        return label_token_loss(logits, batch["label_token"]) + aux

    return loss_fn
