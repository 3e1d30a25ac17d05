"""Request-oriented serving surface: dataclasses and batch <-> request
helpers (port of ``repro.serve.requests``).

The engine's unit of work is a :class:`Request` (one prompt as a numpy
array, its :class:`SamplingParams`, and an adapter id into the engine's
registry); the unit of output is a :class:`Completion`. Requests carry numpy
tokens, so the same prompts can go to both packages.
:func:`make_prompt_batch` is the one place that knows which extra inputs
each family's prefill needs (vlm ``prefix_embeds``, encoder-decoder
``encoder_embeds``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models.transformer import torch_dtype


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_id: Optional[int] = None
    seed: int = 0


@dataclasses.dataclass
class Request:
    """One prompt. ``tokens``: (S,) int; ``extras``: per-row family inputs,
    numpy arrays or tensors (a (P, d_model) ``prefix_embeds`` row for the
    vlm family, a (S_enc, d_model) ``encoder_embeds`` row for the
    encoder-decoder; the scheduler groups by their shapes). ``request_id`` and
    ``submit_time`` are stamped by ``ServeEngine.submit``."""

    tokens: np.ndarray
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    adapter_id: int = 0
    extras: Optional[Dict[str, np.ndarray]] = None
    request_id: Optional[int] = None
    submit_time: Optional[float] = None


@dataclasses.dataclass
class Completion:
    request_id: Optional[int]
    tokens: np.ndarray  # (n,) int32: generated tokens, ending at EOS if hit
    prompt_len: int
    adapter_id: int
    finish_reason: str  # "eos" | "length"
    steps: int  # == len(tokens)
    ttft_s: Optional[float]  # submit -> first token, None if untimed


def make_prompt_batch(cfg: ModelConfig, rng: Union[torch.Generator, np.random.Generator, int],
                      batch_size: int, prompt_len: int) -> Dict[str, Any]:
    """A random prompt batch with every extra input ``cfg``'s prefill needs:
    ``{"tokens": (batch_size, prompt_len) int32 numpy}``, plus zero
    ``prefix_embeds`` (batch_size, P, D) for the vlm family or
    ``encoder_embeds`` (batch_size, S_enc, D) for the encoder-decoder, CPU
    tensors in ``cfg.dtype``, as the JAX package makes them. ``rng`` is a
    ``torch.Generator``, a numpy ``Generator`` or a numpy seed."""
    shape = (batch_size, prompt_len)
    if isinstance(rng, torch.Generator):
        tokens = torch.randint(0, cfg.vocab_size, shape, generator=rng, device=rng.device).cpu().numpy()
    else:
        tokens = np.random.default_rng(rng).integers(0, cfg.vocab_size, shape)
    batch: Dict[str, Any] = {"tokens": tokens.astype(np.int32)}
    dtype = torch_dtype(cfg.dtype)
    if cfg.family == "vlm":
        batch["prefix_embeds"] = torch.zeros((batch_size, cfg.num_prefix_embeddings, cfg.d_model), dtype=dtype)
    if cfg.family in ("encdec", "audio"):
        batch["encoder_embeds"] = torch.zeros((batch_size, cfg.encoder_seq_len, cfg.d_model), dtype=dtype)
    return batch


def requests_from_batch(batch: Dict[str, Any], sampling: Optional[SamplingParams] = None,
                        adapter_ids=None) -> List[Request]:
    """Split a row-stacked batch dict into per-row Requests (exact values):
    every key but ``tokens`` rides in the request's ``extras``."""
    tokens = np.asarray(batch["tokens"])
    extra_keys = [k for k in batch if k != "tokens"]
    sampling = sampling or SamplingParams()
    return [Request(tokens=tokens[i], sampling=sampling,
                    adapter_id=int(adapter_ids[i]) if adapter_ids is not None else 0,
                    extras={k: batch[k][i] for k in extra_keys} or None)
            for i in range(tokens.shape[0])]


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def device_batch(batch: Dict[str, Any], device, dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """A batch dict (numpy arrays or tensors) on ``device``: tokens as int64
    indices, float extras in ``dtype`` (the model's) where it is given."""
    out = {}
    for k, v in batch.items():
        t = _tensor(v)
        if k == "tokens":
            out[k] = t.to(device=device, dtype=torch.int64)
        else:
            out[k] = t.to(device=device, dtype=dtype if dtype is not None and t.is_floating_point() else t.dtype)
    return out


def batch_from_requests(reqs: List[Request], device=None, dtype: Optional[torch.dtype] = None
                        ) -> Dict[str, torch.Tensor]:
    """Stack same-shape Requests back into a batch dict on ``device`` (exact
    values): tokens as int64 indices, each extra stacked over the requests
    (float extras in ``dtype`` where it is given). ``device`` None is the
    card, an error without one (pass ``device="cpu"`` for the CPU)."""
    from repro_torch.core.fibecfed import resolve_device

    batch: Dict[str, Any] = {"tokens": np.stack([np.asarray(r.tokens) for r in reqs])}
    for k in reqs[0].extras or {}:
        batch[k] = torch.stack([_tensor(r.extras[k]) for r in reqs])
    return device_batch(batch, resolve_device(device), dtype)
