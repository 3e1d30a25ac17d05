"""Request-oriented serving surface: dataclasses and batch <-> request
helpers (port of ``repro.serve.requests``).

The engine's unit of work is a :class:`Request` (one prompt as a numpy
array, its :class:`SamplingParams`, and an adapter id into the engine's
registry); the unit of output is a :class:`Completion`. Requests carry numpy
tokens, so the same prompts can go to both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_id: Optional[int] = None
    seed: int = 0


@dataclasses.dataclass
class Request:
    """One prompt. ``tokens``: (S,) int; ``extras``: per-row family inputs
    (the JAX package's field; the scheduler groups by their shapes, and the
    ported families take none). ``request_id`` and
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
    """A random prompt batch, ``{"tokens": (batch_size, prompt_len) int32
    numpy}``. ``rng`` is a ``torch.Generator``, a numpy ``Generator`` or a
    numpy seed. The ported families (dense, moe, ssm, hybrid) need no other
    input (ROADMAP.md, Queue A item 12)."""
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md, Queue A item 12)"
        )
    shape = (batch_size, prompt_len)
    if isinstance(rng, torch.Generator):
        tokens = torch.randint(0, cfg.vocab_size, shape, generator=rng, device=rng.device).cpu().numpy()
    else:
        tokens = np.random.default_rng(rng).integers(0, cfg.vocab_size, shape)
    return {"tokens": tokens.astype(np.int32)}


def requests_from_batch(batch: Dict[str, Any], sampling: Optional[SamplingParams] = None,
                        adapter_ids=None) -> List[Request]:
    """Split a row-stacked batch dict into per-row Requests (exact values).
    The ported families' prefill reads the tokens alone."""
    tokens = np.asarray(batch["tokens"])
    sampling = sampling or SamplingParams()
    return [Request(tokens=tokens[i], sampling=sampling,
                    adapter_id=int(adapter_ids[i]) if adapter_ids is not None else 0)
            for i in range(tokens.shape[0])]


def batch_from_requests(reqs: List[Request], device="cpu") -> Dict[str, torch.Tensor]:
    """Stack same-shape Requests' tokens back into a batch dict on
    ``device`` (exact values, as int64 indices)."""
    tokens = np.stack([np.asarray(r.tokens) for r in reqs]).astype(np.int64)
    return {"tokens": torch.as_tensor(tokens, device=device)}
