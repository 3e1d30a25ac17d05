"""Learning-rate schedules (port of ``repro.optim.schedule``)."""
from __future__ import annotations

import math

import torch


def linear_warmup_cosine(step, *, base_lr: float, warmup: int, total: int, min_frac=0.1) -> torch.Tensor:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine decay
    to ``min_frac · base_lr`` at ``total``. ``step`` is a Python number or a
    tensor; the result is an f32 tensor of its shape (on its device)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = base_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)
