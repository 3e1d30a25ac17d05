"""Shared building blocks: initializers, norms, RoPE, linears with LoRA.

Port of ``repro.models.layers``. All modules are plain functions over dicts
of tensors. A "linear" is ``{"w": (in, out)[, "b": (out,)]}``; stacked layers
carry a leading layer axis on every leaf. Initializers draw from an explicit
``torch.Generator`` on the target device.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import ops as kops


def init_stacked_dense(gen: torch.Generator, n: int, d_in: int, d_out: int, dtype, device) -> torch.Tensor:
    """N(0, 1/d_in) weights drawn in f32, cast to ``dtype``. The scaling is
    in place: zamba2-7b's stacked in_proj is 16.9 GB in f32."""
    w = torch.randn((n, d_in, d_out), generator=gen, device=device)
    return w.div_(math.sqrt(d_in)).to(dtype)


def init_embed(gen: torch.Generator, vocab: int, d: int, dtype, device) -> torch.Tensor:
    return (torch.randn((vocab, d), generator=gen, device=device) * 0.02).to(dtype)


@functools.lru_cache(maxsize=64)
def _slot_rows(slots: int, per_slot: int, n_out: int, device: torch.device):
    """The per-row adapter index (row m is slot m // per_slot) and the
    all-ones mask of the multi-adapter kernel, made once per shape and
    shared by every call (the kernel only reads them)."""
    idx = torch.arange(slots, dtype=torch.int32, device=device).repeat_interleave(per_slot)
    return idx, torch.ones((slots, n_out), dtype=torch.float32, device=device)


def per_row_lora(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, lora_scale: float) -> torch.Tensor:
    """``lora_scale · (x[s] @ a[s]) @ b[s]`` for each batch row s: x
    (B, ..., d_in), a (B, d_in, r), b (B, r, d_out); the result in x's dtype.

    On the card this is the multi-adapter LoRA kernel (B7,
    ``kernels.ops.batched_sparse_lora_apply``) with slot s as adapter s, row
    m's index its batch row and every output column kept; it takes a and b
    in f32 and keeps ``x @ a`` in f32. On the CPU it is the JAX package's
    einsum pair, a and b cast to x's dtype first.
    """
    B, K, N = x.shape[0], x.shape[-1], b.shape[-1]
    if x.is_cuda:
        idx, ones = _slot_rows(B, x.numel() // (B * K) if B else 0, N, x.device)
        return kops.batched_sparse_lora_apply(x, idx, a, b, ones, lora_scale)
    x3 = x.reshape(B, -1, K)
    z = torch.bmm(x3, a.to(x.dtype))
    return (lora_scale * torch.bmm(z, b.to(x.dtype))).reshape(*x.shape[:-1], N)


def linear(x: torch.Tensor, p, lora=None, lora_scale: float = 1.0) -> torch.Tensor:
    """``x @ w (+ b)`` with an optional LoRA delta ``(x @ a) @ b * scale``.

    x: (..., d_in). p: {"w": (d_in, d_out)[, "b"]}. lora: {"a": (d_in, r),
    "b": (r, d_out)} or None; its leaves are cast to ``x``'s dtype. When the
    LoRA leaves carry a leading batch axis (a (B, d_in, r), b (B, r, d_out),
    x (B, ..., d_in)), each batch row gets its own adapter's delta
    (:func:`per_row_lora`, the multi-tenant serving path).
    """
    y = x @ p["w"]
    if lora is not None:
        if lora["a"].dim() == 3:  # per-slot adapters
            y = y + per_row_lora(x, lora["a"], lora["b"], lora_scale)
        else:
            z = x @ lora["a"].to(x.dtype)
            y = y + lora_scale * (z @ lora["b"].to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm computed in f32, cast back to ``x``'s dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32)).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Layer norm computed in f32, cast back to ``x``'s dtype."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32) + b.to(torch.float32)).to(x.dtype)


def rope_frequencies(rotary_dims: int, theta: float, device) -> torch.Tensor:
    """Inverse frequencies for the rotated sub-dimension, f32 (rotary_dims//2,)."""
    exponent = torch.arange(0, rotary_dims, 2, dtype=torch.float32, device=device) / rotary_dims
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float = 10000.0,
               mode: str = "full") -> torch.Tensor:
    """Rotary embedding. x: (..., seq, heads, head_dim); positions
    broadcastable to (..., seq). ``"full"`` rotates the whole head_dim,
    ``"2d"`` (ChatGLM) its first half, ``"none"`` is the identity."""
    if mode == "none":
        return x
    head_dim = x.shape[-1]
    rotary_dims = head_dim if mode == "full" else head_dim // 2
    inv_freq = rope_frequencies(rotary_dims, theta, x.device)
    angles = positions[..., None].to(torch.float32) * inv_freq  # (..., S, rd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, rd/2)
    sin = torch.sin(angles)[..., None, :]
    xr = x[..., :rotary_dims].to(torch.float32)
    x1, x2 = torch.chunk(xr, 2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if rotary_dims == head_dim:
        return rotated.to(x.dtype)
    return torch.cat([rotated.to(x.dtype), x[..., rotary_dims:]], dim=-1)


def sinusoidal_positions(seq_len: int, d: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal position table (seq_len, d): sines then
    cosines of ``p · exp(-ln(10000)·i / (d/2 - 1))``, computed in f32 and
    cast to ``dtype``."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    return sinusoidal_rows(pos, d).to(dtype)


def sinusoidal_rows(pos: torch.Tensor, d: int) -> torch.Tensor:
    """The f32 rows of :func:`sinusoidal_positions` at positions ``pos``
    (n, 1) float32: (n, d)."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=pos.device)[None, :]
    freq = torch.exp(-math.log(10000.0) * dim / max(d // 2 - 1, 1))
    angles = pos * freq
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


def soft_cap(logits: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)
