"""GQA attention with causal / sliding-window masks and KV caches (port of
``repro.models.attention``).

Plain PyTorch matmul + softmax, as the JAX package leaves this to XLA.
Scores are f32 and masked with ``NEG_INF``; GQA groups the query heads as
(KVH, G) and never materializes a repeat of K/V. :func:`blockwise_attention`
bounds memory with an online softmax over KV blocks and, with a window,
visits only the KV span each query block can see. As in the JAX package,
the model calls no kernel: the hand-written forward kernel for this (B8) is
reached through ``repro_torch.kernels.ops.flash_attention`` and is held
against :func:`blockwise_attention` in the tests; serving's prefill calls it
on the card (``models/transformer.py``). Decode attention has one query row
per slot and a ragged depth per slot; no kernel covers it, and it stays
plain, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30


def _scale(D: int) -> float:
    # 1/sqrt(D) rounded to f32, as the JAX package computes it
    return float(np.float32(1.0) / np.sqrt(np.float32(D)))


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, scale: float, dtype=torch.float32) -> torch.Tensor:
    """q: (B, Sq, KVH, G, D), k: (B, Sk, KVH, D) -> (B, KVH, G, Sq, Sk).

    Products of the inputs' values summed in f32 (exact widening of bf16
    inputs), then scaled; ``dtype`` is the dtype of the score buffer."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.to(torch.float32), k.to(torch.float32))
    return (s * scale).to(dtype)


def _gqa_out(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p: (B, KVH, G, Sq, Sk), v: (B, Sk, KVH, D) -> (B, Sq, KVH, G, D)."""
    return torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                   window: Optional[int] = None) -> torch.Tensor:
    """Unblocked GQA attention. q: (B, Sq, H, D), k/v: (B, Sk, KVH, D), with
    q[0] at position 0. Returns (B, Sq, H, D)."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KVH, H // KVH, D)
    scores = _gqa_scores(qg, k, _scale(D))
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return _gqa_out(probs, v).reshape(B, Sq, H, D)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None, q_block: int = 512, kv_block: int = 512,
                        valid_len: Optional[int] = None,
                        score_dtype=torch.float32) -> torch.Tensor:
    """Flash-style self-attention (Sq == Sk == S), shapes as :func:`full_attention`."""
    B, S, H, D = q.shape
    KVH = k.shape[2]
    G = H // KVH
    if window is not None and causal and window >= S:
        window = None  # a window covering the whole sequence is causal attention
    if S <= q_block:
        return full_attention(q, k, v, causal=causal, window=window)
    if S % q_block or S % kv_block:
        # pad to a block multiple; padded KV is masked out via valid_len
        pad = (-S) % max(q_block, kv_block)
        widths = (0, 0, 0, 0, 0, pad)
        out = blockwise_attention(
            torch.nn.functional.pad(q, widths), torch.nn.functional.pad(k, widths),
            torch.nn.functional.pad(v, widths), causal=causal, window=window,
            q_block=q_block, kv_block=kv_block, valid_len=S, score_dtype=score_dtype,
        )
        return out[:, :S]

    scale = _scale(D)
    nq = S // q_block
    qg = q.reshape(B, nq, q_block, KVH, G, D)
    dev = q.device
    outs = []
    if window is not None:
        # pad the window up to a kv_block multiple and slice [q_start-wpad, q_end)
        wpad = ((window + kv_block - 1) // kv_block) * kv_block
        span = wpad + q_block
        kp = torch.nn.functional.pad(k, (0, 0, 0, 0, wpad, 0))
        vp = torch.nn.functional.pad(v, (0, 0, 0, 0, wpad, 0))
        for qi in range(nq):
            start = qi * q_block
            scores = _gqa_scores(qg[:, qi], kp[:, start : start + span], scale, score_dtype)
            q_pos = start + wpad + torch.arange(q_block, device=dev)[:, None]
            k_pos = start + torch.arange(span, device=dev)[None, :]
            mask = (k_pos <= q_pos) & (k_pos > q_pos - window) & (k_pos >= wpad)
            if valid_len is not None:
                mask = mask & (k_pos < wpad + valid_len)
            scores = torch.where(mask, scores.to(torch.float32), NEG_INF)
            probs = torch.softmax(scores, dim=-1).to(score_dtype)
            outs.append(_gqa_out(probs, vp[:, start : start + span]))
        return torch.stack(outs, dim=1).reshape(B, S, H, D)

    # full/causal: online softmax over all KV blocks
    nk = S // kv_block
    for qi in range(nq):
        qb = qg[:, qi]
        q_pos = qi * q_block + torch.arange(q_block, device=dev)
        m = torch.full((B, KVH, G, q_block), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, KVH, G, q_block), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KVH, G, q_block, D), dtype=torch.float32, device=dev)
        for ki in range(nk):
            kb = k[:, ki * kv_block : (ki + 1) * kv_block]
            vb = v[:, ki * kv_block : (ki + 1) * kv_block]
            scores = _gqa_scores(qb, kb, scale, score_dtype)
            k_pos = ki * kv_block + torch.arange(kv_block, device=dev)
            if causal or valid_len is not None:
                mask = torch.ones((q_block, kv_block), dtype=torch.bool, device=dev)
                if causal:
                    mask = mask & (k_pos[None, :] <= q_pos[:, None])
                if valid_len is not None:
                    mask = mask & (k_pos < valid_len)[None, :]
                scores = torch.where(mask, scores, NEG_INF)
            m_new = torch.maximum(m, scores.amax(dim=-1).to(torch.float32))
            alpha = torch.exp(m - m_new)
            p = torch.exp(scores.to(torch.float32) - m_new[..., None]).to(score_dtype)
            l = l * alpha + p.sum(dim=-1).to(torch.float32)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p, vb.to(score_dtype)).to(torch.float32)
            acc = acc * alpha[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))  # (B, qb, KVH, G, D)
    return torch.stack(outs, dim=1).reshape(B, S, H, D)


def scatter_decode_kv(cache: torch.Tensor, update: torch.Tensor, slot) -> torch.Tensor:
    """Write a decode step's KV into its cache slot(s), in place; returns
    ``cache``.

    cache: (B, T, KVH, D); update: (B, 1, KVH, D); ``slot`` a scalar write
    index (uniform batch) or a (B,) tensor of per-row indices (continuous
    batching). An index is clamped into [0, T), as the JAX package's
    dynamic update slice clamps its start.
    """
    T = cache.shape[1]
    slot = torch.clamp(torch.as_tensor(slot, device=cache.device), 0, T - 1)
    if slot.dim() == 1:
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, slot] = update[:, 0].to(cache.dtype)
    else:
        cache.index_copy_(1, slot.reshape(1), update.to(cache.dtype))
    return cache


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, position, *,
                     ring: bool = False, window: Optional[int] = None) -> torch.Tensor:
    """One-token attention against a cache.

    q: (B, 1, H, D); caches: (B, T, KVH, D). ``position``, the number of
    tokens before this one, is a scalar (uniform batch) or a (B,) tensor
    of per-row positions (continuous batching, each slot at its own
    depth). Slot t is valid when ``t <= position``; for a ring-buffer cache
    (``ring``, a sliding window) when ``t < min(position + 1, T)``: once
    the ring is full every slot holds one of the last T positions, and the
    softmax does not depend on their order. A flat cache (slot t holds
    position t) longer than a sliding ``window`` also masks the slots at
    or before ``position - window``, as the training forward does; the JAX
    package's decode does not (ROADMAP.md §C, C10). A ring holds no more
    than the window, so it needs no such mask.
    """
    B, _, H, D = q.shape
    T, KVH = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, 1, KVH, H // KVH, D)
    scores = _gqa_scores(qg, k_cache, _scale(D))  # (B, KVH, G, 1, T)
    slot = torch.arange(T, device=q.device)
    pos = torch.as_tensor(position, device=q.device)
    limit = torch.clamp(pos + 1, max=T) if ring else pos + 1
    valid = slot < limit[..., None]  # (B, T) per slot, (T,) uniform
    if window is not None and not ring:
        valid = valid & (slot > pos[..., None] - window)
    if valid.dim() == 2:
        valid = valid[:, None, None, None, :]
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return _gqa_out(probs, v_cache).reshape(B, 1, H, D)
