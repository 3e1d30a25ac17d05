"""Fisher information utilities (paper §4.2, Formulas 3-5, 16-17).

The empirical FIM is approximated by its diagonal: for the per-sample
gradient g_i of the loss, the diagonal is g_i ⊙ g_i and the difficulty score
is its trace Tr(F̃_i) = Σ g_i². Everything works on the LoRA tree only (the
base model is frozen). Per-sample gradients are ``torch.func.vmap`` of
``torch.func.grad`` over singleton-batch slices, as the JAX package does
with ``jax.vmap(jax.grad)``.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.func import grad, vmap

from repro_torch.utils.tree import tree_leaves, tree_map


def _tree_sum_of_squares(tree) -> torch.Tensor:
    return sum(torch.sum(torch.square(leaf.to(torch.float32))) for leaf in tree_leaves(tree))


def _singleton_batches(batch):
    # a singleton batch axis per sample, so loss_fn sees batch-shaped input
    return {k: v[:, None] for k, v in batch.items()}


def per_sample_fisher_scores(loss_fn: Callable[..., torch.Tensor], params, lora, batch) -> torch.Tensor:
    """Difficulty score Tr(F̃_i) per sample (Formula 16), (n_samples,) f32."""

    def one(sample):
        g = grad(lambda lo: loss_fn(params, lo, sample))(lora)
        return _tree_sum_of_squares(g)

    return vmap(one)(_singleton_batches(batch))


def batch_fisher_scores(loss_fn, params, lora, batches, sample_mask) -> torch.Tensor:
    """Difficulty score per *batch* (Formula 17): the sum of its members'
    scores. ``batches`` leaves carry leading (n_batches, batch_size) axes;
    ``sample_mask`` (n_batches, batch_size) zeroes padding samples, so padded
    batches score as their ragged originals. One batch at a time, as the
    JAX package's ``lax.map``: the per-sample logits of every batch at once
    would not fit at full vocabulary."""
    n_batches = sample_mask.shape[0]
    return torch.stack([
        torch.sum(per_sample_fisher_scores(loss_fn, params, lora, {k: v[j] for k, v in batches.items()})
                  * sample_mask[j])
        for j in range(n_batches)
    ])


def fim_diag(loss_fn, params, lora, batch, sample_mask=None) -> Any:
    """Empirical average diagonal FIM over a batch (per-leaf tree): the mean
    of per-sample squared gradients, NOT the square of the mean gradient.
    ``sample_mask`` (batch_size,) restricts the mean to valid samples."""

    def one(sample):
        g = grad(lambda lo: loss_fn(params, lo, sample))(lora)
        return tree_map(lambda x: torch.square(x.to(torch.float32)), g)

    sq = vmap(one)(_singleton_batches(batch))
    if sample_mask is None:
        n = tree_leaves(batch)[0].shape[0]
        return tree_map(lambda x: torch.sum(x, dim=0) / n, sq)
    m = sample_mask.to(torch.float32)
    n = torch.clamp(torch.sum(m), min=1.0)
    return tree_map(lambda x: torch.sum(x * m.reshape((-1,) + (1,) * (x.dim() - 1)), dim=0) / n, sq)


def fim_momentum_update(fim_prev, fim_new, momentum: float):
    """F_k^t = γ·F_k^{t-1} + (1-γ)·F̃_k (paper §4.3.2)."""
    if fim_prev is None:
        return fim_new
    return tree_map(lambda a, b: momentum * a + (1.0 - momentum) * b, fim_prev, fim_new)
