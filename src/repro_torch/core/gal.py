"""Global Aggregation Layer (GAL) selection (paper §4.3.1).

Per device:
  1. :func:`adversarial_perturbation`: worst-case embedding noise ε* within
     budget γ (Eq. 6-8, the SAM dual-norm solution).
  2. :func:`layer_sensitivity_scores`: relative Frobenius-norm change of
     every layer's output under ε* (Eq. 9-10), through ``forward_probe``.
  3. Server: :func:`aggregate_layer_scores` (Eq. 11) weights by n_k, and
     :func:`select_gal_layers` keeps the top-N* layers, N* from
     :func:`gal_layer_count`.

As in the JAX package, Eq. 8 is implemented in Foret et al.'s dual-norm
form ``γ · sign(g)|g|^{q-1} / (‖g‖_q^q)^{1/p}``. The lossless layer-count
criterion (Lanczos Hessian spectrum + Lipschitz margin) is not ported yet.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Sequence, Tuple

import numpy as np
import torch
from torch.func import grad


def adversarial_perturbation(g_in: torch.Tensor, gamma: float, p: float = 2.0) -> torch.Tensor:
    """Dual-norm maximizer of ε^T g s.t. ‖ε‖_p ≤ γ, per sample (the norm is
    taken over all non-batch axes)."""
    g = g_in.to(torch.float32)
    if p == math.inf:
        return (gamma * torch.sign(g)).to(g_in.dtype)
    q = p / (p - 1.0)
    dims = tuple(range(1, g.dim()))
    gq = torch.sum(torch.abs(g) ** q, dim=dims, keepdim=True)
    eps = gamma * torch.sign(g) * torch.abs(g) ** (q - 1.0) / torch.clamp(gq ** (1.0 / p), min=1e-20)
    return eps.to(g_in.dtype)


def layer_sensitivity_scores(probe_fn: Callable[..., Any],
                             loss_fn_from_logits: Callable[[torch.Tensor, Any], torch.Tensor],
                             params, lora, batch, *, gamma: float, p: float = 2.0,
                             noise_shape: Tuple[int, ...]) -> torch.Tensor:
    """Per-layer importance scores I_k^l on one batch, (L_logical,).

    probe_fn(params, lora, batch, embed_noise) -> (logits, aux, norms (L, B)).
    """
    device = next(iter(batch.values())).device

    def loss_of_noise(noise):
        logits, _, _ = probe_fn(params, lora, batch, noise)
        return loss_fn_from_logits(logits, batch)

    g = grad(loss_of_noise)(torch.zeros(noise_shape, dtype=torch.float32, device=device))
    eps = adversarial_perturbation(g, gamma, p)
    with torch.no_grad():
        _, _, norms_clean = probe_fn(params, lora, batch, None)
        _, _, norms_pert = probe_fn(params, lora, batch, eps)
    rel = (norms_pert - norms_clean) / torch.clamp(norms_clean, min=1e-12)  # (L, B)
    return torch.mean(torch.abs(rel), dim=-1)


def aggregate_layer_scores(scores_per_device: Sequence[np.ndarray], n_samples: Sequence[int]) -> np.ndarray:
    """Server-side weighted average (Eq. 11)."""
    n = np.asarray(n_samples, np.float64)
    stacked = np.stack([np.asarray(s, np.float64) for s in scores_per_device])
    return (stacked * n[:, None]).sum(0) / n.sum()


def select_gal_layers(global_scores: np.ndarray, n_star: int) -> np.ndarray:
    """Boolean mask of the n_star highest-importance layers."""
    L = len(global_scores)
    n_star = int(np.clip(n_star, 1, L))
    order = np.argsort(-np.asarray(global_scores))
    mask = np.zeros(L, bool)
    mask[order[:n_star]] = True
    return mask


def gal_layer_count(per_device_fractions: Sequence[float], n_samples: Sequence[int],
                    num_layers: int, mu: float = 1.0) -> int:
    """N* = μ/N · Σ n_k · N*_k with N*_k = fraction_k · L (paper §4.3.1)."""
    n = np.asarray(n_samples, np.float64)
    frac = np.asarray(per_device_fractions, np.float64)
    n_star = mu * float((n * frac * num_layers).sum() / n.sum())
    return int(np.clip(round(n_star), 1, num_layers))
