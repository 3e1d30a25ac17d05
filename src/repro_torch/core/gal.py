"""Global Aggregation Layer (GAL) selection (paper §4.3.1).

Per device:
  1. :func:`adversarial_perturbation`: worst-case embedding noise ε* within
     budget γ (Eq. 6-8, the SAM dual-norm solution).
  2. :func:`layer_sensitivity_scores`: relative Frobenius-norm change of
     every layer's output under ε* (Eq. 9-10), through ``forward_probe``.
  3. Server: :func:`aggregate_layer_scores` (Eq. 11) weights by n_k.
  4. :func:`lossless_criterion` (JAX's ``lossless_rank_fraction``): the "lossless"
     layer-count criterion.
     Lanczos Ritz values of the local loss's Hessian on the LoRA subspace;
     the first eigengap λ_{r+1} − λ_r above 4·Lipschitz(H·Δ − ∇L(Δ+P))
     gives N*_k = (1 − r/R)·L (Zhang et al. 2021).
  5. :func:`select_gal_layers` keeps the top-N* layers, N* from
     :func:`gal_layer_count`.

As in the JAX package, Eq. 8 is implemented in Foret et al.'s dual-norm
form ``γ · sign(g)|g|^{q-1} / (‖g‖_q^q)^{1/p}``.

The random starting vector of Lanczos and the Lipschitz probes cannot
replay ``jax.random``. They come from a ``draw(leaf_index, shape) -> f32
tensor`` callable, called leaf by leaf in the LoRA tree's sorted leaf order:
first the starting vector's leaves, then each probe's. A runner backs it
with a ``torch.Generator``; a parity test hands it the JAX package's draws.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch.func import grad, jvp

from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

Draw = Callable[[int, Tuple[int, ...]], torch.Tensor]


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


def embedding_grad(loss_from_noise: Callable[[torch.Tensor], torch.Tensor], noise_shape: Tuple[int, ...],
                   dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """Gradient of the loss at zero embedding noise."""
    return grad(loss_from_noise)(torch.zeros(noise_shape, dtype=dtype, device=device))


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

    g = embedding_grad(loss_of_noise, noise_shape, device=device)
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


def _tree_dot(a, b) -> torch.Tensor:
    return sum(torch.vdot(x.to(torch.float32).reshape(-1), y.to(torch.float32).reshape(-1))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _tree_axpy(alpha, x, y):  # alpha*x + y
    return tree_map(lambda xx, yy: alpha * xx + yy, x, y)


def _tree_normalize(x):
    nrm = torch.sqrt(_tree_dot(x, x))
    return tree_map(lambda xx: xx / torch.clamp(nrm, min=1e-20), x), nrm


def _draw_tree(like, draw: Draw):
    """A tree of ``like``'s structure, leaf j drawn as ``draw(j, shape)``."""
    return tree_unflatten(like, [draw(j, tuple(leaf.shape)) for j, leaf in enumerate(tree_leaves(like))])


def lanczos_spectrum(hvp: Callable[[Any], Any], v0, iters: int) -> np.ndarray:
    """Lanczos tridiagonalization -> Ritz values (ascending), a host loop.

    hvp: tree -> tree Hessian-vector product on the LoRA subspace. The
    tridiagonal eigensolve is numpy's, on the host, as in the JAX package.
    """
    alphas: List[float] = []
    betas: List[float] = []
    v, _ = _tree_normalize(v0)
    v_prev = tree_map(torch.zeros_like, v)
    beta = 0.0
    for _ in range(iters):
        w = hvp(v)
        alpha = float(_tree_dot(w, v))
        w = _tree_axpy(-alpha, v, w)
        w = _tree_axpy(-beta, v_prev, w)
        alphas.append(alpha)
        v_prev = v
        v, beta_t = _tree_normalize(w)
        beta = float(beta_t)
        if beta < 1e-10:
            break
        betas.append(beta)
    T = np.diag(alphas)
    for i, b in enumerate(betas[: len(alphas) - 1]):
        T[i, i + 1] = T[i + 1, i] = b
    return np.sort(np.linalg.eigvalsh(T))


def make_lora_hvp(loss_fn: Callable, params, lora, batch) -> Callable:
    """Hessian-vector product of the local loss w.r.t. the LoRA parameters:
    forward over reverse (``torch.func.jvp`` of ``torch.func.grad``), as the
    JAX package's ``jax.jvp(jax.grad(...))``."""
    grad_fn = grad(lambda lo: loss_fn(params, lo, batch))

    def hvp(v):
        return jvp(grad_fn, (lora,), (v,))[1]

    return hvp


def estimate_lipschitz(loss_fn: Callable, params, lora, batch, draw: Draw, *, n_probes: int = 4,
                       scale: float = 1e-2) -> float:
    """Lipschitz constant of Δ ↦ H(P)Δ − ∇L(Δ + P) by random probing.

    It measures how fast the Hessian varies around P (0 for an exactly
    quadratic loss): the 4·L margin of the eigengap criterion. Probe i draws
    one normal tree through ``draw``, scaled to norm ``scale``.
    """
    grad_fn = grad(lambda lo: loss_fn(params, lo, batch))
    hvp = make_lora_hvp(loss_fn, params, lora, batch)
    g0 = grad_fn(lora)
    best = 0.0
    for _ in range(n_probes):
        delta, _ = _tree_normalize(_draw_tree(lora, draw))
        delta = tree_map(lambda d: d * scale, delta)
        # f(Δ) − f(0) = HΔ − (∇L(P+Δ) − ∇L(P))
        hd = hvp(delta)
        g1 = grad_fn(tree_map(torch.add, lora, delta))
        diff = tree_map(lambda a, b, c: a - (b - c), hd, g1, g0)
        num = float(torch.sqrt(_tree_dot(diff, diff)))
        den = float(torch.sqrt(_tree_dot(delta, delta)))
        best = max(best, num / max(den, 1e-20))
    return best


def lossless_criterion(loss_fn: Callable, params, lora, batch, draw: Draw, *, iters: int = 16) -> Dict[str, Any]:
    """The lossless criterion (paper §4.3.1; the JAX package's
    ``lossless_rank_fraction``) with what it read: ``{"eigs": Ritz values
    (ascending), "lipschitz": L, "fraction": 1 − r/R}``, the fraction of
    layers/neurons to keep, r + 1 the index of the first eigengap above
    4·L (r = 0, keep everything, when none is). The starting vector's
    leaves are drawn first, then the probes'."""
    hvp = make_lora_hvp(loss_fn, params, lora, batch)
    eigs = lanczos_spectrum(hvp, _draw_tree(lora, draw), iters)
    lip = estimate_lipschitz(loss_fn, params, lora, batch, draw)
    idx = np.nonzero(np.diff(eigs) > 4.0 * lip)[0]
    r = int(idx[0] + 1) if len(idx) else 0
    return {"eigs": eigs, "lipschitz": lip, "fraction": float(1.0 - r / len(eigs))}


def lossless_rank_fraction(loss_fn: Callable, params, lora, batch, draw: Draw, *, iters: int = 16) -> float:
    """(1 − r/R) from the first eigengap > 4·Lipschitz (paper §4.3.1): the
    fraction of layers/neurons to keep, 1.0 when no gap clears the margin.
    :func:`lossless_criterion`'s fraction; ``draw`` takes the place of the
    JAX package's key."""
    return lossless_criterion(loss_fn, params, lora, batch, draw, iters=iters)["fraction"]


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
