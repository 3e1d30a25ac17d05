"""Local update parameter selection (paper §4.3.2).

Momentum-averaged diag-FIM → neuron-wise aggregation (Eq. 12) → keep the
top-ρ neurons per layer trainable, freeze the rest. A neuron is an output
unit of the full weight matrix; under LoRA it maps to a column of ``b``, so
its score is ``Σ_r F[b][l, r, μ]`` and freezing masks that column's updates
(:func:`repro_torch.lora.neuron_mask_tree`).
"""
from __future__ import annotations

from typing import Any, Dict

import torch


def neuron_importance(fim_tree) -> Dict[str, Any]:
    """{group: {target: scores (L, d_out) or (d_out,)}}: the FIM mass of
    each output neuron (only ``b`` distinguishes neurons)."""
    return {
        group: {t: torch.sum(ab["b"], dim=-2) for t, ab in targets.items()}
        for group, targets in fim_tree.items()
    }


def select_neuron_masks(importance: Dict[str, Any], rho: float) -> Dict[str, Any]:
    """Keep the top-ρ fraction of neurons per (layer, target): f32 0/1
    masks, with every neuron that ties the k-th largest score kept."""
    out: Dict[str, Any] = {}
    for group, targets in importance.items():
        g = {}
        for t, scores in targets.items():
            d_out = scores.shape[-1]
            k = max(1, int(round(rho * d_out)))
            thresh = torch.sort(scores, dim=-1).values[..., d_out - k]
            g[t] = (scores >= thresh[..., None]).to(torch.float32)
        out[group] = g
    return out
