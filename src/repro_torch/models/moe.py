"""Mixture-of-Experts with capacity-based grouped dispatch (port of
``repro.models.moe``).

Tokens are routed within *groups* of ``router_group_size`` tokens, each
expert taking at most ``capacity = ceil(G * top_k * cf / E)`` tokens of a
group; the choices past an expert's capacity are dropped. Dispatch and
combine are einsums against a ``(..., G, E, C)`` mask, as in the JAX
package: its experts have no Pallas kernel, and the port's stay plain
PyTorch too.

The routed experts and the router are part of the frozen base model; LoRA
covers the attention projections only (the JAX package's ``init_lora``).
The Switch-style load-balance aux loss is returned for the training loss.

Where JAX's primitives and PyTorch's differ, the port follows JAX's:
``jax.lax.top_k`` puts the lower expert first among equal probabilities,
which ``torch.topk`` does not promise, so the choices come from a stable
descending sort; ``jax.nn.one_hot`` gives a zero row for an index past its
width, so the one-hots are comparisons with an ``arange``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import MoEConfig
from repro_torch.models import sharding_ctx
from repro_torch.models.layers import init_stacked_dense


def _init_experts(gen: torch.Generator, n_layers: int, E: int, d_in: int, d_out: int, dtype, device):
    """(L, E, d_in, d_out) N(0, 1/d_in) weights, drawn in f32 one expert at
    a time and cast, so the peak stays near the ``dtype`` size (a full-width
    llama4 layer's ``e_gate`` alone is 21.5 GB in f32)."""
    w = torch.empty((n_layers, E, d_in, d_out), dtype=dtype, device=device)
    for layer in range(n_layers):
        for e in range(E):
            w[layer, e] = torch.randn((d_in, d_out), generator=gen, device=device) / math.sqrt(d_in)
    return w


def init_moe(gen: torch.Generator, n_layers: int, d_model: int, mcfg: MoEConfig, dtype, device):
    """The router (L, D, E), the routed experts' SwiGLU (L, E, D, Fe) /
    (L, E, Fe, D) and, with ``shared_expert``, the shared expert's (L, D,
    Fs) / (L, Fs, D), drawn from ``gen`` (a generator on ``device``) with the
    JAX package's distributions."""
    E, Fe = mcfg.num_experts, mcfg.d_ff_expert
    p = {
        "router": (torch.randn((n_layers, d_model, E), generator=gen, device=device) * 0.02).to(dtype),
        "e_gate": _init_experts(gen, n_layers, E, d_model, Fe, dtype, device),
        "e_up": _init_experts(gen, n_layers, E, d_model, Fe, dtype, device),
        "e_down": _init_experts(gen, n_layers, E, Fe, d_model, dtype, device),
    }
    if mcfg.shared_expert:
        Fs = mcfg.d_ff_shared
        p["s_gate"] = init_stacked_dense(gen, n_layers, d_model, Fs, dtype, device)
        p["s_up"] = init_stacked_dense(gen, n_layers, d_model, Fs, dtype, device)
        p["s_down"] = init_stacked_dense(gen, n_layers, Fs, d_model, dtype, device)
    return p


def capacity(group: int, mcfg: MoEConfig) -> int:
    c = math.ceil(group * mcfg.top_k * mcfg.capacity_factor / mcfg.num_experts)
    return max(int(c), 1)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hots of ``idx`` over ``n`` classes; an index outside [0, n)
    gives a zero row (``jax.nn.one_hot``'s rule)."""
    return (idx[..., None] == torch.arange(n, device=idx.device, dtype=idx.dtype)).to(torch.float32)


def route(x: torch.Tensor, router_w: torch.Tensor, mcfg: MoEConfig,
          sample_weight: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (..., G, D) groups of tokens. Returns ``(dispatch, combine,
    aux_loss)``, dispatch and combine (..., G, E, C) f32: a token's slot in
    an expert's queue and its renormalized gate there.

    A token's top_k experts are taken by probability, the lower index first
    among equals; its choices queue in token order, then k order, and those
    past the expert's capacity C are dropped. ``sample_weight`` (B,) makes
    the aux loss a weight-average over the samples of a (B, n_groups, G, D)
    batch (groups never span samples), so padded batches score like their
    ragged originals; routing itself needs no mask.
    """
    E, K = mcfg.num_experts, mcfg.top_k
    G = x.shape[-2]
    C = capacity(G, mcfg)
    logits = x @ router_w.to(x.dtype)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)  # (..., G, E)

    gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :K]  # (..., G, K)
    gate_vals = torch.gather(probs, -1, gate_idx)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    onehot = _one_hot(gate_idx, E)  # (..., G, K, E)
    # each choice's place in its expert's queue: a count over the flattened
    # (G*K) axis, ordered by token, then by k
    flat = onehot.reshape(*onehot.shape[:-3], G * K, E)
    pos = (torch.cumsum(flat, dim=-2) - flat).reshape(onehot.shape)
    # A token picks an expert at most once, so over k each (token, expert)
    # has at most one term: the sums below are exact, and the (..., G, E, C)
    # masks equal the JAX package's sums over k of its (..., G, K, E, C)
    # ones without building them. A slot at or past C matches no column.
    slot = torch.sum(onehot * pos, dim=-2)  # (..., G, E)
    picked = torch.sum(onehot, dim=-2)
    gate = torch.sum(onehot * gate_vals[..., None], dim=-2)
    dispatch = picked[..., None] * _one_hot(slot, C)
    combine = dispatch * gate[..., None]

    me = torch.mean(probs, dim=-2)  # (..., E) mean router probability
    ce = torch.mean(picked, dim=-2) / K  # share routed
    per_group = torch.sum(me * ce, dim=-1)  # (B, n_groups) for a training batch
    if sample_weight is None:
        aux = torch.mean(per_group) * E * mcfg.aux_loss_weight
    else:
        if per_group.dim() != 2:
            raise ValueError("sample_weight needs (B, n_groups, G, D) tokens")
        sw = sample_weight.to(torch.float32)
        denom = torch.clamp(torch.sum(sw), min=1.0) * per_group.shape[-1]
        aux = torch.sum(per_group * sw[:, None]) / denom * E * mcfg.aux_loss_weight
    return dispatch, combine, aux


def _experts(xe, combine, e_gate, e_up, e_down):
    """The routed experts' SwiGLU over their dispatched slots ``xe`` (E, B,
    n, C, D), combined back to the tokens (B, n, G, D)."""
    g = torch.einsum("ebncd,edf->ebncf", xe, e_gate)
    u = torch.einsum("ebncd,edf->ebncf", xe, e_up)
    h = F.silu(g.to(torch.float32)).to(xe.dtype) * u
    ye = torch.einsum("ebncf,efd->ebncd", h, e_down)
    return torch.einsum("ebncd,bngec->bngd", ye, combine)


def apply_moe(x: torch.Tensor, p, mcfg: MoEConfig, *,
              sample_weight: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D); ``p`` one layer's slice. Returns ``(y, aux_loss)``.

    A decode step (S == 1) routes the whole batch as one group, mixing the
    rows (so ``sample_weight`` does not apply); otherwise each sample routes
    in groups of ``min(router_group_size, S)`` tokens, which must divide S.
    ``sample_weight`` (B,) makes the aux loss ignore padding samples (see
    :func:`route`); it never changes routing or outputs.
    """
    B, S, D = x.shape
    if S == 1:
        xg = x.reshape(1, 1, B, D)
        sample_weight = None
    else:
        G = min(mcfg.router_group_size, S)
        if S % G:
            raise ValueError(f"sequence length {S} is not a whole number of routing groups of {G}")
        xg = x.reshape(B, S // G, G, D)
    dispatch, combine, aux = route(xg, p["router"], mcfg, sample_weight=sample_weight)
    xe = torch.einsum("bngec,bngd->ebncd", dispatch.to(x.dtype), xg)
    y = sharding_ctx.local_experts(_experts, xe, combine.to(x.dtype), p["e_gate"], p["e_up"],
                                   p["e_down"]).reshape(B, S, D)
    if mcfg.shared_expert:
        g = x @ p["s_gate"]
        u = x @ p["s_up"]
        h = F.silu(g.to(torch.float32)).to(x.dtype) * u
        y = y + h @ p["s_down"]
    return y, aux
