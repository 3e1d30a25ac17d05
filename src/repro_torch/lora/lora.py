"""LoRA parameter trees + FibecFed masking helpers (port of ``repro.lora``).

The LoRA tree keeps the JAX package's stacked layout, which GAL masks,
neuron masks, optimizer state and comm accounting all follow:
``{"layers": {target: {"a": (L, d_in, r), "b": (L, r, d_out)}}}``, the
targets wq/wk/wv/wo (dense, moe, vlm, encoder) or in_proj/out_proj (ssm);
the encoder-decoder's ``{"encoder": wq..wo (Le), "decoder": wq..wo and the
cross-attention's cwq..cwo (Ld)}``, its Le + Ld logical layers the
encoder's first; the hybrid's is
``{"mamba": stacked (L) in_proj/out_proj, "shared": unstacked (d_in, r) /
(r, d_out) wq/wk/wv/wo}``, its shared attention block one logical layer
after the L Mamba layers.

FibecFed works on this tree at two granularities:

* **GAL (layer) masks**: one 0/1 value per logical layer, as broadcastable
  ``(L, 1, 1)`` leaves. GAL layers' LoRA is globally aggregated, the rest
  stays client-local (paper §4.3.1).
* **Neuron masks**: 0/1 over the output dimension of each target, expanded
  to full leaf shape. Frozen neurons mask the columns of LoRA ``b``; ``a``
  stays trainable (paper §4.3.2).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.utils.tree import tree_leaves, tree_map


def _attn_dims(cfg: ModelConfig) -> Dict[str, tuple]:
    hd = cfg.resolved_head_dim
    return {
        "wq": (cfg.d_model, cfg.num_heads * hd),
        "wk": (cfg.d_model, cfg.num_kv_heads * hd),
        "wv": (cfg.d_model, cfg.num_kv_heads * hd),
        "wo": (cfg.num_heads * hd, cfg.d_model),
    }


def _ssm_lora_dims(cfg: ModelConfig) -> Dict[str, tuple]:
    from repro_torch.models.ssm import ssm_dims  # lazy: breaks the lora <-> models cycle

    dims = ssm_dims(cfg)
    return {"in_proj": (cfg.d_model, dims["in_dim"]), "out_proj": (dims["d_inner"], cfg.d_model)}


def _target_stack(generator: torch.Generator, n_layers: int, dims: Dict[str, tuple], rank: int, device):
    """``{target: {"a", "b"}}``, stacked over ``n_layers`` (0: unstacked)."""
    lead = (n_layers,) if n_layers else ()
    out = {}
    for t, (d_in, d_out) in sorted(dims.items()):
        a = torch.randn(lead + (d_in, rank), generator=generator, device=device) / rank
        out[t] = {"a": a, "b": torch.zeros(lead + (rank, d_out), device=device)}
    return out


def init_lora(generator: torch.Generator, cfg: ModelConfig, device) -> Dict[str, Any]:
    """``a ~ N(0, 1)/r``, ``b = 0``, f32: the attention projections of the
    dense, moe, vlm and encoder families (the routed and shared experts
    stay frozen, as the JAX package's code has it), in_proj and out_proj of
    the ssm one, stacked over layers; for the hybrid, the Mamba layers'
    stacked and the shared block's attention unstacked; for the
    encoder-decoder, the encoder's attention (Le) and the decoder's self-
    and cross-attention (Ld) apart.

    The draws come from ``generator`` (a ``torch.Generator`` on ``device``);
    they are not the JAX package's ``jax.random`` draws.
    """
    rank, L = cfg.lora_rank, cfg.num_layers
    if cfg.family in ("encdec", "audio"):
        attn = _attn_dims(cfg)
        return {"encoder": _target_stack(generator, cfg.encoder_layers, attn, rank, device),
                "decoder": _target_stack(generator, L, {**attn, **{f"c{k}": v for k, v in attn.items()}}, rank,
                                         device)}
    if cfg.family == "ssm":
        return {"layers": _target_stack(generator, L, _ssm_lora_dims(cfg), rank, device)}
    if cfg.family == "hybrid":
        return {"mamba": _target_stack(generator, L, _ssm_lora_dims(cfg), rank, device),
                "shared": _target_stack(generator, 0, _attn_dims(cfg), rank, device)}
    # dense / moe / vlm / encoder
    return {"layers": _target_stack(generator, L, _attn_dims(cfg), rank, device)}


def zeros_like_lora(lora) -> Any:
    return tree_map(torch.zeros_like, lora)


def lora_param_count(lora) -> int:
    return sum(int(x.numel()) for x in tree_leaves(lora))


def lora_num_logical_layers(cfg: ModelConfig) -> int:
    if cfg.family in ("encdec", "audio"):
        return cfg.encoder_layers + cfg.num_layers
    if cfg.family == "hybrid":
        return cfg.num_layers + 1  # + the shared attention block
    return cfg.num_layers


def _group_offsets(cfg: ModelConfig) -> Dict[str, tuple]:
    """Top-level LoRA group -> (layer offset, n_layers | 0 for unstacked)."""
    if cfg.family in ("encdec", "audio"):
        return {"encoder": (0, cfg.encoder_layers), "decoder": (cfg.encoder_layers, cfg.num_layers)}
    if cfg.family == "hybrid":
        return {"mamba": (0, cfg.num_layers), "shared": (cfg.num_layers, 0)}
    return {"layers": (0, cfg.num_layers)}


def lora_layer_index_tree(cfg: ModelConfig, lora) -> Any:
    """A tree matching ``lora`` whose leaves are int64 tensors of per-slice
    layer ids: (L, 1, ...) for a stacked group, a scalar for an unstacked one."""
    out = {}
    for group, (offset, n) in _group_offsets(cfg).items():
        idx = torch.arange(offset, offset + n) if n else torch.tensor(offset)

        def mk(leaf, idx=idx, stacked=bool(n)):
            ids = idx.to(leaf.device)
            return ids.reshape((len(idx),) + (1,) * (leaf.dim() - 1)) if stacked else ids

        out[group] = tree_map(mk, lora[group])
    return out


def stack_adapter_trees(adapters) -> Any:
    """Stack same-shaped LoRA trees along a new leading adapter axis: each
    leaf (L, d_in, r) becomes (A, L, d_in, r). The registry format of
    multi-tenant serving."""
    return tree_map(lambda *ls: torch.stack(ls), *adapters)


def gather_adapter_slots(cfg: ModelConfig, stacked, idx: torch.Tensor) -> Any:
    """Per-slot adapters out of a :func:`stack_adapter_trees` stack.

    ``idx``: (B,) adapter index per batch slot, on the stack's device.
    Stacked-group leaves (A, L, ...) gather to (B, L, ...) and the layer axis
    moves back in front, (L, B, ...), so a layer loop slices per-slot
    (B, ...) leaves that :func:`repro_torch.models.layers.linear` applies row
    by row. The result is contiguous, so each layer's slice is too.
    """
    out = {}
    for group, (_, n) in _group_offsets(cfg).items():
        if n:
            out[group] = tree_map(lambda leaf: leaf[idx].movedim(0, 1).contiguous(), stacked[group])
        else:
            out[group] = tree_map(lambda leaf: leaf[idx], stacked[group])
    return out


def gal_mask_tree(cfg: ModelConfig, lora, gal_layers) -> Any:
    """``gal_layers``: bool (num_logical_layers,). Returns f32 {0., 1.} masks
    matching ``lora``, broadcastable ``(L, 1, 1)`` for stacked leaves."""
    gal = np.asarray(gal_layers, np.float32)
    out = {}
    for group, (offset, n) in _group_offsets(cfg).items():
        g = {}
        for t, ab in lora[group].items():
            g[t] = {}
            for name, leaf in ab.items():
                if n:
                    seg = gal[offset : offset + n].reshape((n,) + (1,) * (leaf.dim() - 1))
                else:
                    seg = gal[offset]
                g[t][name] = torch.as_tensor(seg, dtype=torch.float32, device=leaf.device)
        out[group] = g
    return out


def rank_mask_tree(lora, rank: int) -> Any:
    """Per-leaf f32 {0., 1.} masks keeping only the first ``rank`` LoRA rank
    components trainable (resource-adaptive per-client rank).

    A rank-``r_i`` client updates the leading ``r_i`` columns of ``a`` and
    rows of ``b``; the rest stay frozen at the pulled global values, so its
    delta is exactly zero beyond ``r_i`` and rank-heterogeneous aggregation
    is plain masked FedAvg. ``rank >=`` the LoRA rank gives all ones.
    """

    def mk(ab):
        r = ab["a"].shape[-1]
        keep = (torch.arange(r, device=ab["a"].device) < rank).to(torch.float32)
        return {
            "a": keep * torch.ones_like(ab["a"], dtype=torch.float32),
            "b": keep[:, None] * torch.ones_like(ab["b"], dtype=torch.float32),
        }

    return {group: {t: mk(ab) for t, ab in targets.items()} for group, targets in lora.items()}


def neuron_mask_tree(cfg: ModelConfig, lora, neuron_masks: Dict[str, Any]) -> Any:
    """Full-shape per-leaf update masks from per-target neuron keep-masks.

    ``neuron_masks``: ``{group: {target: keep (L, d_out) or (d_out,)}}``. The
    mask multiplies LoRA ``b`` columns; ``a`` is always trainable (1.0).
    """
    del cfg  # the tree structure alone decides the layout
    out = {}
    for group, targets in lora.items():
        g = {}
        for t, ab in targets.items():
            keep = neuron_masks[group][t].to(torch.float32)
            bmask = keep[:, None, :] if ab["b"].dim() == 3 else keep[None, :]
            g[t] = {
                "a": torch.ones_like(ab["a"], dtype=torch.float32),
                "b": (bmask * torch.ones_like(ab["b"], dtype=torch.float32)).contiguous(),
            }
        out[group] = g
    return out
