"""Roofline terms of a step (port of ``repro.launch.analysis``).

Sources (the JAX package reads a compiled HLO module; the port counts the
operations an eager step runs, :mod:`repro_torch.launch.prof_stats`):

- :class:`~repro_torch.launch.prof_stats.StepCounter` over one step: the
  flops of every local operation (``torch.utils.flop_counter``'s formulas),
  the bytes each materialized output writes (the counterpart of the HLO
  walk's traffic proxy), the result bytes of every collective, per rank;
- MODEL_FLOPS = 6·N_active·tokens (train) / 2·N_active·tokens (inference),
  the "useful" share of the counted flops.

The hardware defaults to the card the port runs on, ``H100_SXM``
(989 TFLOP/s bf16 dense, 3.35 TB/s HBM3, 50 GB/s a NVLink link, from
NVIDIA's data sheet); ``TPU_V5E`` stays selectable, for parity with the
JAX package's numbers.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.config import H100_SXM, ModelConfig

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")


def model_flops(
    cfg: ModelConfig, n_params: int, n_active_params: int, tokens: int, kind: str
) -> float:
    """6·N·D for training, 2·N·D for inference (per forward token count)."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active_params * tokens


def active_param_fraction(cfg: ModelConfig) -> float:
    """Fraction of base params active per token (MoE: top-k of experts)."""
    if cfg.family != "moe" or cfg.moe is None:
        return 1.0
    m = cfg.moe
    expert_p = cfg.num_layers * m.num_experts * 3 * cfg.d_model * m.d_ff_expert
    active_expert_p = expert_p * m.top_k / m.num_experts
    hd = cfg.resolved_head_dim
    attn_p = cfg.num_layers * (
        cfg.d_model * cfg.num_heads * hd * 2
        + cfg.d_model * cfg.num_kv_heads * hd * 2
    )
    shared_p = (
        cfg.num_layers * 3 * cfg.d_model * m.d_ff_shared if m.shared_expert else 0
    )
    embed_p = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    dense_total = attn_p + shared_p + embed_p
    total = dense_total + expert_p
    active = dense_total + active_expert_p
    return active / total


def roofline_terms(
    *,
    hlo_flops: float,
    hlo_bytes: float,
    coll_bytes: float,
    chips: int,
    per_device: bool = True,
    hw=H100_SXM,
) -> Dict[str, float]:
    """Three roofline terms in seconds. Inputs are per device when
    ``per_device`` (what a rank of an SPMD step counts)."""
    scale = 1.0 if per_device else 1.0 / chips
    compute_t = hlo_flops * scale / hw.peak_flops
    memory_t = hlo_bytes * scale / hw.hbm_bandwidth
    collective_t = coll_bytes * scale / hw.ici_bandwidth
    dominant = max(
        ("compute", compute_t), ("memory", memory_t), ("collective", collective_t),
        key=lambda kv: kv[1],
    )[0]
    return {
        "compute_s": compute_t,
        "memory_s": memory_t,
        "collective_s": collective_t,
        "dominant": dominant,
    }


def summarize_step(counter, *, chips: int, hw=H100_SXM) -> Dict[str, Any]:
    """Per-rank roofline inputs of one step, from the
    :class:`~repro_torch.launch.prof_stats.StepCounter` that ran it: the
    counterpart of the JAX package's ``summarize_compiled``, with its keys.

    ``hlo_flops`` / ``hlo_bytes`` keep the JAX names: they are the step's
    counted flops and written bytes (``raw_cost_analysis`` repeats them:
    an eager count has no loop bodies to undercount). ``memory`` holds the
    step's argument and output bytes and the peak of the bytes its
    operations' outputs held alive at once (``temp_bytes``)."""
    coll = {k: float(counter.collectives.get(k, 0)) for k in COLLECTIVES}
    coll["total"] = float(sum(coll[k] for k in COLLECTIVES))
    out = {
        "hlo_flops": float(counter.flops),
        "hlo_bytes": float(counter.bytes_written),
        "collectives": coll,
        "collective_counts": dict(counter.collective_counts),
        "raw_cost_analysis": {
            "flops_unscaled": float(counter.flops),
            "bytes_accessed_unscaled": float(counter.bytes_written),
        },
        "memory": {
            "argument_bytes": counter.argument_bytes,
            "output_bytes": counter.output_bytes,
            "temp_bytes": counter.peak_live_bytes,
            "generated_code_bytes": None,
        },
    }
    out["roofline"] = roofline_terms(
        hlo_flops=out["hlo_flops"], hlo_bytes=out["hlo_bytes"], coll_bytes=coll["total"], chips=chips, hw=hw,
    )
    return out
