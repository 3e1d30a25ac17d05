"""Compressed-upload configuration and wire-format byte accounting (a copy
of ``repro.federated.compress``, which needs no JAX; the port keeps its own).

This module defines *what* the channel ships — mode, top-k ratio, value
width, error feedback — and *how many bytes* that payload costs on the wire.
The fake-quantize round trip itself is
:func:`repro_torch.kernels.ops.fake_compress` (kernel B3); the runner
charges bytes per client with :func:`leaf_upload_bytes`, so reported
communication matches the configured wire format, not the dense tree.

Wire format (per leaf, ``n`` unmasked values of ``itemsize`` bytes):

- ``none``  — raw values: ``n · itemsize``
- ``int8``  — 1 byte/value + one f32 scale per :data:`QUANT_GROUP` values
- ``int4``  — packed 2 values/byte + one f32 scale per group
- ``topk``  — ``k = max(1, ceil(topk_ratio · n))`` kept values (at the
  ``topk_values`` width), ``k`` f32 offsets (:data:`INDEX_BYTES` each) and
  one per-leaf f32 scale (when the values are quantized)
"""
from __future__ import annotations

import dataclasses
import math

QUANT_GROUP = 128  # values per scale group == the compress kernel's lane row
SCALE_BYTES = 4  # f32 scales
INDEX_BYTES = 4  # int32 flat offsets for top-k

_QMAX = {"int8": 127, "int4": 7, "float": 0}


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Upload-path compression knobs. The default is an exact no-op.

    mode: ``none`` (raw), ``int8``/``int4`` (group-wise fake-quantization of
        every unmasked value), or ``topk`` (per-leaf magnitude top-k, values
        shipped at ``topk_values`` width).
    topk_ratio: fraction of each leaf's *unmasked* values kept by ``topk``.
    topk_values: wire width of the kept values — ``int8``, ``int4`` or
        ``float`` (the leaf's own dtype, indices/scale still charged).
    error_feedback: carry the un-sent remainder ``x - y`` into the client's
        next upload (per-client residual state owned by the orchestrator).
    """

    mode: str = "none"
    topk_ratio: float = 0.1
    topk_values: str = "int8"
    error_feedback: bool = True

    def __post_init__(self):
        if self.mode not in ("none", "int8", "int4", "topk"):
            raise ValueError(f"unknown compression mode: {self.mode!r}")
        if self.topk_values not in _QMAX:
            raise ValueError(f"unknown topk_values: {self.topk_values!r}")
        if not 0.0 < self.topk_ratio <= 1.0:
            raise ValueError("topk_ratio must be in (0, 1]")

    @property
    def enabled(self) -> bool:
        return self.mode != "none"

    @property
    def qmax(self) -> int:
        """Quantization ceiling for the fake-quantize kernel (0 = float)."""
        if self.mode == "none":
            return 0
        if self.mode == "topk":
            return _QMAX[self.topk_values]
        return _QMAX[self.mode]

    @property
    def use_thresh(self) -> bool:
        return self.mode == "topk"


def topk_k(n_values: int, ratio: float) -> int:
    """Kept-value count for a leaf with ``n_values`` unmasked entries."""
    return max(1, math.ceil(ratio * n_values)) if n_values else 0


def _value_bytes(n: int, width: str, itemsize: int) -> int:
    if width == "int8":
        return n
    if width == "int4":
        return (n + 1) // 2
    return n * itemsize  # float: leaf dtype


def leaf_upload_breakdown(
    n_values: int, itemsize: int, cfg: "CompressionConfig | None"
) -> dict:
    """Wire-format composition of one leaf's upload payload, in bytes.

    Returns ``{"values": ..., "scales": ..., "indices": ...}`` — the metrics
    layer records the components so a trace shows *where* compressed wire
    bytes go (a top-k payload at small ratios is mostly int32 indices, which
    is why the ratio floor is ~6.4x, not 1/ratio).
    """
    if n_values <= 0:
        return {"values": 0, "scales": 0, "indices": 0}
    if cfg is None or not cfg.enabled:
        return {"values": n_values * itemsize, "scales": 0, "indices": 0}
    if cfg.mode == "topk":
        k = topk_k(n_values, cfg.topk_ratio)
        return {
            "values": _value_bytes(k, cfg.topk_values, itemsize),
            "scales": SCALE_BYTES if cfg.qmax else 0,
            "indices": k * INDEX_BYTES,
        }
    groups = -(-n_values // QUANT_GROUP)
    return {
        "values": _value_bytes(n_values, cfg.mode, itemsize),
        "scales": groups * SCALE_BYTES,
        "indices": 0,
    }


def leaf_upload_bytes(
    n_values: int, itemsize: int, cfg: "CompressionConfig | None"
) -> int:
    """Wire bytes for one leaf's upload payload (values + scales + indices)."""
    return sum(leaf_upload_breakdown(n_values, itemsize, cfg).values())
