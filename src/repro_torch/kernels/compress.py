"""Launcher of the hand-written CUDA fake-compress kernel (B3).

Ports the TPU kernel ``repro/kernels/compress.py::fake_compress_2d``; the
CUDA source, with its bound and design, is ``csrc/compress.cu``. The
launcher compresses one leaf, possibly stacking k clients: it checks the
tensors, allocates nothing, launches on PyTorch's current stream and raises
if the launch is refused. The library is built and loaded at the first
launch (``kernels/build.py``), never at import.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import CSRC, load_library

SOURCE = CSRC / "compress.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    lib.repro_fake_compress.argtypes = [_P] * 4 + [_I64, _I64, _I, _I, _I, _I, _P]
    lib.repro_fake_compress.restype = _I
    return lib


def fake_compress_launch(y, r, x, scal, *, qmax: int, use_thresh: bool, per_leaf_scale: bool) -> None:
    """One round trip over ``x`` (k, m): k clients' flattened leaves, f32 or
    bf16, contiguous. ``y`` and ``r`` are outputs of ``x``'s shape and dtype
    that do not alias it; ``scal`` is a contiguous f32 (k, 2) device table of
    rows ``[thresh, scale]``, read by the top-k / per-leaf-scale variants."""
    if x.dim() != 2 or x.dtype not in _DTYPE_CODES or not x.is_cuda or not x.is_contiguous():
        raise ValueError("x must be a contiguous (k, m) float32/bfloat16 CUDA tensor")
    for name, t in (("y", y), ("r", r)):
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor like x")
        if t.data_ptr() == x.data_ptr():
            raise ValueError(f"{name} must not alias x")
    if (scal.dtype != torch.float32 or scal.shape != (x.shape[0], 2)
            or scal.device != x.device or not scal.is_contiguous()):
        raise ValueError("scal must be a contiguous float32 (k, 2) table on x's device")
    k, m = x.shape
    err = library().repro_fake_compress(
        y.data_ptr(), r.data_ptr(), x.data_ptr(), scal.data_ptr(), k, m,
        _DTYPE_CODES[x.dtype], int(qmax), int(use_thresh), int(per_leaf_scale),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fake-compress launch failed with CUDA error {err}")
