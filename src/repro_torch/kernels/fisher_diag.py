"""Launcher of the hand-written CUDA momentum diag-FIM kernel (B4).

Ports the TPU kernel ``repro/kernels/fisher_diag.py::fisher_diag_update_2d``;
the CUDA source, with its bound and design, is ``csrc/fisher_diag.cu``. The
launcher updates one leaf: it checks the tensors, allocates nothing,
launches on PyTorch's current stream and raises if the launch is refused.
The library is built and loaded at the first launch (``kernels/build.py``),
never at import.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import CSRC, load_library

SOURCE = CSRC / "fisher_diag.cu"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I64, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    lib.repro_fisher_diag.argtypes = [_P] * 3 + [_I64, _I, _I, _F, _F, _P]
    lib.repro_fisher_diag.restype = _I
    return lib


def fisher_diag_launch(out, g, fim, momentum: float) -> None:
    """``out = γ·fim + ((1-γ)·g)·g`` over one leaf: ``g`` and ``fim``
    contiguous f32 or bf16 CUDA tensors of one element count, ``out`` a
    contiguous f32 tensor of that count on their device, aliasing neither."""
    if not g.is_cuda:
        raise ValueError(f"g must be a CUDA tensor, got {g.device}")
    for name, t in (("g", g), ("fim", fim), ("out", out)):
        if t.device != g.device or not t.is_contiguous() or t.numel() != g.numel():
            raise ValueError(f"{name} must be a contiguous tensor of {g.numel()} elements on {g.device}")
        if t.dtype not in DTYPE_CODES or (name == "out" and t.dtype != torch.float32):
            raise TypeError(f"{name} has unsupported dtype {t.dtype}")
    if out.data_ptr() in (g.data_ptr(), fim.data_ptr()):
        raise ValueError("out must not alias g or fim")
    if g.numel() == 0:
        raise ValueError("an empty leaf has nothing to launch")
    err = library().repro_fisher_diag(
        out.data_ptr(), g.data_ptr(), fim.data_ptr(), g.numel(), DTYPE_CODES[g.dtype],
        DTYPE_CODES[fim.dtype], momentum, 1.0 - momentum,
        torch.cuda.current_stream(g.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fisher-diag launch failed with CUDA error {err}")
