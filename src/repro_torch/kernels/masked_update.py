"""Launchers of the hand-written CUDA masked AdamW / SGD kernels.

Ports the TPU kernels ``repro/kernels/masked_update.py::masked_adamw_update_2d``
and ``::masked_sgd_update_2d``; the CUDA source, with its bound and design,
is ``csrc/masked_update.cu``. Each launcher updates one leaf: it checks the
tensors, allocates nothing, launches on PyTorch's current stream and raises
if the launch is refused. The library is built and loaded at the first
launch (``kernels/build.py``), never at import.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import CSRC, load_library

SOURCE = CSRC / "masked_update.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I64, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    lib.repro_masked_adamw.argtypes = [_P] * 9 + [_I64, _I64, _I] + [_F] * 6 + [_P]
    lib.repro_masked_adamw.restype = _I
    lib.repro_masked_sgd.argtypes = [_P] * 7 + [_I64, _I64, _I, _F, _P]
    lib.repro_masked_sgd.restype = _I
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(like: torch.Tensor, scal: torch.Tensor, **tensors) -> int:
    """Every tensor on ``like``'s device, contiguous, with its element count;
    p f32 or bf16 with g and p_out of its dtype, everything else f32; the
    scalar table a contiguous f32 (k, 4) on the same device, with ``like``
    stacking k clients on its leading axis (k = 1: any shape). Returns k."""
    if (scal.dtype != torch.float32 or scal.dim() != 2 or scal.shape[1] != 4
            or scal.device != like.device or not scal.is_contiguous()):
        raise ValueError("scal must be a contiguous float32 (k, 4) table on p's device")
    k = scal.shape[0]
    if k < 1 or (k > 1 and (like.dim() == 0 or like.shape[0] != k)):
        raise ValueError(f"a {tuple(like.shape)} leaf does not stack {k} clients")
    for name, t in tensors.items():
        if t is None:
            continue
        if not t.is_cuda or t.device != like.device:
            raise ValueError(f"{name} must lie on {like.device}, got {t.device}")
        if t.numel() != like.numel():
            raise ValueError(f"{name} has {t.numel()} elements, expected {like.numel()}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        wanted = _DTYPE_CODES if name in ("p", "p_out", "g") else (torch.float32,)
        if t.dtype not in wanted or (name in ("p_out", "g") and t.dtype != like.dtype):
            raise TypeError(f"{name} has unsupported dtype {t.dtype}")
    return k


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {err}")


def adamw_launch(p_out, p, g, m_out, m, v_out, v, mask, scal, *, b1: float, b2: float,
                 eps: float, wd: float) -> None:
    """One masked AdamW pass over a leaf: p, g f32 or bf16; m, v, mask f32
    (mask may be None). ``scal``: f32 (k, 4) device table, one row
    ``[lr, active, mhat_scale, vhat_scale]`` per client stacked on the
    leaf's leading axis (k = 1: an unstacked leaf)."""
    k = _check(p, scal, p_out=p_out, p=p, g=g, m_out=m_out, m=m, v_out=v_out, v=v, mask=mask)
    err = library().repro_masked_adamw(
        _ptr(p_out), _ptr(p), _ptr(g), _ptr(m_out), _ptr(m), _ptr(v_out), _ptr(v),
        _ptr(mask), _ptr(scal), p.numel(), k, _DTYPE_CODES[p.dtype],
        b1, 1.0 - b1, b2, 1.0 - b2, eps, wd, torch.cuda.current_stream(p.device).cuda_stream,
    )
    _raise_on(err, "masked AdamW")


def sgd_launch(p_out, p, g, mu_out, mu, mask, scal, *, momentum: float) -> None:
    """One masked SGD(+momentum) pass over a leaf; ``mu``/``mu_out`` are
    None without momentum. ``scal``: f32 (k, 4) device table, one row
    ``[lr, active, -, -]`` per client stacked on the leaf's leading axis."""
    k = _check(p, scal, p_out=p_out, p=p, g=g, mu_out=mu_out, mu=mu, mask=mask)
    if (mu is None) != (mu_out is None) or (mu is None) == bool(momentum):
        raise ValueError("mu and mu_out are given exactly when momentum is non-zero")
    err = library().repro_masked_sgd(
        _ptr(p_out), _ptr(p), _ptr(g), _ptr(mu_out), _ptr(mu), _ptr(mask), _ptr(scal),
        p.numel(), k, _DTYPE_CODES[p.dtype], momentum,
        torch.cuda.current_stream(p.device).cuda_stream,
    )
    _raise_on(err, "masked SGD")
