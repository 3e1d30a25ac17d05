"""Launcher of the hand-written CUDA Mamba2 SSD intra-chunk kernel (B9).

Ports the TPU kernel ``repro/kernels/ssd_chunk.py::ssd_chunk_intra_kernel``;
the CUDA source, with its bound and design, is ``csrc/ssd_chunk.cu``. The
launcher checks the tensors, allocates nothing, launches on PyTorch's
current stream and raises if the launch is refused. The library is built and
loaded at the first launch (``kernels/build.py``), never at import.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import CSRC, load_library

SOURCE = CSRC / "ssd_chunk.cu"
MAX_Q = 128  # the kernel's largest chunk (csrc/ssd_chunk.cu, kMaxQ), a multiple of 8
MAX_HEAD_DIM = 128  # kMaxHd, a multiple of 4
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    lib.repro_ssd_chunk.argtypes = [_P] * 5 + [_I64, _I, _I, _I, _I, _I, _I, _P]
    lib.repro_ssd_chunk.restype = _I
    return lib


def check_shape(G: int, Q: int, hd: int, N: int) -> None:
    """Raise on a shape the kernel does not take."""
    if Q < 8 or Q > MAX_Q or Q % 8:
        raise ValueError(f"chunk {Q} is not a multiple of 8 in 8..{MAX_Q}")
    if hd < 4 or hd > MAX_HEAD_DIM or hd % 4:
        raise ValueError(f"head_dim {hd} is not a multiple of 4 in 4..{MAX_HEAD_DIM}")
    if N < 1 or G < 1 or G >= 2**31:
        raise ValueError(f"no kernel for {G} groups of state size {N}")


def ssd_chunk_launch(y, x, a, b, c, heads: int = 1) -> None:
    """``y[g,i] = Σ_{j≤i} exp(cs_i - cs_j)·(c_i·b_j)·x[g,j]``, ``cs =
    cumsum(a[g,0])``: ``x`` (G, Q, hd), ``b``/``c`` (G / heads, Q, N), row
    ``g // heads`` for group g, of x's dtype, f32 or bf16; ``a`` (G, 1, Q)
    f32 or bf16; ``y`` (G, Q, hd) f32, aliasing none of them; all contiguous
    on one CUDA device."""
    if not x.is_cuda or x.dim() != 3 or x.dtype not in DTYPE_CODES:
        raise ValueError("x must be a (G, Q, hd) float32/bfloat16 CUDA tensor")
    G, Q, hd = x.shape
    N = b.shape[-1]
    check_shape(G, Q, hd, N)
    if heads < 1 or G % heads:
        raise ValueError(f"{G} groups are not a whole number of {heads} heads")
    for name, t, shape, dtypes in (("x", x, (G, Q, hd), (x.dtype,)), ("b", b, (G // heads, Q, N), (x.dtype,)),
                                   ("c", c, (G // heads, Q, N), (x.dtype,)),
                                   ("a", a, (G, 1, Q), tuple(DTYPE_CODES)), ("y", y, (G, Q, hd), (torch.float32,))):
        if t.device != x.device or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a contiguous {shape} tensor on {x.device}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if y.data_ptr() in (x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr()):
        raise ValueError("y must not alias an input")
    err = library().repro_ssd_chunk(
        y.data_ptr(), x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), G, Q, hd, N, heads,
        DTYPE_CODES[x.dtype], DTYPE_CODES[a.dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ssd-chunk launch failed with CUDA error {err}")
