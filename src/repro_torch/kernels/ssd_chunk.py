"""Launcher of the hand-written CUDA Mamba2 SSD intra-chunk kernel (B9).

Ports the TPU kernel ``repro/kernels/ssd_chunk.py::ssd_chunk_intra_kernel``;
the CUDA source, with its bound and design, is ``csrc/ssd_chunk.cu``: a
persistent grid whose consumer warpgroups each take a row (a batch and
chunk) and a block of the heads that share its b and c, compute c·bᵀ once
for them on Hopper's ``wgmma`` and then each head's M·x, fed by TMA loads
(or, for tensors TMA cannot take, by copies into the same layout). The
kernel reads x, the decays, b and c at the strides it is given, so the
JAX contract's (G, Q, hd) groups and the model's (B, S, nh, hd) sequence
both launch without a copy. The launcher checks the tensors, allocates
nothing, launches on PyTorch's current stream and raises if the launch is
refused. The library is built and loaded at the first launch
(``kernels/build.py``), never at import.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import CSRC, load_library

SOURCE = CSRC / "ssd_chunk.cu"
MAX_Q = 128  # the kernel's largest chunk (csrc/ssd_chunk.cu, kQ), a multiple of 8
MAX_HEAD_DIM = 128  # kMaxHd, a multiple of 4
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    lib.repro_ssd_chunk.argtypes = [_P] * 5 + [_I] * 7 + [_P, _P]
    lib.repro_ssd_chunk.restype = _I
    lib.repro_ssd_chunk_layout.argtypes = [_I, _I, _I, _P]
    lib.repro_ssd_chunk_layout.restype = _I
    lib.repro_ssd_chunk_copy_launches.argtypes = []
    lib.repro_ssd_chunk_copy_launches.restype = ctypes.c_ulonglong
    return lib


def copy_route_launches() -> int:
    """The launches in this process so far that took the copy route (a
    base off 16 bytes or a stride not a multiple of 16 bytes); the others
    took TMA."""
    return int(library().repro_ssd_chunk_copy_launches())


LAYOUT_KEYS = ("rows", "state_columns", "bc_stages", "x_stages", "head_block", "units", "blocks", "threads",
               "smem_bytes", "registers", "local_bytes")


def layout(dtype: torch.dtype, rows: int = 1, heads: int = 1) -> dict:
    """The launch layout of ``dtype`` inputs at ``rows`` (batch x chunk)
    rows of ``heads`` heads sharing b and c: chunk rows a tile, columns of
    b and c a ring stage, b/c and x ring stages a consumer, the heads a work
    unit, the units, blocks (at most one an SM), threads a block, dynamic
    shared memory (bytes), and the compiled kernel's registers a thread at
    launch and local (spilled) bytes, as the runtime reports them (the
    consumers raise their registers to 232 with ``setmaxnreg``)."""
    vals = (ctypes.c_int * len(LAYOUT_KEYS))()
    err = library().repro_ssd_chunk_layout(DTYPE_CODES[dtype], rows, heads, ctypes.cast(vals, _P))
    if err:
        raise RuntimeError(f"ssd-chunk layout query failed with CUDA error {err}")
    return dict(zip(LAYOUT_KEYS, vals))


def check_shape(G: int, Q: int, hd: int, N: int) -> None:
    """Raise on a shape the kernel does not take."""
    if Q < 8 or Q > MAX_Q or Q % 8:
        raise ValueError(f"chunk {Q} is not a multiple of 8 in 8..{MAX_Q}")
    if hd < 4 or hd > MAX_HEAD_DIM or hd % 4:
        raise ValueError(f"head_dim {hd} is not a multiple of 4 in 4..{MAX_HEAD_DIM}")
    if N < 1 or G < 1 or G >= 2**31:
        raise ValueError(f"no kernel for {G} groups of state size {N}")


def _span(t: torch.Tensor):
    """The bytes ``t``'s elements lie in: [first, last + 1)."""
    last = sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
    return t.data_ptr(), t.data_ptr() + (last + 1) * t.element_size()


def ssd_chunk_launch_views(y, x, a, b, c) -> None:
    """``y[r,h,i] = Σ_{j≤i} exp(cs_i - cs_j)·(c[r,i]·b[r,j])·x[r,h,j]``,
    ``cs = cumsum(a[r,h])``, on views at any non-negative strides: ``x``
    (R, heads, Q, hd) f32 or bf16, ``b``/``c`` (R, Q, N) of x's dtype, ``a``
    (R, heads, Q) f32 or bf16, ``y`` (R, heads, Q, hd) f32 with even
    strides, overlapping none of them; the last dimension of x, y, b and c
    contiguous; all on one CUDA device. Where a base lies off 16 bytes or a
    stride is not a multiple of 16 bytes, the kernel copies that launch's
    tiles itself in place of TMA (the same bits; counted in
    :func:`copy_route_launches`)."""
    if not x.is_cuda or x.dim() != 4 or x.dtype not in DTYPE_CODES:
        raise ValueError("x must be a (R, heads, Q, hd) float32/bfloat16 CUDA tensor")
    R, heads, Q, hd = x.shape
    N = b.shape[-1]
    check_shape(R * heads, Q, hd, N)
    for name, t, shape, dtypes in (("x", x, (R, heads, Q, hd), (x.dtype,)), ("b", b, (R, Q, N), (x.dtype,)),
                                   ("c", c, (R, Q, N), (x.dtype,)), ("a", a, (R, heads, Q), tuple(DTYPE_CODES)),
                                   ("y", y, (R, heads, Q, hd), (torch.float32,))):
        if t.device != x.device or tuple(t.shape) != shape or min(t.stride()) < 0:
            raise ValueError(f"{name} must be a {shape} tensor on {x.device} with non-negative strides")
        if t.dtype not in dtypes:
            raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
        if name != "a" and t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    y0, y1 = _span(y)
    for t in (x, a, b, c):
        t0, t1 = _span(t)
        if t0 < y1 and y0 < t1:
            raise ValueError("y must not overlap an input")
    strides = (ctypes.c_longlong * 13)(*x.stride()[:3], *y.stride()[:3], *a.stride(), *b.stride()[:2],
                                       *c.stride()[:2])
    err = library().repro_ssd_chunk(
        y.data_ptr(), x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), R, heads, Q, hd, N,
        DTYPE_CODES[x.dtype], DTYPE_CODES[a.dtype], ctypes.cast(strides, _P),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ssd-chunk launch failed with CUDA error {err}")


def ssd_chunk_launch(y, x, a, b, c, heads: int = 1) -> None:
    """The JAX kernel's layout: ``x`` (G, Q, hd), ``b``/``c`` (G / heads,
    Q, N), row ``g // heads`` for group g, of x's dtype, f32 or bf16; ``a``
    (G, 1, Q) f32 or bf16; ``y`` (G, Q, hd) f32, aliasing none of them; all
    contiguous on one CUDA device."""
    if not x.is_cuda or x.dim() != 3 or x.dtype not in DTYPE_CODES:
        raise ValueError("x must be a (G, Q, hd) float32/bfloat16 CUDA tensor")
    G, Q, hd = x.shape
    check_shape(G, Q, hd, b.shape[-1])
    if heads < 1 or G % heads:
        raise ValueError(f"{G} groups are not a whole number of {heads} heads")
    for name, t, shape in (("x", x, (G, Q, hd)), ("b", b, (G // heads, Q, b.shape[-1])),
                           ("c", c, (G // heads, Q, b.shape[-1])), ("a", a, (G, 1, Q)), ("y", y, (G, Q, hd))):
        if not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a contiguous {shape} tensor")
    R = G // heads
    ssd_chunk_launch_views(y.view(R, heads, Q, hd), x.view(R, heads, Q, hd), a.view(R, heads, Q), b, c)
