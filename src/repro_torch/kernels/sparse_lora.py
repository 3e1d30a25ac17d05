"""Launcher of the hand-written CUDA neuron-masked LoRA kernels (B5-B7).

Ports the TPU kernels ``repro/kernels/sparse_lora.py::sparse_lora_matmul``,
``::sparse_lora_matmul_packed`` and ``::batched_sparse_lora_matmul``: one
CUDA source, ``csrc/sparse_lora.cu``, with its bound and design. The
masked product, the packed one (the kept columns of b, 0 in the frozen
ones, all of y written by the kernel) and the multi-adapter one (a row
index into stacked adapters) are one launch with other arguments. A launch
takes the kernel that keeps a and b ⊙ mask in shared memory where they fit
(:func:`resident_stages`; for the multi-adapter product an SGMV kernel that
plans on the device which rows go with which adapter), and the kernel that
reads them from L2 otherwise. A multi-adapter product that the SGMV
kernel does not take (fewer than 16 rows an adapter, or a and b too wide
to stage) takes one of two paths of two launches chained with
programmatic dependent launch instead: at most ``FEW_MAX_ROWS`` rows (a
decode step) the few-row path, x @ a split over K and the second product
split over N; more rows (a prefill) the split path, x @ a over row tiles
and K-slices and the second product over row and column tiles
(:func:`batched_path` says which path a launch takes). The launcher checks
the tensors, allocates nothing but those paths' small f32 scratch (through
PyTorch's caching allocator), launches on PyTorch's current stream and
raises if a launch is refused.
The library is built and loaded at the first launch (``kernels/build.py``),
never at import.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import CSRC, load_library

SOURCE = CSRC / "sparse_lora.cu"
MAX_RANK = 64  # the kernel's largest rank (csrc/sparse_lora.cu, kMaxRank)
FEW_MAX_ROWS = 64  # the few-row path's largest M (csrc/sparse_lora.cu, kFewMaxRows)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I64, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    lib.repro_sparse_lora.argtypes = [_P] * 8 + [_I64, _I64, _I64, _I, _I, _I, _I, _F, _P]
    lib.repro_sparse_lora.restype = _I
    lib.repro_sparse_lora_stages.argtypes = [_I64, _I64, _I64, _I, _I, _I]
    lib.repro_sparse_lora_stages.restype = _I
    lib.repro_sparse_lora_path.argtypes = [_I64, _I64, _I64, _I, _I, _I, ctypes.POINTER(_I64)]
    lib.repro_sparse_lora_path.restype = _I
    return lib


_PATHS = ("bgmv", "sgmv", "few_rows", "split")  # repro_sparse_lora_path's codes


@functools.lru_cache(maxsize=None)
def _route(M: int, K: int, N: int, r: int, dtype_code: int, adapters: int, device: int) -> tuple[str, int]:
    """The kernel a multi-adapter launch takes on CUDA device ``device``
    (the current one) and the f32 values of its scratch (0 but on the
    few-row and split paths), asked once a shape."""
    scratch = _I64(0)
    code = library().repro_sparse_lora_path(M, K, N, r, adapters, dtype_code, ctypes.byref(scratch))
    if code < 0:
        raise ValueError(f"no kernel for K {K}, N {N}, rank {r}, {adapters} adapters, {M} rows")
    return _PATHS[code], scratch.value


def batched_path(M: int, K: int, N: int, r: int, dtype: torch.dtype, adapters: int) -> str:
    """Which kernel a multi-adapter launch of these widths takes on the
    current CUDA device: ``"sgmv"`` (the resident kernel, where
    :func:`resident_stages` > 0), else ``"few_rows"`` (at most
    ``FEW_MAX_ROWS`` rows) or ``"split"`` (more rows). The L2 kernel
    (``"bgmv"``) takes only a launch of those two paths' widths made
    without their scratch, which the C entry allows and this launcher
    never makes."""
    return _route(M, K, N, r, _DTYPE_CODES[dtype], adapters, torch.cuda.current_device())[0]


def resident_stages(K: int, N: int, r: int, dtype: torch.dtype, adapters: int = 0, rows: int = 0) -> int:
    """The x-tile ring depth (1-4 tiles over its teams) of the kernel that
    keeps a and b ⊙ mask in shared memory, for these widths on the current
    CUDA device, or 0 where a launch takes the kernel that reads them from
    L2. ``adapters`` 0: the single-adapter products (rank above 16, or K and
    N too wide, take L2). Otherwise the multi-adapter product over ``rows``
    rows, whose SGMV path also needs at most 1024 adapters and at least 16
    rows per adapter (a multi-adapter launch that this leaves out takes
    the few-row or the split path: :func:`batched_path`)."""
    stages = library().repro_sparse_lora_stages(rows, K, N, r, adapters, _DTYPE_CODES[dtype])
    if stages < 0:
        raise ValueError(f"no kernel for K {K}, N {N}, rank {r}, {adapters} adapters, {rows} rows")
    return stages


def sgmv_plan(idx: torch.Tensor, n_adapters: int) -> torch.Tensor:
    """The plain twin of the SGMV kernel's plan: the rows sorted by segment
    (an adapter index in [0, A), then every index outside it as segment A),
    stably, then each segment's first row in that order and the end, as one
    (M + A + 2,) int32 tensor. It makes no host sync."""
    idx = idx.reshape(-1).to(torch.int64)
    seg = torch.where((idx >= 0) & (idx < n_adapters), idx, n_adapters)
    order = torch.sort(seg, stable=True).indices
    counts = torch.bincount(seg, minlength=n_adapters + 1)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return torch.cat([order, offsets]).to(torch.int32)


def _check(name, t, device, shape, dtype) -> None:
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous tensor on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")


def sparse_lora_launch(y, x, a, b, mask, idx=None, *, scale: float = 1.0, packed: bool = False,
                       plan=None) -> str:
    """``y = scale·(x@a)@(b⊙mask)`` row by row, each row with its adapter.

    ``x`` (M, K) f32 or bf16 and ``y`` (M, N) of its dtype, not aliasing it.
    Without ``idx``: ``a`` (K, r), ``b`` (r, N), ``mask`` (N,); ``packed``
    gives b's kept columns (mask != 0) as they are and an exact 0 in every
    frozen column, whose b is never read. With ``idx`` (M,) int32: ``a``
    (A, K, r), ``b`` (A, r, N), ``mask`` (A, N), and a row whose index lies
    outside [0, A) comes out as zeros; ``plan``, an (M + A + 2,) int32
    tensor, receives the SGMV kernel's plan (:func:`sgmv_plan`), and a launch
    on the few-row or split path refuses it. a, b and mask are f32;
    r is at most ``MAX_RANK``; everything is contiguous on x's device.
    Returns the multi-adapter launch's path (:func:`batched_path`), "" for
    a single adapter.
    """
    if not x.is_cuda or x.dim() != 2 or x.dtype not in _DTYPE_CODES:
        raise ValueError("x must be a (M, K) float32/bfloat16 CUDA tensor")
    M, K = x.shape
    batched = idx is not None
    if packed and batched:
        raise ValueError("the packed product has a single adapter")
    lead = (a.shape[0],) if batched and a.dim() == 3 else ()
    if a.dim() != 2 + batched or b.dim() != 2 + batched:
        raise ValueError(f"a and b must be {'(A, K, r) and (A, r, N)' if batched else '(K, r) and (r, N)'}")
    r, N = b.shape[-2], b.shape[-1]
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"rank {r} is outside the kernel's 1..{MAX_RANK}")
    _check("x", x, x.device, (M, K), x.dtype)
    _check("y", y, x.device, (M, N), x.dtype)
    _check("a", a, x.device, lead + (K, r), torch.float32)
    _check("b", b, x.device, lead + (r, N), torch.float32)
    _check("mask", mask, x.device, lead + (N,), torch.float32)
    if batched:
        _check("idx", idx, x.device, (M,), torch.int32)
    if plan is not None:
        if not batched:
            raise ValueError("only the multi-adapter product makes a plan")
        _check("plan", plan, x.device, (M + lead[0] + 2,), torch.int32)
    if y.data_ptr() == x.data_ptr():
        raise ValueError("y must not alias x")
    if M == 0 or N == 0:
        raise ValueError("an empty output has nothing to launch")
    path, floats = _route(M, K, N, r, _DTYPE_CODES[x.dtype], lead[0], x.get_device()) if batched else ("", 0)
    if floats and plan is not None:
        raise ValueError(f"the {path} path ({M} rows) makes no plan")
    scratch = torch.empty(floats, dtype=torch.float32, device=x.device) if floats else None
    err = library().repro_sparse_lora(
        y.data_ptr(), x.data_ptr(), idx.data_ptr() if batched else None, a.data_ptr(), b.data_ptr(),
        mask.data_ptr(), plan.data_ptr() if plan is not None else None,
        scratch.data_ptr() if floats else None, M, K, N, r, lead[0] if batched else 1, _DTYPE_CODES[x.dtype],
        int(packed), scale, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"sparse-LoRA launch failed with CUDA error {err}")
    return path
