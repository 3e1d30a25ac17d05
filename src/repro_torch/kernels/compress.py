"""Launcher of the hand-written CUDA fake-compress kernel (B3).

Ports the TPU kernel ``repro/kernels/compress.py::fake_compress_2d`` and
the top-k threshold its wrapper sorts for; the CUDA source, with its bound
and design, is ``csrc/compress.cu``. One launch compresses a tree of up to
``MAX_LEAVES`` leaves, each possibly stacking k clients, from a table of
the leaves' pointers that :func:`repro_torch.kernels.tree_launch.plan`
splits into launches: without top-k in chunks of ``GROUP_CHUNK`` values,
with top-k one thread-block cluster per (leaf, client) row. The launcher
checks the tensors, allocates nothing, launches on PyTorch's current stream
and raises if the launch is refused. The library is built and loaded at the
first launch (``kernels/build.py``), never at import.
"""
from __future__ import annotations

import array
import ctypes
import functools

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import tree_launch as tl
from repro_torch.kernels.build import CSRC, load_library

SOURCE = CSRC / "compress.cu"
GROUP_CHUNK = 1024  # values per block without top-k: 8 groups of 128 (kGroupChunk in the source)
_P, _I64, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    lib.repro_fake_compress_tree.argtypes = [_P, _I, _I64, _I64, _I, _I, _F, _F, _P]
    lib.repro_fake_compress_tree.restype = _I
    return lib


def fake_compress_tree_launch(launch: tl.Launch, y, res, d, r, mask, *, clients: int, stacked: bool, qmax: int,
                              topk_ratio: float, use_thresh: bool) -> None:
    """One round trip over the leaves ``launch`` names of the leaf lists
    ``d``, ``r`` and ``mask`` (entries of ``r`` and ``mask`` may be None),
    writing ``y`` and ``res``. Each leaf holds ``clients`` rows (its leading
    axis when ``stacked``); d, r, y and res are contiguous, of one dtype (f32
    or bf16) and one element count; y and res alias neither input. With
    top-k a mask (contiguous f32) counts the values each row keeps: per
    client when ``stacked`` and it has as many dimensions as d, else shared
    by the rows. ``launch`` is planned for ``clients`` rows per leaf in
    chunks of ``GROUP_CHUNK`` (without top-k) or one block per row (with)."""
    tl.check_stacked(clients, d[launch.leaves[0]].get_device(), [d[i] for i in launch.leaves])
    words = table(launch, y, res, d, r, mask, clients=clients, stacked=stacked, use_thresh=use_thresh)
    err = library().repro_fake_compress_tree(
        words.buffer_info()[0], len(launch.leaves), launch.grid, 0 if use_thresh else GROUP_CHUNK,
        int(qmax), int(use_thresh), topk_ratio, ref.inv_qmax(qmax) if qmax else 0.0,
        torch._C._cuda_getCurrentRawStream(d[launch.leaves[0]].get_device()),  # PyTorch's current stream
    )
    tl.raise_on(err, "fake-compress")


def table(launch: tl.Launch, y, res, d, r, mask, *, clients: int, stacked: bool, use_thresh: bool) -> array.array:
    """The kernel's host table for the leaves ``launch`` names: per leaf
    ``[d, r, mask, y, res, n, per_client, mask_n, mask_stride, block0,
    dtype]``, after checking every tensor (see
    :func:`fake_compress_tree_launch`)."""
    di = d[launch.leaves[0]].get_device()
    words = array.array("q")
    for i, b0 in zip(launch.leaves, launch.block0):
        dl, n = d[i], d[i].numel()
        code = tl.code_of("delta", dl, n, di)
        for name, t in (("residual", r[i]), ("y", y[i]), ("res", res[i])):
            if t is not None and tl.code_of(name, t, n, di) != code:
                raise TypeError(f"{name} has dtype {t.dtype}, expected {dl.dtype}")
        for name, t in (("y", y[i]), ("res", res[i])):
            if t.data_ptr() in (dl.data_ptr(), 0 if r[i] is None else r[i].data_ptr()):
                raise ValueError(f"{name} must not alias the delta or the residual")
        mk, mask_n, stride = mask[i] if use_thresh else None, 0, 0
        if mk is not None:
            tl.code_of("mask", mk, mk.numel(), di, tl.F32_ONLY)
            per_client = stacked and mk.dim() == dl.dim()
            if mk.numel() == 0 or (per_client and mk.numel() % clients):
                raise ValueError(f"a {tuple(mk.shape)} mask does not cover {clients} client rows")
            mask_n = mk.numel() // clients if per_client else mk.numel()
            stride = mask_n if per_client else 0
        words.extend((dl.data_ptr(), 0 if r[i] is None else r[i].data_ptr(), 0 if mk is None else mk.data_ptr(),
                      y[i].data_ptr(), res[i].data_ptr(), n, n // clients, mask_n, stride, b0, code))
    return words
