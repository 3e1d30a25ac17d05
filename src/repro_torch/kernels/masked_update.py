"""Launchers of the hand-written CUDA masked AdamW / SGD kernels.

Ports the TPU kernels ``repro/kernels/masked_update.py::masked_adamw_update_2d``
and ``::masked_sgd_update_2d``; the CUDA source, with its bound and design,
is ``csrc/masked_update.cu``. AdamW launches once per leaf; SGD once per
tree of up to ``SGD_MAX_LEAVES`` leaves, from a table of the leaves'
pointers and sizes that :func:`plan_sgd` splits into launches. Each launcher
checks the tensors, allocates nothing, launches on PyTorch's current stream
and raises if the launch is refused. The library is built and loaded at the
first launch (``kernels/build.py``), never at import.
"""
from __future__ import annotations

import array
import ctypes
import functools
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.build import CSRC, load_library

SOURCE = CSRC / "masked_update.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I64, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
SGD_CHUNK = 4096  # elements per block of the SGD tree kernel (kChunk in the source)
SGD_MAX_LEAVES = 32  # leaves in one launch's table (kMaxLeaves in the source)
OUT_ALIGN = 8  # output leaves start on multiples of 8 elements: 16-byte vectors


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    lib.repro_masked_adamw.argtypes = [_P] * 9 + [_I64, _I64, _I] + [_F] * 6 + [_P]
    lib.repro_masked_adamw.restype = _I
    lib.repro_masked_sgd_tree.argtypes = [_P, _I, _I64, _I64, _P, _F, _F, _F, _P]
    lib.repro_masked_sgd_tree.restype = _I
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _fits(t, dtype, n: int, device_index: int) -> bool:
    """``t`` is a contiguous tensor of ``dtype`` and ``n`` elements on CUDA
    device ``device_index`` (the cheap check of every leaf's tensors)."""
    return t is not None and t.dtype is dtype and t.numel() == n and t.is_contiguous() and \
        t.get_device() == device_index


def _require(named, n: int, device_index: int) -> None:
    """Raise for the first ``(name, tensor, dtype)`` that fails :func:`_fits`,
    saying why."""
    for name, t, dtype in named:
        if _fits(t, dtype, n, device_index):
            continue
        if t is None:
            raise ValueError(f"{name} is missing")
        if t.dtype is not dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if t.get_device() != device_index:
            raise ValueError(f"{name} must lie on cuda:{device_index}, got {t.device}")
        raise ValueError(f"{name} must be contiguous with {n} elements")


def _check_scal(scal, k: int, device_index: int, leaves) -> None:
    """``scal`` None or a contiguous f32 (k, 4) table on the leaves' CUDA
    device, every leaf stacking the k clients on its leading axis (k = 1:
    any shape)."""
    if scal is not None and (k < 1 or scal.dtype != torch.float32 or tuple(scal.shape) != (k, 4)
                             or not scal.is_contiguous()):
        raise ValueError(f"scal must be a contiguous float32 ({k}, 4) table")
    if k > 1:
        for t in leaves:
            if t.dim() == 0 or t.shape[0] != k:
                raise ValueError(f"a {tuple(t.shape)} leaf does not stack {k} clients")
    if device_index < 0 or (scal is not None and scal.get_device() != device_index):
        raise ValueError(f"p and scal must lie on one CUDA device, got {leaves[0].device}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {err}")


def adamw_launch(p_out, p, g, m_out, m, v_out, v, mask, scal, *, b1: float, b2: float,
                 eps: float, wd: float) -> None:
    """One masked AdamW pass over a leaf: p, g f32 or bf16; m, v, mask f32
    (mask may be None). ``scal``: f32 (k, 4) device table, one row
    ``[lr, active, mhat_scale, vhat_scale]`` per client stacked on the
    leaf's leading axis (k = 1: an unstacked leaf)."""
    k = scal.shape[0] if scal.dim() == 2 else 0
    di = p.get_device()
    _check_scal(scal, k, di, [p])
    if p.dtype not in _DTYPE_CODES:
        raise TypeError(f"p has unsupported dtype {p.dtype}")
    f32, n = torch.float32, p.numel()
    _require([("p", p, p.dtype), ("g", g, p.dtype), ("p_out", p_out, p.dtype), ("m", m, f32), ("m_out", m_out, f32),
              ("v", v, f32), ("v_out", v_out, f32)] + ([("mask", mask, f32)] if mask is not None else []), n, di)
    err = library().repro_masked_adamw(
        _ptr(p_out), _ptr(p), _ptr(g), _ptr(m_out), _ptr(m), _ptr(v_out), _ptr(v),
        _ptr(mask), _ptr(scal), p.numel(), k, _DTYPE_CODES[p.dtype],
        b1, 1.0 - b1, b2, 1.0 - b2, eps, wd, torch.cuda.current_stream(p.device).cuda_stream,
    )
    _raise_on(err, "masked AdamW")


# --- SGD over a tree: the plan, the outputs, the launch ---


class SgdLaunch(NamedTuple):
    """One launch of the SGD tree kernel: the leaves it takes (indices into
    the tree's leaf list), each one's first block, and the grid."""
    leaves: Tuple[int, ...]
    block0: Tuple[int, ...]
    grid: int


@functools.lru_cache(maxsize=256)
def plan_sgd(sizes: Tuple[int, ...], capacity: int = SGD_MAX_LEAVES, chunk: int = SGD_CHUNK) -> Tuple[SgdLaunch, ...]:
    """Split a tree's leaves (their element counts, in leaf order) into
    launches of at most ``capacity`` leaves; empty leaves take no block and
    no table entry. Leaf l of a launch owns the ``ceil(n_l / chunk)``
    blocks from ``block0[l]`` on (the kernel's block -> (leaf, chunk) map).
    Cached: a tree's sizes are the same every step."""
    live = [i for i, n in enumerate(sizes) if n > 0]
    plans = []
    for s in range(0, len(live), capacity):
        leaves = tuple(live[s:s + capacity])
        block0, b = [], 0
        for i in leaves:
            block0.append(b)
            b += -(-sizes[i] // chunk)
        plans.append(SgdLaunch(leaves, tuple(block0), b))
    return tuple(plans)


def output_offsets(sizes: Sequence[int], align: int = OUT_ALIGN) -> Tuple[List[int], int]:
    """Offsets of leaves packed into one buffer, each on a multiple of
    ``align`` elements, and the buffer's length."""
    offsets, end = [], 0
    for n in sizes:
        offsets.append(end)
        end += -(-n // align) * align
    return offsets, end


class Layout(NamedTuple):
    """Where a tree's outputs live: one buffer per dtype ``(dtype,
    elements)``, and per leaf ``(buffer, shape, contiguous stride, offset)``."""
    sizes: Tuple[int, ...]
    buffers: Tuple[Tuple[torch.dtype, int], ...]
    views: Tuple[Tuple[int, Tuple[int, ...], Tuple[int, ...], int], ...]


@functools.lru_cache(maxsize=256)
def layout(sig: Tuple[Tuple[Tuple[int, ...], torch.dtype], ...]) -> Layout:
    """The output layout of leaves with these ``(shape, dtype)`` pairs, each
    leaf starting on a 16-byte boundary of its dtype's buffer. Cached: a
    tree's signature is the same every step."""
    sizes = tuple(int(np.prod(shape, dtype=np.int64)) for shape, _ in sig)
    dtypes = list(dict.fromkeys(dt for _, dt in sig))
    views: List[tuple] = [None] * len(sig)  # type: ignore[list-item]
    buffers = []
    for b, dt in enumerate(dtypes):
        idx = [i for i, (_, d) in enumerate(sig) if d == dt]
        offsets, total = output_offsets([sizes[i] for i in idx])
        buffers.append((dt, total))
        for i, off in zip(idx, offsets):
            shape = tuple(sig[i][0])
            stride = tuple(int(np.prod(shape[j + 1:], dtype=np.int64)) for j in range(len(shape)))
            views[i] = (b, shape, stride, off)
    return Layout(sizes, tuple(buffers), tuple(views))


def views(lay: Layout, device) -> List[torch.Tensor]:
    """Uninitialised tensors of ``lay``'s leaves: views into one
    ``torch.empty`` per dtype."""
    bufs = [torch.empty(n, dtype=dt, device=device) for dt, n in lay.buffers]
    return [bufs[b].as_strided(shape, stride, off) for b, shape, stride, off in lay.views]


def sgd_tree_launch(launch: SgdLaunch, p_out, p, g, mu_out, mu, mask, *, clients: int, scal, lr: float,
                    active: float, momentum: float) -> None:
    """One masked SGD(+momentum) launch over the leaves ``launch`` names of
    the leaf lists ``p``, ``g``, ``mask`` (entries may be None) and ``mu``,
    writing ``p_out`` and ``mu_out`` (lists of None without momentum). p
    f32 or bf16 with g of its dtype; mu and mask f32; all contiguous on one
    CUDA device. The outputs are the caller's fresh :func:`views` of the
    leaves' :func:`layout`. ``scal`` None: ``lr`` and ``active`` travel by value;
    else a contiguous f32 (clients, 4) device table ``[lr, active, -, -]``
    per client, every leaf stacking the clients on its leading axis."""
    f32 = torch.float32
    if (mu[launch.leaves[0]] is None) == bool(momentum):
        raise ValueError("mu and mu_out are given exactly when momentum is non-zero")
    di = p[launch.leaves[0]].get_device()
    _check_scal(scal, clients, di, [p[i] for i in launch.leaves])
    words = array.array("q")
    for i, b0 in zip(launch.leaves, launch.block0):
        pi, gi, oi, mi = p[i], g[i], p_out[i], mask[i]
        n, dt = pi.numel(), pi.dtype
        code = _DTYPE_CODES.get(dt)
        if code is None:
            raise TypeError(f"p has dtype {dt}, expected float32 or bfloat16")
        # the cheap check, and on a failure the same check again to say why
        if not (_fits(pi, dt, n, di) and _fits(gi, dt, n, di) and _fits(oi, dt, n, di)
                and (mi is None or _fits(mi, f32, n, di))
                and (not momentum or (_fits(mu[i], f32, n, di) and _fits(mu_out[i], f32, n, di)))):
            _require([("p", pi, dt), ("g", gi, dt), ("p_out", oi, dt)]
                     + ([("mask", mi, f32)] if mi is not None else [])
                     + ([("mu", mu[i], f32), ("mu_out", mu_out[i], f32)] if momentum else []), n, di)
        words.extend((pi.data_ptr(), gi.data_ptr(), oi.data_ptr(), mu[i].data_ptr() if momentum else 0,
                      mu_out[i].data_ptr() if momentum else 0, 0 if mi is None else mi.data_ptr(),
                      n, n // clients, b0, code))
    err = library().repro_masked_sgd_tree(
        words.buffer_info()[0], len(launch.leaves), launch.grid, SGD_CHUNK,
        None if scal is None else scal.data_ptr(), lr, active, momentum,
        torch._C._cuda_getCurrentRawStream(di),  # PyTorch's current stream, as torch.cuda.current_stream gives it
    )
    _raise_on(err, "masked SGD")
