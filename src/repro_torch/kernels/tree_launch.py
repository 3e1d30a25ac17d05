"""What the multi-tensor kernels share: the launch planner, the packed
output layout and the cheap check of a leaf's tensors.

The tree kernels (B1 masked AdamW, B2 masked SGD, B3 fake compression) take
up to ``MAX_LEAVES`` leaves in one launch, from a table of the leaves'
pointers that rides in the kernel's parameters. :func:`plan` splits a tree
into launches and gives each leaf its first block; the kernel maps a block
back to (leaf, client row, chunk). :func:`layout` and :func:`views` put a
tree's outputs in one buffer per dtype. All of it is plain Python, so the
CPU tests check it; only the kernels run on the card.
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

MAX_LEAVES = 32  # leaves in one launch's table (kMaxLeaves in the sources)
OUT_ALIGN = 8  # output leaves start on multiples of 8 elements: 16-byte vectors
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
F32_ONLY = {torch.float32: 0}


class Launch(NamedTuple):
    """One launch of a tree kernel: the leaves it takes (indices into the
    tree's leaf list), each one's first block, and the grid in blocks."""
    leaves: Tuple[int, ...]
    block0: Tuple[int, ...]
    grid: int


@functools.lru_cache(maxsize=256)
def plan(sizes: Tuple[int, ...], clients: int = 1, chunk: Optional[int] = 4096,
         capacity: int = MAX_LEAVES) -> Tuple[Launch, ...]:
    """Split a tree's leaves (their element counts, in leaf order) into
    launches of at most ``capacity`` leaves; empty leaves take no block and
    no table entry. Every leaf stacks ``clients`` rows of ``n // clients``
    elements, and its blocks cover row after row in chunks of ``chunk``
    elements, a row's last chunk short: no block straddles two clients, so a
    block reads its client's scalars once (``chunk`` None: one block per
    row). Leaf l of a launch owns its blocks from ``block0[l]`` on. Cached:
    a tree's sizes are the same every step."""
    live = [i for i, n in enumerate(sizes) if n > 0]
    plans = []
    for s in range(0, len(live), capacity):
        leaves = tuple(live[s:s + capacity])
        block0, b = [], 0
        for i in leaves:
            block0.append(b)
            b += clients if chunk is None else clients * -(-(sizes[i] // clients) // chunk)
        plans.append(Launch(leaves, tuple(block0), b))
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


def code_of(name: str, t, n: int, device_index: int, dtypes=DTYPE_CODES) -> int:
    """The kernel's dtype code of ``t``, after the cheap check that it is a
    contiguous tensor of one of ``dtypes`` with ``n`` elements on CUDA
    device ``device_index``; raises saying why it is not."""
    code = dtypes.get(getattr(t, "dtype", None))
    if code is not None and t.numel() == n and t.is_contiguous() and t.get_device() == device_index:
        return code
    if t is None:
        raise ValueError(f"{name} is missing")
    if code is None:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {sorted(map(str, dtypes))}")
    if t.get_device() != device_index:
        raise ValueError(f"{name} must lie on cuda:{device_index}, got {t.device}")
    raise ValueError(f"{name} must be contiguous with {n} elements")


def check_stacked(clients: int, device_index: int, leaves) -> None:
    """With more than one client the leaves stack the clients on their
    leading axis, and they lie on a CUDA device."""
    if clients < 1:
        raise ValueError(f"clients must be at least 1, got {clients}")
    if clients > 1:
        for t in leaves:
            if t.dim() == 0 or t.shape[0] != clients:
                raise ValueError(f"a {tuple(t.shape)} leaf does not stack {clients} clients")
    if device_index < 0:
        raise ValueError(f"the leaves must lie on a CUDA device, got {leaves[0].device}")


def raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {err}")
