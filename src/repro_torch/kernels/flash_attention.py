"""Launcher of the hand-written CUDA flash-attention kernels (B8).

Ports the TPU kernel ``repro/kernels/flash_attention.py::flash_attention_bhsd``;
the CUDA source, with its bound and design, is ``csrc/flash_attention.cu``:
bf16 runs on Hopper's tensor cores in FlashAttention-3's shape (``wgmma``
from shared memory that a producer warp fills with TMA loads, two consumer
warpgroups in ping-pong, p kept in f32 as a hi/lo pair of bf16 products),
f32 on the CUDA cores. The kernels read q, k and v in their (B, S, H, D) /
(B, S, KVH, D) layouts, GQA and a ragged S included, so nothing is
repeated, transposed or padded.
The launcher checks the tensors, allocates nothing, launches on PyTorch's
current stream and raises if the launch is refused (the bf16 kernel's TMA
tensor maps are encoded on the host at each launch and passed by value). The library is built and
loaded at the first launch (``kernels/build.py``), never at import.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels.build import CSRC, load_library

SOURCE = CSRC / "flash_attention.cu"
# the kernel's instantiations (80: stablelm-3b, 112: zamba2-7b, 256: paligemma-3b)
HEAD_DIMS = (64, 80, 112, 128, 256)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    lib.repro_flash_attention.argtypes = [_P] * 4 + [_I] * 8 + [_F, _P]
    lib.repro_flash_attention.restype = _I
    lib.repro_flash_attention_layout.argtypes = [_I, _I, _P]
    lib.repro_flash_attention_layout.restype = _I
    return lib


LAYOUT_KEYS = ("query_rows", "key_tile", "stages", "smem_width", "threads", "smem_bytes", "registers",
               "local_bytes")


def layout(D: int, dtype: torch.dtype) -> dict:
    """The launch layout of head_dim ``D`` in ``dtype``: query rows a block,
    keys a K/V tile, ring stages, the row width in shared memory (bf16: D
    80 and 112 padded to 128), threads a block, dynamic shared memory
    (bytes), and the compiled kernel's registers a thread at launch and
    local (spilled) bytes, as the runtime reports them (the bf16 kernel's
    consumers raise their registers to 240 with ``setmaxnreg``)."""
    vals = (ctypes.c_int * len(LAYOUT_KEYS))()
    err = library().repro_flash_attention_layout(D, DTYPE_CODES[dtype], ctypes.cast(vals, _P))
    if err < 0:
        raise ValueError(f"head_dim {D} has no kernel (only {HEAD_DIMS})")
    if err:
        raise RuntimeError(f"flash-attention layout query failed with CUDA error {err}")
    return dict(zip(LAYOUT_KEYS, vals))


def check_shape(q_shape, kv_shape) -> None:
    """Raise on shapes the kernel does not take: q (B, S, H, D), k/v
    (B, S, KVH, D), D in ``HEAD_DIMS``, H a multiple of KVH."""
    if len(q_shape) != 4 or len(kv_shape) != 4:
        raise ValueError("q must be (B, S, H, D) and k, v (B, S, KVH, D)")
    B, S, H, D = q_shape
    if tuple(kv_shape[:2]) != (B, S) or kv_shape[3] != D or kv_shape[2] < 1 or H % kv_shape[2]:
        raise ValueError(f"k/v {tuple(kv_shape)} do not fit q {tuple(q_shape)} (H a multiple of KVH)")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} has no kernel (only {HEAD_DIMS})")
    if not (1 <= B < 65536 and 1 <= H < 65536 and 1 <= S < 2**31):
        raise ValueError(f"no kernel for B {B}, S {S}, H {H}")


def flash_attention_launch(out, q, k, v, *, causal: bool, window) -> None:
    """Softmax attention of q (B, S, H, D) over k, v (B, S, KVH, D), query
    head h reading KV head ``h // (H // KVH)``, masked ``k ≤ q`` when
    ``causal`` and ``k > q - window`` with a ``window`` (None for none, else
    at least 1). All four tensors contiguous on one CUDA device, of one
    dtype (f32 or bf16, and then starting on 16-byte boundaries); ``out``
    q's shape, aliasing none of them."""
    if not q.is_cuda or q.dtype not in DTYPE_CODES:
        raise ValueError("q must be a float32/bfloat16 CUDA tensor")
    check_shape(q.shape, k.shape)
    for name, t, shape in (("q", q, q.shape), ("k", k, k.shape), ("v", v, k.shape), ("out", out, q.shape)):
        if t.device != q.device or not t.is_contiguous() or t.shape != shape:
            raise ValueError(f"{name} must be a contiguous {tuple(shape)} tensor on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {q.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be at least 1")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (out, q, k, v)):
        raise ValueError("bf16 tensors must start on a 16-byte boundary")
    if out.data_ptr() in (q.data_ptr(), k.data_ptr(), v.data_ptr()):
        raise ValueError("out must not alias an input")
    B, S, H, D = q.shape
    scale = float(np.float32(1.0) / np.sqrt(np.float32(D)))
    err = library().repro_flash_attention(
        out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), B, S, H, k.shape[2], D, int(causal),
        0 if window is None else min(int(window), S), DTYPE_CODES[q.dtype], scale,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash-attention launch failed with CUDA error {err}")
