"""Launchers of the hand-written CUDA masked AdamW / SGD kernels (B1, B2).

Ports the TPU kernels ``repro/kernels/masked_update.py::masked_adamw_update_2d``
and ``::masked_sgd_update_2d``; the CUDA source, with its bound and design,
is ``csrc/masked_update.cu``. Each launches once per tree of up to
``MAX_LEAVES`` leaves, from a table of the leaves' pointers, sizes and
dtypes that :func:`repro_torch.kernels.tree_launch.plan` splits into
launches. Each launcher checks the tensors, allocates nothing, launches on
PyTorch's current stream and raises if the launch is refused. The library
is built and loaded at the first launch (``kernels/build.py``), never at
import.
"""
from __future__ import annotations

import array
import ctypes
import functools

import torch

from repro_torch.kernels import tree_launch as tl
from repro_torch.kernels.build import CSRC, load_library

SOURCE = CSRC / "masked_update.cu"
_P, _I64, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
SGD_CHUNK = 4096  # elements per block of the SGD tree kernel (kSgdChunk in the source)
ADAMW_CHUNK = 2048  # elements per block of the AdamW tree kernel (kAdamwChunk)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    lib.repro_masked_sgd_tree.argtypes = [_P, _I, _I64, _I64, _P, _F, _F, _F, _P]
    lib.repro_masked_sgd_tree.restype = _I
    lib.repro_masked_adamw_tree.argtypes = ([_P, _I, _I64, _I64, _P, _F, _P, _I64, _F, _P, _I64, _P, _I]
                                            + [_F] * 6 + [_P])
    lib.repro_masked_adamw_tree.restype = _I
    return lib


def table(launch: tl.Launch, clients: int, p_out, p, g, m_out, m, v_out, v, mask) -> array.array:
    """The kernels' host table for the leaves ``launch`` names: per leaf
    ``[p, g, m, v, mask, p_out, m_out, v_out, n, per_client, block0,
    dtypes]`` (``m``/``v`` lists of None where the kernel takes none), after
    checking every tensor: p, g and the moments f32 or bf16 each, the mask
    f32, all contiguous with p's element count on p's device."""
    di = p[launch.leaves[0]].get_device()
    words = array.array("q")
    for i, b0 in zip(launch.leaves, launch.block0):
        pi, n = p[i], p[i].numel()
        dp = tl.code_of("p", pi, n, di)
        dg = tl.code_of("g", g[i], n, di)
        if tl.code_of("p_out", p_out[i], n, di) != dp:
            raise TypeError(f"p_out has dtype {p_out[i].dtype}, expected {pi.dtype}")
        dm = dv = 0
        if m[i] is not None:
            dm = tl.code_of("m", m[i], n, di)
            if tl.code_of("m_out", m_out[i], n, di) != dm:
                raise TypeError(f"m_out has dtype {m_out[i].dtype}, expected {m[i].dtype}")
        if v[i] is not None:
            dv = tl.code_of("v", v[i], n, di)
            if tl.code_of("v_out", v_out[i], n, di) != dv:
                raise TypeError(f"v_out has dtype {v_out[i].dtype}, expected {v[i].dtype}")
        if mask[i] is not None:
            tl.code_of("mask", mask[i], n, di, tl.F32_ONLY)
        words.extend((pi.data_ptr(), g[i].data_ptr(),
                      0 if m[i] is None else m[i].data_ptr(), 0 if v[i] is None else v[i].data_ptr(),
                      0 if mask[i] is None else mask[i].data_ptr(), p_out[i].data_ptr(),
                      0 if m[i] is None else m_out[i].data_ptr(), 0 if v[i] is None else v_out[i].data_ptr(),
                      n, n // clients, b0, dp | dg << 8 | dm << 16 | dv << 24))
    return words


def sgd_tree_launch(launch: tl.Launch, p_out, p, g, mu_out, mu, mask, *, clients: int, scal, lr: float,
                    active: float, momentum: float) -> None:
    """One masked SGD(+momentum) launch over the leaves ``launch`` names of
    the leaf lists ``p``, ``g``, ``mask`` (entries may be None) and ``mu``,
    writing ``p_out`` and ``mu_out`` (lists of None without momentum). p, g
    and μ f32 or bf16 each, the mask f32; all contiguous on one CUDA device.
    The outputs are the caller's fresh :func:`tree_launch.views`, in the
    inputs' dtypes. ``scal`` None: ``lr`` and ``active`` travel by value;
    else a contiguous f32 (clients, 4) device table ``[lr, active, -, -]``
    per client, every leaf stacking the clients on its leading axis, and
    ``launch`` planned for ``clients`` rows per leaf."""
    if (mu[launch.leaves[0]] is None) == bool(momentum):
        raise ValueError("mu and mu_out are given exactly when momentum is non-zero")
    if scal is not None and (scal.dtype != torch.float32 or tuple(scal.shape) != (clients, 4)
                             or not scal.is_contiguous()
                             or scal.get_device() != p[launch.leaves[0]].get_device()):
        raise ValueError(f"scal must be a contiguous float32 ({clients}, 4) table on the leaves' device")
    tl.check_stacked(clients, p[launch.leaves[0]].get_device(), [p[i] for i in launch.leaves])
    none = [None] * len(p)
    words = table(launch, clients, p_out, p, g, mu_out, mu if momentum else none, none, none, mask)
    err = library().repro_masked_sgd_tree(
        words.buffer_info()[0], len(launch.leaves), launch.grid, SGD_CHUNK,
        None if scal is None else scal.data_ptr(), lr, active, momentum,
        torch._C._cuda_getCurrentRawStream(p[launch.leaves[0]].get_device()),  # PyTorch's current stream
    )
    tl.raise_on(err, "masked SGD")


def adamw_tree_launch(launch: tl.Launch, p_out, p, g, m_out, m, v_out, v, mask, *, clients: int, t, t_out,
                      lr, active, b1: float, b2: float, eps: float, wd: float) -> None:
    """One masked AdamW launch over the leaves ``launch`` names (planned for
    ``clients`` rows per leaf, each leaf stacking the clients on its leading
    axis when there are several). p, g, m and v f32 or bf16 each, the mask
    f32 (entries may be None); the outputs are fresh views in the inputs'
    dtypes. ``lr`` a number, or a one-element f32 tensor read on the card;
    ``active`` a number, or an f32 tensor of one element or of one per
    client (any stride); ``t`` the int32 step counters (one, or one per
    client, contiguous) and ``t_out`` a contiguous int32 tensor of
    ``clients`` elements that receives the advanced counters."""
    di = p[launch.leaves[0]].get_device()
    tl.check_stacked(clients, di, [p[i] for i in launch.leaves])
    lr_ptr, lr_v = (lr, 0.0) if isinstance(lr, torch.Tensor) else (None, float(lr))
    act, act_v = (active, 0.0) if isinstance(active, torch.Tensor) else (None, float(active))
    if lr_ptr is not None and (lr_ptr.dtype != torch.float32 or lr_ptr.numel() != 1 or lr_ptr.get_device() != di):
        raise ValueError("a tensor lr must be one float32 value on the leaves' device")
    if act is not None and (act.dtype != torch.float32 or act.dim() > 1 or act.get_device() != di
                            or act.numel() not in (1, clients)):
        raise ValueError(f"a tensor active must be float32 with 1 or {clients} elements on the leaves' device")
    if (t.dtype != torch.int32 or not t.is_contiguous() or t.numel() not in (1, clients) or t.get_device() != di
            or t_out.dtype != torch.int32 or not t_out.is_contiguous() or t_out.numel() != clients
            or t_out.get_device() != di):
        raise ValueError(f"t and t_out must be contiguous int32 step counters ({clients} for t_out) on "
                         "the leaves' device")
    words = table(launch, clients, p_out, p, g, m_out, m, v_out, v, mask)
    err = library().repro_masked_adamw_tree(
        words.buffer_info()[0], len(launch.leaves), launch.grid, ADAMW_CHUNK,
        None if lr_ptr is None else lr_ptr.data_ptr(), lr_v,
        None if act is None else act.data_ptr(), 0 if act is None or act.numel() == 1 else act.stride(0), act_v,
        t.data_ptr(), 1 if t.numel() > 1 else 0, t_out.data_ptr(), clients,
        b1, 1.0 - b1, b2, 1.0 - b2, eps, wd,
        torch._C._cuda_getCurrentRawStream(di),
    )
    tl.raise_on(err, "masked AdamW")
