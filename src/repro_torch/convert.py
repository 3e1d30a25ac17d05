"""Carry weights between the JAX package and the port, through numpy.

The trees keep the same nested-dict key paths on both sides, so a JAX
runner's ``params`` / ``_init_lora`` (as numpy) load into the port and the
port's trees come back as numpy for comparison. numpy has no bfloat16 of its
own: a bfloat16 array arrives as ``ml_dtypes`` bfloat16 (what
``np.asarray`` gives for a JAX bf16 array) and is read through its bits;
:func:`to_numpy` returns bfloat16 tensors widened to float32.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models.transformer import torch_dtype
from repro_torch.utils.tree import tree_map, tree_map_with_path_str

# base-model leaves the JAX package keeps in f32 whatever the model dtype
# (the SSM's decay, skip and dt bias)
F32_LEAVES = ("A_log", "D", "dt_bias")


def _tensor(arr, device, dtype=None) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree: Any, cfg: ModelConfig, device) -> Any:
    """Base-model params; floating leaves are cast to ``cfg.dtype``, those
    named in :data:`F32_LEAVES` to f32."""
    dtype = torch_dtype(cfg.dtype)
    return tree_map_with_path_str(
        lambda path, a: _tensor(a, device, torch.float32 if path.rsplit("/", 1)[-1] in F32_LEAVES else dtype),
        tree)


def lora_from_numpy(tree: Any, device) -> Any:
    """A LoRA tree, f32 as the JAX package keeps it."""
    return tree_map(lambda a: _tensor(a, device, torch.float32), tree)


def to_numpy(tree: Any) -> Any:
    """Tensors -> numpy arrays (bfloat16 widened to float32)."""

    def one(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()

    return tree_map(one, tree)
