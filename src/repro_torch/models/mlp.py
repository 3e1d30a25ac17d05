"""Feed-forward blocks: SwiGLU and GELU, with LoRA-aware projections."""
from __future__ import annotations

import torch

from repro_torch.models.layers import init_stacked_dense, linear


def init_mlp(gen: torch.Generator, n_layers: int, d_model: int, d_ff: int, kind: str, dtype, device):
    if kind == "swiglu":
        return {
            "w_gate": init_stacked_dense(gen, n_layers, d_model, d_ff, dtype, device),
            "w_up": init_stacked_dense(gen, n_layers, d_model, d_ff, dtype, device),
            "w_down": init_stacked_dense(gen, n_layers, d_ff, d_model, dtype, device),
        }
    return {
        "w_in": init_stacked_dense(gen, n_layers, d_model, d_ff, dtype, device),
        "w_out": init_stacked_dense(gen, n_layers, d_ff, d_model, dtype, device),
    }


def apply_mlp(x: torch.Tensor, p, kind: str, lora=None, lora_scale: float = 1.0):
    """``p`` holds one layer's slice (no layer axis); ``lora`` likewise."""
    lget = (lambda k: lora.get(k) if lora else None)
    if kind == "swiglu":
        g = linear(x, {"w": p["w_gate"]}, lget("w_gate"), lora_scale)
        u = linear(x, {"w": p["w_up"]}, lget("w_up"), lora_scale)
        h = torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u
        return linear(h, {"w": p["w_down"]}, lget("w_down"), lora_scale)
    h = linear(x, {"w": p["w_in"]}, lget("w_in"), lora_scale)
    h = torch.nn.functional.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
    return linear(h, {"w": p["w_out"]}, lget("w_out"), lora_scale)
