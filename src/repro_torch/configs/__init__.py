"""Architecture registry of the port (``ARCHS[name]``).

Holds the architectures the port runs so far: the dense decoders
qwen2-0.5b, qwen3-0.6b, stablelm-3b and chatglm3-6b, and mamba2-1.3b (ssm).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.config import ModelConfig
from repro_torch.configs.chatglm3_6b import CONFIG as chatglm3_6b
from repro_torch.configs.mamba2_1_3b import CONFIG as mamba2_1_3b
from repro_torch.configs.qwen2_0_5b import CONFIG as qwen2_0_5b
from repro_torch.configs.qwen3_0_6b import CONFIG as qwen3_0_6b
from repro_torch.configs.stablelm_3b import CONFIG as stablelm_3b

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in [qwen2_0_5b, qwen3_0_6b, stablelm_3b, chatglm3_6b, mamba2_1_3b]
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch]
