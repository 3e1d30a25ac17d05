"""Architecture registry of the port (``ARCHS[name]``).

Every architecture of the JAX package's registry: the dense decoders
qwen2-0.5b, qwen3-0.6b, stablelm-3b and chatglm3-6b, the MoE decoders
granite-moe-3b-a800m and llama4-maverick-400b-a17b, mamba2-1.3b (ssm),
zamba2-7b (hybrid), whisper-large-v3 (encoder-decoder, family "audio"),
paligemma-3b (vlm) and roberta-large (encoder), and the four input shapes
(``INPUT_SHAPES``).
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.config import InputShape, ModelConfig
from repro_torch.configs.chatglm3_6b import CONFIG as chatglm3_6b
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as granite_moe_3b_a800m
from repro_torch.configs.llama4_maverick_400b_a17b import CONFIG as llama4_maverick_400b_a17b
from repro_torch.configs.mamba2_1_3b import CONFIG as mamba2_1_3b
from repro_torch.configs.paligemma_3b import CONFIG as paligemma_3b
from repro_torch.configs.qwen2_0_5b import CONFIG as qwen2_0_5b
from repro_torch.configs.qwen3_0_6b import CONFIG as qwen3_0_6b
from repro_torch.configs.roberta_large import CONFIG as roberta_large
from repro_torch.configs.stablelm_3b import CONFIG as stablelm_3b
from repro_torch.configs.whisper_large_v3 import CONFIG as whisper_large_v3
from repro_torch.configs.zamba2_7b import CONFIG as zamba2_7b

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in [qwen2_0_5b, qwen3_0_6b, stablelm_3b, chatglm3_6b, granite_moe_3b_a800m,
                        llama4_maverick_400b_a17b, mamba2_1_3b, zamba2_7b, whisper_large_v3, paligemma_3b,
                        roberta_large]
}

ASSIGNED: List[str] = [
    "whisper-large-v3",
    "chatglm3-6b",
    "qwen2-0.5b",
    "llama4-maverick-400b-a17b",
    "granite-moe-3b-a800m",
    "qwen3-0.6b",
    "stablelm-3b",
    "paligemma-3b",
    "mamba2-1.3b",
    "zamba2-7b",
]

INPUT_SHAPES: Dict[str, InputShape] = {
    s.name: s
    for s in [
        InputShape("train_4k", seq_len=4096, global_batch=256, kind="train"),
        InputShape("prefill_32k", seq_len=32768, global_batch=32, kind="prefill"),
        InputShape("decode_32k", seq_len=32768, global_batch=128, kind="decode"),
        InputShape("long_500k", seq_len=524288, global_batch=1, kind="decode"),
    ]
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch]


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]
