"""Configuration dataclasses of the PyTorch port.

A copy of the model and FL configuration of the JAX package
(``repro.config``), kept here so that the port imports nothing of it.
Every architecture is one :class:`ModelConfig` and each input shape one
:class:`InputShape`; the FL / FibecFed
hyper-parameters live in :class:`FibecFedConfig` (paper Table 8).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm", "audio", "encoder")


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 1
    d_ff_expert: int = 0
    shared_expert: bool = False
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router_group_size: int = 512
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk_size: int = 128
    conv_width: int = 4

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # one of FAMILIES
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads

    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope: str = "full"  # "full" | "2d" | "none"
    rope_theta: float = 10000.0
    attention_window: Optional[int] = None  # sliding-window size (None = full)
    parallel_residual: bool = False
    norm: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    mlp: str = "swiglu"  # "swiglu" | "gelu"
    logit_soft_cap: Optional[float] = None
    tie_embeddings: bool = False

    # family-specific
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_period: int = 6
    encoder_layers: int = 0
    encoder_seq_len: int = 1500
    num_prefix_embeddings: int = 0
    num_classes: Optional[int] = None

    max_seq_len: int = 8192
    dtype: str = "bfloat16"

    remat: bool = False
    seq_parallel: bool = False
    attn_score_dtype: str = "float32"
    moe_token_parallel: bool = False

    # LoRA
    lora_rank: int = 8
    lora_alpha: float = 16.0

    citation: str = ""

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.family == "moe" and (self.moe is None or self.moe.num_experts <= 0):
            raise ValueError("family 'moe' needs a MoEConfig with experts")
        if self.family in ("ssm", "hybrid") and self.ssm is None:
            raise ValueError(f"family {self.family!r} needs an SSMConfig")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def supports_long_context(self) -> bool:
        """long_500k decodes need sub-quadratic attention (SSM/hybrid or SWA)."""
        return self.family in ("ssm", "hybrid") or self.attention_window is not None

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family variant for CPU tests (as ``repro.config``)."""
        small: Dict = dict(
            num_layers=2,
            d_model=min(self.d_model, 128),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, min(self.num_heads, 4)),
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            head_dim=32,
            max_seq_len=256,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq_len=min(self.encoder_seq_len, 16),
            num_prefix_embeddings=min(self.num_prefix_embeddings, 8),
            hybrid_period=2,
            lora_rank=4,
            dtype="float32",
        )
        if self.moe is not None:
            small["moe"] = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=min(self.moe.d_ff_expert, 128),
                d_ff_shared=min(self.moe.d_ff_shared, 128) if self.moe.shared_expert else 0,
                router_group_size=64,
            )
        if self.ssm is not None:
            small["ssm"] = dataclasses.replace(
                self.ssm, d_state=min(self.ssm.d_state, 16), head_dim=32, chunk_size=32
            )
        if self.attention_window is not None:
            small["attention_window"] = 64
        small.update(overrides)
        nh, nkv = small["num_heads"], small["num_kv_heads"]
        if nkv and nh % nkv:
            small["num_kv_heads"] = 1
        return dataclasses.replace(self, **small)


@dataclass(frozen=True)
class InputShape:
    """One of the four assigned global input shapes (``configs.INPUT_SHAPES``)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


@dataclass(frozen=True)
class FibecFedConfig:
    num_devices: int = 100  # K in the paper
    devices_per_round: int = 10
    rounds: int = 100  # T
    local_epochs: int = 1
    batch_size: int = 8
    learning_rate: float = 4e-4

    # curriculum (Formula 18): B_k^t = (beta + (1-beta) * t/(alpha*T)) * n_k/B
    curriculum: str = "linear"  # "linear" | "sqrt" | "exp" | "none"
    beta_initial_ratio: float = 0.6
    alpha_full_data: float = 0.8

    # GAL selection
    noise_budget: float = 0.05  # gamma in Eq. 6/8
    norm_p: float = 2.0
    gal_fraction: Optional[float] = 0.75  # None -> lossless criterion
    mu_global_local: float = 1.0

    # local sparse update
    fim_momentum: float = 0.9
    fim_warmup_epochs: int = 2
    sparse_ratio: Optional[float] = 0.5  # None -> lossless criterion
    lanczos_iters: int = 16

    # non-IID partition
    dirichlet_alpha: float = 1.0
    seed: int = 0


@dataclass(frozen=True)
class MeshConfig:
    data: int = 16
    model: int = 16
    pods: int = 1

    @property
    def num_chips(self) -> int:
        return self.data * self.model * self.pods


# TPU v5e roofline constants (per chip), as in the JAX package.
@dataclass(frozen=True)
class HardwareSpec:
    peak_flops: float = 197e12  # bf16 FLOP/s
    hbm_bandwidth: float = 819e9  # bytes/s
    ici_bandwidth: float = 50e9  # bytes/s per link


TPU_V5E = HardwareSpec()

# NVIDIA H100 SXM5 80GB at its 700 W limit (NVIDIA H100 Tensor Core GPU data
# sheet): bf16 tensor cores dense 989 TFLOP/s, HBM3 3.35 TB/s, NVLink 4 at
# 900 GB/s over 18 links (both directions). The bounds chip_smoke.py states
# read these. A card set below 700 W runs slower under load.
H100_SXM = HardwareSpec(peak_flops=989e12, hbm_bandwidth=3.35e12, ici_bandwidth=900e9 / 18)
