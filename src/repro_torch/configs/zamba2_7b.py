"""zamba2-7b — hybrid: 81 Mamba2 layers (d_state=64) + ONE shared attention
block (32 heads kv=32, d_ff=14336) applied every 6 Mamba layers.
[arXiv:2411.15242]"""
from repro_torch.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    rope="full",
    norm="rmsnorm",
    mlp="swiglu",
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, chunk_size=128, conv_width=4),
    hybrid_period=6,
    max_seq_len=524288,
    citation="arXiv:2411.15242",
)
