"""mamba2-1.3b: attention-free SSD (state-space duality), 48 layers,
d_model=2048, d_state=128, head_dim=64, expand=2, vocab=50280.
[arXiv:2405.21060]"""
from repro_torch.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    head_dim=64,
    rope="none",
    norm="rmsnorm",
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk_size=128, conv_width=4),
    max_seq_len=524288,
    citation="arXiv:2405.21060",
)
