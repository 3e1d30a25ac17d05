"""qwen2-0.5b — dense decoder, GQA kv=2, QKV bias. [arXiv:2407.10671]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    rope="full",
    rope_theta=1e6,
    norm="rmsnorm",
    mlp="swiglu",
    tie_embeddings=True,
    attention_window=8192,  # beyond-paper SWA variant enables long_500k
    max_seq_len=524288,
    citation="arXiv:2407.10671",
)
