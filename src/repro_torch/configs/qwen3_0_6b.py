"""qwen3-0.6b — dense decoder, qk-norm, GQA kv=8. [hf:Qwen/Qwen3-8B]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    qkv_bias=False,
    qk_norm=True,
    rope="full",
    rope_theta=1e6,
    norm="rmsnorm",
    mlp="swiglu",
    tie_embeddings=True,
    attention_window=8192,  # beyond-paper SWA variant enables long_500k
    max_seq_len=524288,
    citation="hf:Qwen/Qwen3-8B",
)
