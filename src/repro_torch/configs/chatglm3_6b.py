"""chatglm3-6b — dense decoder, RoPE on half the head dim ("2d"), GQA kv=2.
[arXiv:2406.12793]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    qkv_bias=True,  # chatglm uses QKV bias ("add_qkv_bias")
    rope="2d",
    norm="rmsnorm",
    mlp="swiglu",
    attention_window=8192,  # beyond-paper SWA variant enables long_500k
    max_seq_len=524288,
    citation="arXiv:2406.12793",
)
