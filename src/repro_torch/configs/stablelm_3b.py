"""stablelm-3b — dense decoder, full MHA (kv=32), parallel residual,
LayerNorm. [hf:stabilityai/stablelm-2-1_6b]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab_size=50304,
    qkv_bias=False,
    rope="2d",  # stablelm rotates 25-50% of head dim; we use the half-rotary path
    norm="layernorm",
    mlp="swiglu",
    parallel_residual=True,
    attention_window=8192,  # beyond-paper SWA variant enables long_500k
    max_seq_len=524288,
    citation="hf:stabilityai/stablelm-2-1_6b",
)
