"""RoBERTa-LARGE — the paper's own evaluation model (encoder-only, 24 layers,
355M params, classification head). Used by the FibecFed paper-validation
benchmarks; not part of the assigned-10. [Liu et al. 2020, ICLR]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="roberta-large",
    family="encoder",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=50265,
    qkv_bias=True,
    rope="none",
    norm="layernorm",
    mlp="gelu",
    num_classes=2,
    max_seq_len=512,
    citation="arXiv:1907.11692",
)
