"""whisper-large-v3 — encoder-decoder audio backbone. [arXiv:2212.04356]

32 enc + 32 dec layers, d_model=1280, 20 heads (kv=20), d_ff=5120,
vocab=51866. The mel-spectrogram + conv frontend is STUBBED: input_specs
provides precomputed frame embeddings (B, 1500, 1280). LayerNorm + GELU +
attention biases, sinusoidal positions (see repro_torch.models.encdec for
the learned-positions deviation). Sliding-window decoder self-attention makes
long_500k runnable (beyond-paper; window 8192).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,
    encoder_layers=32,
    encoder_seq_len=1500,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    qkv_bias=True,
    rope="none",
    norm="layernorm",
    mlp="gelu",
    attention_window=8192,
    max_seq_len=524288,
    citation="arXiv:2212.04356",
)
