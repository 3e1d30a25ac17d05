"""paligemma-3b — VLM: SigLIP vision encoder (STUBBED; input_specs provides
256 patch embeddings at d_model) + Gemma-2B decoder: 18L, d_model=2048,
8 heads kv=1 (MQA), head_dim=256, GELU d_ff=16384, vocab=257216.
[arXiv:2407.07726]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    qkv_bias=False,
    rope="full",
    norm="rmsnorm",
    mlp="gelu",
    tie_embeddings=True,
    num_prefix_embeddings=256,
    attention_window=8192,  # beyond-paper SWA variant enables long_500k
    max_seq_len=524288,
    citation="arXiv:2407.07726",
)
