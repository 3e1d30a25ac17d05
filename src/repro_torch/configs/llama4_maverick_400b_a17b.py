"""llama4-maverick-400b-a17b — MoE 128 experts top-1 + shared expert,
GQA kv=8, early-fusion-style decoder. [hf:meta-llama/Llama-4-Scout-17B-16E]
"""
from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    qkv_bias=False,
    rope="full",
    rope_theta=5e5,
    norm="rmsnorm",
    mlp="swiglu",
    moe=MoEConfig(
        num_experts=128,
        top_k=1,
        d_ff_expert=8192,
        shared_expert=True,
        d_ff_shared=8192,
        capacity_factor=1.25,
        router_group_size=512,
    ),
    attention_window=8192,  # beyond-paper SWA variant enables long_500k
    max_seq_len=524288,
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
)
