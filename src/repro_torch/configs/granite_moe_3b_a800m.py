"""granite-moe-3b-a800m — MoE 40 experts top-8, d_ff_expert=512, GQA kv=8.
[hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    qkv_bias=False,
    rope="full",
    norm="rmsnorm",
    mlp="swiglu",
    moe=MoEConfig(
        num_experts=40,
        top_k=8,
        d_ff_expert=512,
        shared_expert=False,
        capacity_factor=1.25,
        router_group_size=512,
    ),
    attention_window=8192,  # beyond-paper SWA variant enables long_500k
    max_seq_len=524288,
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
