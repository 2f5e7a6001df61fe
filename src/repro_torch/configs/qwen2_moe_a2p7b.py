"""Qwen1.5/2-MoE-A2.7B — 60 routed experts top-4 + 4 shared experts.

[hf:Qwen/Qwen1.5-MoE-A2.7B]  24L d_model=2048 16H (GQA kv=16) expert d_ff=1408
vocab=151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    arch_type="moe",
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151936,
    num_experts=60,
    num_shared_experts=4,
    moe_top_k=4,
    moe_d_ff=1408,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    long_context_window=4096,
    norm_eps=1e-6,
)
