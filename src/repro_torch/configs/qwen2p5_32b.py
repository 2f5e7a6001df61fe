"""Qwen2.5-32B — dense GQA with QKV bias.

[hf:Qwen/Qwen2.5-0.5B family card]  64L d_model=5120 40H (GQA kv=8)
d_ff=27648 vocab=152064.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    arch_type="dense",
    source="hf:Qwen/Qwen2.5 model cards",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    long_context_window=4096,
    norm_eps=1e-6,
)
