"""RWKV-6 "Finch" 1.6B — attention-free SSM with data-dependent decay.

[arXiv:2404.05892]  24L d_model=2048 d_ff=7168 vocab=65536, head size 64.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    arch_type="ssm",
    source="arXiv:2404.05892 (RWKV-6 Finch)",
    num_layers=24,
    d_model=2048,
    d_ff=7168,
    vocab_size=65536,
    ssm_kind="rwkv6",
    ssm_head_dim=64,
    norm_eps=1e-5,
)
