"""StarCoder2-7B — dense GQA, RoPE, native sliding window.

[arXiv:2402.19173]  32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    arch_type="dense",
    source="arXiv:2402.19173 (StarCoder2)",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    sliding_window=4096,
    long_context_window=4096,
    mlp_gated=False,
    norm_eps=1e-5,
)
