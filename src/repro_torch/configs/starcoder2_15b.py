"""StarCoder2-15B — dense GQA, RoPE, native sliding window.

[arXiv:2402.19173]  40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    arch_type="dense",
    source="arXiv:2402.19173 (StarCoder2)",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    sliding_window=4096,
    long_context_window=4096,
    mlp_gated=False,
    norm_eps=1e-5,
)
