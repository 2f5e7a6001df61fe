"""Llama-3.1 405B — dense GQA with 128k vocab.

[arXiv:2407.21783]  126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    arch_type="dense",
    source="arXiv:2407.21783 (Llama 3 herd)",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=500_000.0,
    long_context_window=8192,  # sliding-window variant used for long_500k
    norm_eps=1e-5,
)
