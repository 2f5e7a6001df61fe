"""Whisper-tiny — encoder-decoder audio model; conv/mel frontend is a STUB.

[arXiv:2212.04356]  4L d_model=384 6H d_ff=1536 vocab=51865; the encoder
consumes precomputed frame embeddings (B, 1500, 384) from input_specs().
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    arch_type="audio",
    source="arXiv:2212.04356 (Whisper)",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    frontend="audio",
    frontend_tokens=1500,
    is_encoder_decoder=True,
    num_encoder_layers=4,
    rope_theta=10_000.0,  # we use RoPE in place of learned abs pos (noted in DESIGN)
    long_context_window=None,  # full attention decoder -> long_500k skipped
    mlp_gated=False,
    norm_eps=1e-5,
)
