"""LLaVA-NeXT-34B backbone — dense GQA LM consuming anyres patch embeddings.

[hf:llava-hf/llava-v1.6 family]  60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000.  The vision tower + projector are a STUB: input_specs() delivers
precomputed patch embeddings (B, 2880, d_model) — anyres 4+1 tiles x 576.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    arch_type="vlm",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf (scaled per assignment)",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    frontend="vision",
    frontend_tokens=2880,  # 5 tiles x 576 patches (anyres)
    rope_theta=5_000_000.0,
    long_context_window=8192,
    norm_eps=1e-5,
)
