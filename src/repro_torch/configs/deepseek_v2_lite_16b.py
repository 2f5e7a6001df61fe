"""DeepSeek-V2-Lite 16B — MLA (kv_lora=512) + MoE 64 routed top-6 + 2 shared.

[arXiv:2405.04434]  27L d_model=2048 16H, expert d_ff=1408 vocab=102400.
Assignment sheet says "MoE 64e top-6"; the bracket note says 160 routed — we
follow the explicit numeric spec (64) and record the discrepancy in DESIGN.md.
First layer uses a dense FFN (d_ff=10944) per the HF reference config.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    source="arXiv:2405.04434 (DeepSeek-V2)",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,  # MLA: all heads share the latent; kept for bookkeeping
    d_ff=1408,
    vocab_size=102400,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=None,  # V2-Lite projects Q directly
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    head_dim=192,  # qk_nope + qk_rope (bookkeeping)
    num_experts=64,
    num_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1408,
    first_k_dense_layers=1,
    dense_d_ff=10944,
    rope_theta=10_000.0,
    long_context_window=4096,
    norm_eps=1e-6,
)
