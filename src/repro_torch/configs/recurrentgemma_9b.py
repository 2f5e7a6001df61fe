"""RecurrentGemma-9B (Griffin) — RG-LRU + local attention, 2:1 pattern.

[arXiv:2402.19427]  38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000,
local attention window 2048, lru_width 4096.  Pattern (R,R,A) x 12 + (R,R).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    source="arXiv:2402.19427 (Griffin / RecurrentGemma)",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    sliding_window=2048,
    layer_pattern=("rglru", "rglru", "attn"),
    pattern_repeats=12,
    tail_pattern=("rglru", "rglru"),
    ssm_kind="rglru",
    lru_width=4096,
    conv1d_width=4,
    rope_theta=10_000.0,
    norm_eps=1e-6,
)
