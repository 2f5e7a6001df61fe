"""Architecture registry: ``get_config(arch_id)`` / ``get_tiny_config(arch_id)``.

The 10 assigned architectures plus the paper's own evaluation model
(llama3.2-3b, used by the serving examples and paper-figure benchmarks).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, make_tiny

from repro_torch.configs.rwkv6_1p6b import CONFIG as _rwkv6
from repro_torch.configs.qwen2_moe_a2p7b import CONFIG as _qwen2_moe
from repro_torch.configs.llama3_405b import CONFIG as _llama3_405b
from repro_torch.configs.starcoder2_7b import CONFIG as _sc2_7b
from repro_torch.configs.recurrentgemma_9b import CONFIG as _rgemma
from repro_torch.configs.whisper_tiny import CONFIG as _whisper
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as _dsv2
from repro_torch.configs.qwen2p5_32b import CONFIG as _qwen25
from repro_torch.configs.llava_next_34b import CONFIG as _llava
from repro_torch.configs.starcoder2_15b import CONFIG as _sc2_15b

# The paper evaluates Agent.xpu with Llama-3.2-3B-Instruct on the SoC.
LLAMA32_3B = ModelConfig(
    name="llama3.2-3b",
    arch_type="dense",
    source="hf:meta-llama/Llama-3.2-3B-Instruct (paper's eval model)",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500_000.0,
    long_context_window=4096,
    tie_embeddings=True,
)

ARCHS = {
    "rwkv6-1.6b": _rwkv6,
    "qwen2-moe-a2.7b": _qwen2_moe,
    "llama3-405b": _llama3_405b,
    "starcoder2-7b": _sc2_7b,
    "recurrentgemma-9b": _rgemma,
    "whisper-tiny": _whisper,
    "deepseek-v2-lite-16b": _dsv2,
    "qwen2.5-32b": _qwen25,
    "llava-next-34b": _llava,
    "starcoder2-15b": _sc2_15b,
    # paper's own model (not part of the assigned 10; used by examples/benches)
    "llama3.2-3b": LLAMA32_3B,
}

ASSIGNED = [k for k in ARCHS if k != "llama3.2-3b"]


def get_config(arch_id: str) -> ModelConfig:
    try:
        return ARCHS[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}") from None


def get_tiny_config(arch_id: str) -> ModelConfig:
    return make_tiny(get_config(arch_id))
