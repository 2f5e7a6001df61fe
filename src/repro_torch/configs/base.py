"""Base model configuration for all assigned architectures.

A single frozen dataclass describes every architecture family the framework
supports (dense / moe / ssm / hybrid / audio / vlm).  Family-specific fields
default to ``None``/empty and are only consulted by the corresponding blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # -- identity ----------------------------------------------------------
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | audio | vlm
    source: str = ""  # citation (paper / model card)

    # -- trunk dimensions --------------------------------------------------
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    # -- attention ---------------------------------------------------------
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    sliding_window: Optional[int] = None  # native window (None = full attn)
    # window used when lowering the long_500k shape for archs whose native
    # attention is quadratic; None means long_500k is skipped for this arch.
    long_context_window: Optional[int] = None
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    mlp_gated: bool = True  # SwiGLU (3 mats) vs plain GELU MLP (2 mats)

    # -- MLA (deepseek) ----------------------------------------------------
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # -- MoE ---------------------------------------------------------------
    num_experts: int = 0  # routed experts (0 = dense FFN)
    num_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim
    first_k_dense_layers: int = 0  # leading layers with dense FFN
    dense_d_ff: int = 0  # d_ff for those dense layers (0 -> d_ff)
    router_aux_loss_coef: float = 0.001

    # -- SSM / recurrent ---------------------------------------------------
    ssm_kind: str = ""  # "rwkv6" | "rglru"
    ssm_head_dim: int = 64  # rwkv6 head size
    lru_width: int = 0  # rg-lru recurrence width (0 -> d_model)
    conv1d_width: int = 4  # rg-lru temporal conv width

    # -- hybrid layer pattern ------------------------------------------------
    # e.g. ("rglru", "rglru", "attn") repeated `pattern_repeats` times, then
    # `tail_pattern`.  Empty pattern => homogeneous trunk of `block_kind()`.
    layer_pattern: Tuple[str, ...] = ()
    pattern_repeats: int = 0
    tail_pattern: Tuple[str, ...] = ()

    # -- modality frontend (STUB: embeddings provided by input_specs) -------
    frontend: str = "none"  # none | audio | vision
    frontend_tokens: int = 0  # encoder frames / vision patches
    frontend_dim: int = 0  # embedding dim delivered by the stub (0 -> d_model)
    # whisper-style encoder-decoder: decoder cross-attends to encoder output
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0

    # ----------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.lru_width == 0 and self.ssm_kind == "rglru":
            object.__setattr__(self, "lru_width", self.d_model)
        if self.dense_d_ff == 0:
            object.__setattr__(self, "dense_d_ff", self.d_ff)
        if self.frontend != "none" and self.frontend_dim == 0:
            object.__setattr__(self, "frontend_dim", self.d_model)

    # -- derived -----------------------------------------------------------
    def block_kind(self, layer_idx: int) -> str:
        """Kind of block at `layer_idx`: 'attn' | 'rwkv6' | 'rglru'."""
        if self.layer_pattern:
            pat = list(self.layer_pattern) * self.pattern_repeats + list(self.tail_pattern)
            return pat[layer_idx]
        if self.arch_type == "ssm":
            return self.ssm_kind
        return "attn"

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        return tuple(self.block_kind(i) for i in range(self.num_layers))

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return all(k != "attn" for k in self.layer_kinds)

    @property
    def supports_long_context(self) -> bool:
        """True iff the long_500k decode shape is runnable (sub-quadratic)."""
        if self.is_attention_free or self.arch_type == "hybrid":
            return True
        if self.sliding_window is not None or self.long_context_window is not None:
            return True
        return False

    def num_params(self) -> int:
        """Analytic parameter count (matches models.params.init shapes)."""
        d, L = self.d_model, self.num_layers
        n = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d  # lm head
        for i in range(L):
            kind = self.block_kind(i)
            n += 2 * d  # pre norms (mixer + ffn)
            if kind == "attn":
                if self.use_mla:
                    qdim = self.num_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
                    if self.q_lora_rank:
                        n += d * self.q_lora_rank + self.q_lora_rank * qdim
                    else:
                        n += d * qdim
                    n += d * (self.kv_lora_rank + self.qk_rope_head_dim)
                    n += self.kv_lora_rank * self.num_heads * (self.qk_nope_head_dim + self.v_head_dim)
                    n += self.num_heads * self.v_head_dim * d
                else:
                    n += d * self.num_heads * self.head_dim  # q
                    n += 2 * d * self.num_kv_heads * self.head_dim  # k, v
                    n += self.num_heads * self.head_dim * d  # o
                    if self.qkv_bias:
                        n += (self.num_heads + 2 * self.num_kv_heads) * self.head_dim
            elif kind == "rwkv6":
                H = d // self.ssm_head_dim
                n += 5 * d * d + d * d  # r,k,v,g,o + w projection (lora'd in real rwkv; dense here)
                n += 6 * d  # token-shift mixers
                n += H * self.ssm_head_dim  # time_first (u)
            elif kind == "rglru":
                w = self.lru_width
                n += 2 * d * w + w * d  # x/gate in-proj, out-proj
                n += self.conv1d_width * w  # temporal conv
                n += 2 * w * w // 1  # recurrence + input gates (diag-block approx)
                n += w  # a_param
            # ffn
            nm = 3 if self.mlp_gated else 2  # matrices per FFN
            if self.is_moe and i >= self.first_k_dense_layers:
                n += d * self.num_experts  # router
                n += self.num_experts * nm * d * self.moe_d_ff
                n += self.num_shared_experts * nm * d * self.moe_d_ff
            else:
                dff = self.dense_d_ff if (self.is_moe and i < self.first_k_dense_layers) else self.d_ff
                n += nm * d * dff
        if self.is_encoder_decoder:
            # encoder self-attn + ffn, decoder extra cross-attn
            nm = 3 if self.mlp_gated else 2
            for _ in range(self.num_encoder_layers):
                n += 4 * d * d + nm * d * self.d_ff + 2 * d
            for _ in range(L):
                n += 4 * d * d + d  # cross attention + norm
        n += d  # final norm
        return n

    def active_params(self) -> int:
        """Activated params per token (= num_params for dense)."""
        if not self.is_moe:
            return self.num_params()
        d = self.d_model
        total = self.num_params()
        nm = 3 if self.mlp_gated else 2
        moe_layers = self.num_layers - self.first_k_dense_layers
        all_routed = moe_layers * self.num_experts * nm * d * self.moe_d_ff
        active_routed = moe_layers * self.moe_top_k * nm * d * self.moe_d_ff
        return total - all_routed + active_routed

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
def make_tiny(cfg: ModelConfig) -> ModelConfig:
    """Reduced smoke-test variant of the same family.

    Per assignment rules: <=2 layers (pattern length for hybrids), d_model<=512,
    <=4 experts.  Keeps the family topology (GQA ratio, MLA, MoE, pattern).
    """
    d = 128
    heads = 4
    kv = max(1, min(cfg.num_kv_heads, 2)) if cfg.num_kv_heads else 0
    kw = dict(
        name=cfg.name + "-tiny",
        num_layers=2,
        d_model=d,
        num_heads=heads if cfg.num_heads else 0,
        num_kv_heads=kv,
        head_dim=32 if cfg.num_heads else 0,
        d_ff=256,
        vocab_size=512,
        sliding_window=min(cfg.sliding_window, 32) if cfg.sliding_window else None,
        long_context_window=32 if cfg.long_context_window else None,
    )
    if cfg.use_mla:
        kw.update(kv_lora_rank=32, q_lora_rank=None if cfg.q_lora_rank is None else 32,
                  qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
    if cfg.is_moe:
        kw.update(num_experts=4, moe_top_k=2,
                  num_shared_experts=min(cfg.num_shared_experts, 1),
                  moe_d_ff=64, first_k_dense_layers=min(cfg.first_k_dense_layers, 1),
                  dense_d_ff=256)
    if cfg.ssm_kind == "rwkv6":
        kw.update(ssm_head_dim=32)  # 4 heads of 32
    if cfg.ssm_kind == "rglru" or "rglru" in cfg.layer_pattern:
        kw.update(lru_width=d, conv1d_width=4)
    if cfg.layer_pattern:
        kw.update(layer_pattern=cfg.layer_pattern, pattern_repeats=1, tail_pattern=(),
                  num_layers=len(cfg.layer_pattern))
    if cfg.frontend != "none":
        kw.update(frontend_tokens=8, frontend_dim=0)
    if cfg.is_encoder_decoder:
        kw.update(num_encoder_layers=2)
    return cfg.with_overrides(**kw)
