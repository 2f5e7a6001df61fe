"""Heterogeneous Execution Graph (paper §5).

Offline phase: op-group the model into kernels, choose the elastic chunk size
at the NPU saturation knee, disaggregate prefill (NPU) from decode (iGPU),
and annotate every kernel with the §5.3 predictive fields.

Kernel taxonomy (op-group granularity — paper §5.1):
  LINEAR_CHUNK  token-level op-group (QKV/O + FFN + norms fused) for one
                layer x one prompt chunk.  Static shape -> ELASTIC: eagerly
                NPU in the prefill graph, runtime-retargetable to iGPU.
  ATTN_DYN      sequence-level MHA for one layer x one chunk.  Dynamic
                shape -> iGPU only (NPUs cannot JIT dynamic kernels).
                Attention-free blocks (RWKV6/RG-LRU) have NO ATTN_DYN nodes:
                their scans are chunked token-level kernels (NPU-eligible).
  DECODE_STEP   one decode iteration for a batch (all layers fused),
                dynamic batch -> iGPU.
  KV_XFER       prefill->decode lane handoff.  Zero-cost on unified-memory
                SoCs; annotated with real bytes for the TPU submesh profile.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import List, Optional, Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.core.annotation import HardwareProfile, KernelAnnotation, annotate


class KernelKind(enum.Enum):
    LINEAR_CHUNK = "linear_chunk"
    ATTN_DYN = "attn_dyn"
    DECODE_STEP = "decode_step"
    KV_XFER = "kv_xfer"


@dataclasses.dataclass
class HEGNode:
    kind: KernelKind
    layer: int
    chunk_idx: int
    tokens: int  # tokens covered by this kernel
    ann: KernelAnnotation
    elastic: bool  # backend decidable at dispatch (token-level static)
    req_id: Optional[int] = None
    seq_start: int = 0  # first absolute position of the chunk

    def time_on(self, lane: str) -> Optional[float]:
        return self.ann.time_on(lane)


def _pow2_round(x: float) -> int:
    return int(2 ** round(math.log2(max(x, 1))))


class HEG:
    """Per-model heterogeneous execution graph + annotation tables."""

    def __init__(self, cfg: ModelConfig, hw: HardwareProfile, *,
                 weight_bytes: float = 1.0, act_bytes: float = 2.0,
                 chunk_size: Optional[int] = None,
                 max_kernel_time: float = 0.1):
        self.cfg = cfg
        self.hw = hw
        self.weight_bytes = weight_bytes  # W8A16 -> 1 byte/weight
        self.act_bytes = act_bytes
        L = max(cfg.num_layers, 1)
        n_active = cfg.active_params()
        embed = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
        self.linear_params_per_layer = max((n_active - embed), 0) / L
        self.head_params = embed  # lm head + embed, charged to last kernel
        self.kinds = cfg.layer_kinds
        self.n_layers = cfg.num_layers

        # kv bytes per token per attention layer
        if cfg.use_mla:
            self.kv_tok_layer = (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * 2
        elif cfg.num_kv_heads:
            self.kv_tok_layer = 2 * cfg.num_kv_heads * cfg.head_dim * 2
        else:
            self.kv_tok_layer = 0

        # elastic chunk size: 2x the NPU saturation knee so the chunked
        # linear kernels sit firmly in the compute-bound regime ("the turning
        # point where the kernel just saturates the NPU", §5.2), clamped by
        # the paper's <100 ms preemption-latency budget
        wl_bytes = self.linear_params_per_layer * weight_bytes
        fl_per_tok = 2 * self.linear_params_per_layer
        knee = hw.npu.flops * wl_bytes / (hw.npu.mem_bw * max(fl_per_tok, 1))
        c = _pow2_round(2 * knee)
        while c > 64 and fl_per_tok * c / hw.npu.flops > max_kernel_time:
            c //= 2
        self.chunk_size = chunk_size or max(64, min(1024, c))

        # decode batching knee (paper §3.2 / §6.3 B_max)
        n_bytes = n_active * weight_bytes
        fl_tok = 2 * n_active
        b_knee = hw.igpu.flops * n_bytes / (hw.igpu.mem_bw * max(fl_tok, 1))
        self.B_max = int(max(1, min(16, b_knee)))

    # -- annotations ---------------------------------------------------------
    def _linear_chunk_ann(self, tokens: int, last: bool) -> KernelAnnotation:
        fl = 2 * self.linear_params_per_layer * tokens
        by = self.linear_params_per_layer * self.weight_bytes \
            + 2 * tokens * self.cfg.d_model * self.act_bytes
        if last:
            fl += 2 * self.head_params * tokens / max(self.n_layers, 1)
            by += self.head_params * self.weight_bytes / max(self.n_layers, 1)
        return annotate(fl, by, self.hw, allow_npu=True, allow_igpu=True)

    def _attn_ann(self, tokens: int, kv_len: int) -> KernelAnnotation:
        cfg = self.cfg
        if cfg.sliding_window:
            kv_len = min(kv_len, cfg.sliding_window)
        hq = max(cfg.num_heads, 1)
        hd = cfg.head_dim or (cfg.d_model // max(hq, 1))
        fl = 4 * tokens * kv_len * hq * hd
        by = self.kv_tok_layer * kv_len \
            + 2 * tokens * cfg.d_model * self.act_bytes
        return annotate(fl, by, self.hw, allow_npu=False, allow_igpu=True)

    def decode_step_ann(self, batch: int, kv_lens: Sequence[int]
                        ) -> KernelAnnotation:
        """One fused decode iteration for `batch` sequences."""
        cfg = self.cfg
        n = cfg.active_params()
        fl = 2 * n * batch
        kv_read = 0.0
        n_attn = sum(1 for k in self.kinds if k == "attn")
        for kl in kv_lens:
            if cfg.sliding_window:
                kl = min(kl, cfg.sliding_window)
            kv_read += self.kv_tok_layer * kl * n_attn
            fl += 4 * 1 * kl * max(cfg.num_heads, 1) * \
                (cfg.head_dim or 1) * n_attn
        by = n * self.weight_bytes + kv_read \
            + 2 * batch * cfg.d_model * cfg.num_layers * self.act_bytes
        return annotate(fl, by, self.hw, allow_npu=False, allow_igpu=True)

    def kv_xfer_ann(self, prompt_len: int) -> KernelAnnotation:
        n_attn = sum(1 for k in self.kinds if k == "attn")
        by = self.kv_tok_layer * prompt_len * n_attn
        # unified-memory SoC: pointer handoff (paper: zero-copy); TPU lanes:
        # ICI transfer at shared_bw
        if "tpu" in self.hw.name:
            return annotate(0.0, by, self.hw, allow_npu=True,
                            allow_igpu=True)
        return annotate(0.0, 0.0, self.hw, allow_npu=True, allow_igpu=True)

    # -- instantiation (paper: task decomposition on dequeue) ---------------
    def prefill_kernels(self, req_id: int, prompt_len: int, *,
                        start_tok: int = 0) -> List[HEGNode]:
        """Topologically-ordered kernel chain for (the rest of) a prefill."""
        nodes: List[HEGNode] = []
        c = self.chunk_size
        pos = start_tok
        chunk_idx = start_tok // c
        while pos < prompt_len:
            tokens = min(c, prompt_len - pos)
            for layer, kind in enumerate(self.kinds):
                last = layer == self.n_layers - 1
                nodes.append(HEGNode(
                    kind=KernelKind.LINEAR_CHUNK, layer=layer,
                    chunk_idx=chunk_idx, tokens=tokens,
                    ann=self._linear_chunk_ann(tokens, last),
                    elastic=True, req_id=req_id, seq_start=pos))
                if kind == "attn":
                    nodes.append(HEGNode(
                        kind=KernelKind.ATTN_DYN, layer=layer,
                        chunk_idx=chunk_idx, tokens=tokens,
                        ann=self._attn_ann(tokens, pos + tokens),
                        elastic=False, req_id=req_id, seq_start=pos))
            pos += tokens
            chunk_idx += 1
        return nodes

    def prefill_time_estimate(self, prompt_len: int, lane: str = "npu"
                              ) -> float:
        """ETC model for §6.2 resumption priorities."""
        t = 0.0
        for n in self.prefill_kernels(-1, prompt_len):
            tt = n.time_on(lane if n.elastic else "igpu")
            t += tt if tt is not None else n.time_on("igpu")
        return t
