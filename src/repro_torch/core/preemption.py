"""Preemption context management (paper §6.2).

``ReqContext`` is the JAX-side analogue of the paper's C++ struct: progress
is checkpointed at kernel boundaries, where every intermediate is already a
well-defined activation buffer resident in shared memory — so checkpointing
is pointer bookkeeping, not data movement.  Chunks may pipeline: chunk j+1
may execute kernel i only once chunk j has completed kernel i (this encodes
the KV-order dependency at each attention while letting the NPU run chunk
j+1 linears under chunk j's iGPU attention — the paper's structural slack).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.heg import HEG, HEGNode
from repro_torch.core.requests import Request


@dataclasses.dataclass
class ReqContext:
    """Scheduler-side state of one request (paper's ReqContext)."""
    req: Request
    chunk_kernels: List[List[HEGNode]]  # per-chunk topological chains
    progress: List[int]  # completed kernel count per chunk
    inflight: Dict[int, int]  # chunk -> kernel idx currently running
    preempted_at: Optional[float] = None
    resumed_at: Optional[float] = None
    _etc_cache: float = 0.0

    # -- construction --------------------------------------------------------
    @classmethod
    def build(cls, req: Request, heg: HEG,
              start_tok: int = 0) -> "ReqContext":
        """``start_tok > 0`` (a shared-prefix cache hit, DESIGN.md §10)
        builds kernels for the tail ``[start_tok, prompt_len)`` only;
        chunks before the hit boundary stay as empty (trivially complete)
        entries so chunk indices remain absolute."""
        flat = heg.prefill_kernels(req.id, req.prompt_len,
                                   start_tok=start_tok)
        chunks: List[List[HEGNode]] = []
        for n in flat:
            while len(chunks) <= n.chunk_idx:
                chunks.append([])
            chunks[n.chunk_idx].append(n)
        c = cls(req=req, chunk_kernels=chunks,
                progress=[0] * len(chunks), inflight={})
        c._etc_cache = c._etc_full()
        return c

    # -- prefill progress ----------------------------------------------------
    @property
    def prefill_done(self) -> bool:
        return all(p >= len(ck) for p, ck in
                   zip(self.progress, self.chunk_kernels))

    def prefilled_tokens(self) -> int:
        tok = 0
        for p, ck in zip(self.progress, self.chunk_kernels):
            if ck and p >= len(ck):
                tok += ck[0].tokens
        return tok

    def ready_kernels(self, max_parallel_chunks: int = 8) -> List[HEGNode]:
        """Issueable kernels under the chunk-pipeline dependency rule."""
        out = []
        active = len(self.inflight)
        for j, ck in enumerate(self.chunk_kernels):
            i = self.progress[j]
            if i >= len(ck) or j in self.inflight:
                continue
            if j > 0 and self.chunk_kernels[j - 1] \
                    and self.progress[j - 1] <= i:
                # KV-order: chunk j must stay strictly behind j-1 (an EMPTY
                # predecessor — before a prefix-cache hit boundary — is
                # trivially complete and never gates its successor)
                continue
            out.append(ck[i])
            active += 1
            if active >= max_parallel_chunks:
                break
        return out

    def start(self, node: HEGNode):
        self.inflight[node.chunk_idx] = self.progress[node.chunk_idx]

    def complete(self, node: HEGNode):
        self.inflight.pop(node.chunk_idx, None)
        self.progress[node.chunk_idx] += 1
        self._etc_cache -= self._node_time(node)

    def discard_progress(self):
        """Scheme (a) preemption: throw away all prefill work (recompute)."""
        self.req.recomputed_tokens += self.prefilled_tokens()
        self.progress = [0] * len(self.chunk_kernels)
        self.inflight.clear()
        self._etc_cache = self._etc_full()

    # -- §6.2 resumption strategy --------------------------------------------
    @staticmethod
    def _node_time(n: HEGNode) -> float:
        tt = n.time_on("npu" if n.elastic else "igpu")
        return tt if tt is not None else (n.time_on("igpu") or 0.0)

    def _etc_full(self) -> float:
        return sum(self._node_time(n)
                   for j, ck in enumerate(self.chunk_kernels)
                   for n in ck[self.progress[j]:])

    def etc(self, heg: HEG = None) -> float:
        """Estimated time to (prefill) completion (incrementally cached)."""
        return max(self._etc_cache, 0.0)

    def resume_priority(self, now: float, heg: HEG, *,
                        starvation_threshold: float = 30.0) -> float:
        """Higher = resume sooner.  Aged tasks first (anti-starvation), then
        lowest-ETC-first (fills the decode pipeline earliest, §6.2)."""
        waited = now - (self.preempted_at if self.preempted_at is not None
                        else self.req.arrival_time)
        if waited > starvation_threshold:
            return 1e9 + waited
        return -self.etc(heg)
