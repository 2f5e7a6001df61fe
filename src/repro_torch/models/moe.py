"""Mixture-of-Experts FFN with capacity-based sparse dispatch.

PyTorch port of ``repro.models.moe``: tokens are scattered into per-expert
capacity buffers (E, C, d) and each expert runs one batched GEMM, so the
products cost ~6 N_active D, not a dense pass over every expert.  With
``kernel_backend="cuda"`` the three expert products go through
``kernels.ops.moe_gemm`` (the CUDA kernel on CUDA tensors, its plain
version on CPU tensors); ``"plain"`` runs ``torch.einsum``.

Differences from the reference, all forced by the frameworks:

* No data-dependent shapes and no host sync: the reference's scatter-add
  of dropped assignments (as zeros, at slot ``capacity - 1``) becomes a
  write into a spill row ``C`` of an (E, C + 1, d) buffer that the GEMM
  never reads.
* The combine is a fixed-order sum over the K routed copies of each token
  (``(T, K, d).sum(1)``), not ``index_add_``, whose CUDA atomics would
  make the sum's order, and so the served tokens, vary from run to run.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import mlp


def _router(x, w_router):
    """Routing logits in f32.  x: (T, d) -> (T, E)."""
    return x.float() @ w_router.float()


def _expert_gemm(x, w, kernel_backend):
    if kernel_backend == "cuda":
        return kops.moe_gemm(x, w)
    return torch.einsum("ecd,edf->ecf", x, w)


def moe_ffn(x: torch.Tensor, p, cfg, *, capacity_factor: float = 1.25,
            capacity_override: int = 0,
            kernel_backend: str = "cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE layer over flattened tokens.

    x: (T, d).  p: {"router": (d, E) f32, "experts": {"wg", "w1", "w2"}
    stacked (E, ...), optional "shared": fused gated-MLP params}.
    Returns (y (T, d), Switch-style aux loss, f32 scalar)."""
    T, d = x.shape
    E = cfg.num_experts
    K = cfg.moe_top_k
    # the reference's own expression: another float order can be off by one
    capacity = capacity_override or max(1, int(T * K / E * capacity_factor))

    probs = torch.softmax(_router(x, p["router"]), dim=-1)  # (T, E) f32
    # ties in the top-k may order differently from jax.lax.top_k; random f32
    # router logits do not tie at the sizes this runs at
    top_p, top_e = torch.topk(probs, K, dim=-1)  # (T, K)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    # position of each (token, k) assignment in its expert's buffer, in
    # routing order (t, k): an exclusive running count per expert
    flat_e = top_e.reshape(-1)  # (T*K,)
    onehot = (flat_e[:, None] == torch.arange(E, device=x.device)).to(
        torch.int32)  # (T*K, E)
    pos_in_e = torch.cumsum(onehot, dim=0) - onehot
    flat_pos = torch.gather(pos_in_e, 1, flat_e[:, None])[:, 0]
    keep = flat_pos < capacity  # assignments past capacity are dropped

    # load-balance auxiliary loss (Switch-style)
    me = probs.mean(dim=0)
    ce = onehot.sum(dim=0).float() / (T * K)
    aux = E * torch.sum(me * ce)

    # scatter tokens into (E, C + 1, d); dropped ones land in spill row C
    tok_idx = torch.arange(T * K, device=x.device) // K  # (t, k) -> t
    dest = flat_e * (capacity + 1) + torch.where(keep, flat_pos, capacity)
    xe = x.new_zeros((E * (capacity + 1), d))
    xe[dest] = x[tok_idx]
    xe = xe.view(E, capacity + 1, d)[:, :capacity]

    ep = p["experts"]
    if cfg.mlp_gated:
        g = F.silu(_expert_gemm(xe, ep["wg"], kernel_backend))
        h = _expert_gemm(xe, ep["w1"], kernel_backend)
        ye = _expert_gemm(g * h, ep["w2"], kernel_backend)
    else:
        h = F.gelu(_expert_gemm(xe, ep["w1"], kernel_backend),
                   approximate="tanh")
        ye = _expert_gemm(h, ep["w2"], kernel_backend)

    # gather back and combine with the routing weights (in x.dtype)
    src = flat_e * capacity + flat_pos.clamp_max(capacity - 1)
    y_tok = ye.reshape(E * capacity, d)[src] * keep[:, None].to(x.dtype)
    w = top_p.reshape(-1, 1).to(x.dtype)
    y = (y_tok * w).view(T, K, d).sum(dim=1)

    if "shared" in p:
        y = y + mlp(x, p["shared"], cfg.mlp_gated)
    return y, aux
