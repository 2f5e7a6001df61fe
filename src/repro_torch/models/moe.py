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

In training (``kernel_backend="plain"``, as ``transformer.forward`` calls
it) autograd differentiates the same code: gradients reach the router
through the renormalised ``top_p`` and the aux loss's mean probabilities;
the expert counts and the routing itself carry none, as in the
reference.  On the card the backward of the dispatch gather
(``x[tok_idx]``) accumulates with atomics, so a gradient may differ run to
run in its last bits; remat's recompute routes as the forward did, from
the same saved layer input.
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


def moe_capacity(cfg, T: int, capacity_factor: float = 1.25,
                 capacity_override: int = 0) -> int:
    """Slots an expert takes for T tokens: ``capacity_override``, else the
    reference's own expression (another float order can be off by one)."""
    return capacity_override or max(
        1, int(T * cfg.moe_top_k / cfg.num_experts * capacity_factor))


def moe_ffn(x: torch.Tensor, p, cfg, *, capacity_factor: float = 1.25,
            capacity_override: int = 0,
            kernel_backend: str = "cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE layer over flattened tokens.

    x: (T, d).  p: {"router": (d, E) f32, "experts": {"wg", "w1", "w2"}
    stacked (E, ...), optional "shared": fused gated-MLP params}.
    Returns (y (T, d), Switch-style aux loss, f32 scalar)."""
    T, d = x.shape
    E = cfg.num_experts
    capacity = moe_capacity(cfg, T, capacity_factor, capacity_override)
    probs = torch.softmax(_router(x, p["router"]), dim=-1)  # (T, E) f32
    y, ce = moe_routed(x, probs, p["experts"], cfg, capacity, kernel_backend)
    # load-balance auxiliary loss (Switch-style)
    me = probs.mean(dim=0)
    aux = E * torch.sum(me * ce)
    if "shared" in p:
        y = y + mlp(x, p["shared"], cfg.mlp_gated)
    return y, aux


def moe_routed(x, probs, ep, cfg, capacity: int, kernel_backend: str,
               slots=None):
    """The routed experts of x (T, d) under the router's probabilities
    (T, E): (their combined output (T, d), each expert's share of the T*K
    assignments (E,) f32).  ``slots=(lo, hi)`` computes only that range of
    every expert's ``capacity`` slots (one data rank's part of a sharded
    call), the others adding nothing."""
    T, d = x.shape
    E = cfg.num_experts
    K = cfg.moe_top_k
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
    ce = onehot.sum(dim=0).float() / (T * K)
    lo, hi = slots or (0, capacity)
    n = hi - lo
    if n <= 0:
        return x.new_zeros((T, d)), ce
    if slots is not None:
        keep = keep & (flat_pos >= lo) & (flat_pos < hi)
        flat_pos = flat_pos - lo

    # scatter tokens into (E, n + 1, d); dropped ones land in spill row n
    tok_idx = torch.arange(T * K, device=x.device) // K  # (t, k) -> t
    dest = flat_e * (n + 1) + torch.where(keep, flat_pos, n)
    xe = x.new_zeros((E * (n + 1), d))
    xe[dest] = x[tok_idx]
    xe = xe.view(E, n + 1, d)[:, :n]

    if cfg.mlp_gated:
        g = F.silu(_expert_gemm(xe, ep["wg"], kernel_backend))
        h = _expert_gemm(xe, ep["w1"], kernel_backend)
        ye = _expert_gemm(g * h, ep["w2"], kernel_backend)
    else:
        h = F.gelu(_expert_gemm(xe, ep["w1"], kernel_backend),
                   approximate="tanh")
        ye = _expert_gemm(h, ep["w2"], kernel_backend)

    # gather back and combine with the routing weights (in x.dtype)
    src = flat_e * n + flat_pos.clamp(0, n - 1)
    y_tok = ye.reshape(E * n, d)[src] * keep[:, None].to(x.dtype)
    w = top_p.reshape(-1, 1).to(x.dtype)
    return (y_tok * w).view(T, K, d).sum(dim=1), ce
