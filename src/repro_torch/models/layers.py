"""Shared layer primitives: RMSNorm, RoPE, MLPs, embeddings.

PyTorch port of ``repro.models.layers``.  Plain functions over explicit
parameter tensors; matmuls run in the parameter dtype (bf16 on the card,
f32 in the CPU parity tests) with f32 math where it matters (norms, RoPE).
None of these has a hand-written kernel: the reference has no Pallas kernel
for them either.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * w.float()).to(dtype)


# -- RoPE -------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate-half RoPE in f32.

    x: (..., S, H, hd)   positions: broadcastable to (..., S)
    """
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)  # (hd/2,)
    ang = positions.float()[..., None] * inv  # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- MLPs -------------------------------------------------------------------
def gated_mlp(x: torch.Tensor, p) -> torch.Tensor:
    """SwiGLU: silu(x@wg) * (x@w1) @ w2."""
    g = F.silu(x @ p["wg"])
    h = x @ p["w1"]
    return (g * h) @ p["w2"]


def plain_mlp(x: torch.Tensor, p) -> torch.Tensor:
    """GELU MLP (starcoder2 / whisper style); tanh form, as jax.nn.gelu."""
    h = F.gelu(x @ p["w1"], approximate="tanh")
    return h @ p["w2"]


def mlp(x: torch.Tensor, p, gated: bool) -> torch.Tensor:
    return gated_mlp(x, p) if gated else plain_mlp(x, p)


def embed_tokens(tokens: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return w[tokens.long()]


def lm_logits(x: torch.Tensor, params) -> torch.Tensor:
    """Final projection to vocab; supports tied embeddings."""
    if "lm_head" in params:
        return x @ params["lm_head"]["w"]
    return x @ params["embed"]["w"].t()
