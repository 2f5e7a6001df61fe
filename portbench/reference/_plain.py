"""Plain float32 building blocks of the references (no kernels, no cache,
no batching), and the lower-precision product the control computes in.

The references import nothing of the program: they read the configuration
file's published keys and the benchmark's weight tensors (by their tree
paths), upcast one layer at a time to float32, with TF32 off.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest finite float8_e4m3fn


def no_tf32() -> None:
    """Float32 products in float32 (the card would otherwise be free to use
    TF32, a lower precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def mm32(x, w):
    """x (..., k) @ w (k, n) in float32."""
    return x @ w


def _fp8(t, dim):
    """``t`` rounded through float8 e4m3 with one scale per slice along
    ``dim`` (its absolute maximum mapped to the format's largest value)."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    s = amax / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def mm_fp8(x, w):
    """The control's product: x rounded per row and w per output column
    through float8 e4m3, then multiplied in float32 (what an fp8 GEMM with
    per-token and per-channel scales computes)."""
    return _fp8(x, -1) @ _fp8(w, 0)


PRODUCTS = {"f32": mm32, "fp8": mm_fp8}


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x, pos, theta):
    """Rotate-half RoPE of x (S, H, d) at positions pos (S,)."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                       device=x.device) / d)
    ang = (pos.double()[:, None] * inv).float()
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, scale):
    """q, k (S, H, dk), v (S, H, dv) -> (S, H, dv), causal, in f32."""
    s = torch.einsum("qhd,khd->hqk", q, k) * scale
    S = q.shape[0]
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v)


def gated_mlp(x, wg, w1, w2, mm):
    return mm(F.silu(mm(x, wg)) * mm(x, w1), w2)


def keep_mask(top_e, E, groups):
    """Which (token, rank) assignments of ``top_e`` (T, K) the experts
    take.  ``groups`` lists (start, length, limited): the tokens of one
    prefill sub-chunk share each expert's max(1, int(n K / E 1.25)) slots,
    taken in (token, rank) order, the rest dropped; an unlimited group (a
    decode step) drops nothing."""
    T, K = top_e.shape
    keep = torch.ones(T, K, dtype=torch.bool, device=top_e.device)
    for start, n, limited in groups:
        if not limited:
            continue
        cap = max(1, int(n * K / E * 1.25))
        e = top_e[start:start + n].reshape(-1)
        onehot = F.one_hot(e, E).to(torch.int64)
        pos = (torch.cumsum(onehot, 0) - onehot).gather(1, e[:, None])[:, 0]
        keep[start:start + n] = (pos < cap).view(n, K)
    return keep


def routed_experts(x, router, wg, w1, w2, K, groups, mm):
    """Softmax routing over E experts, the top K renormalised, each
    expert's gated MLP on the assignments it keeps (``keep_mask``)."""
    T = x.shape[0]
    E = router.shape[1]
    probs = torch.softmax(x @ router, dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    keep = keep_mask(top_e, E, groups)
    y = torch.zeros_like(x)
    flat_e = top_e.reshape(-1)
    flat_w = (top_p * keep).reshape(-1)
    tok = torch.arange(T * K, device=x.device) // K
    ok = keep.reshape(-1)
    for e in range(E):
        sel = ((flat_e == e) & ok).nonzero()[:, 0]
        if sel.numel() == 0:
            continue
        t = tok[sel]
        out = gated_mlp(x[t], wg[e], w1[e], w2[e], mm)
        y.index_add_(0, t, out * flat_w[sel, None])
    return y


def layer_weights(weights, prefix, r, names):
    """float32 copies of one layer's leaves ``prefix + name`` (indexed
    ``[r]`` when stacked)."""
    out = {}
    for n in names:
        t = weights[prefix + n]
        out[n] = (t if r is None else t[r]).float()
    return out


def lm_logits(h, weights, eps, mm):
    x = rms_norm(h, weights["final_norm.w"].float(), eps)
    return mm(x, weights["lm_head.w"].float())


def attention_scale(d: int) -> float:
    return 1.0 / math.sqrt(d)
