"""Plain PyTorch versions of the kernels (the allclose ground truth on the
card, and what the wrappers in ``ops`` run for CPU tensors).

Same arguments, layouts and mask semantics as the Pallas kernels
``repro.kernels.decode_attention.decode_attention``,
``repro.kernels.flash_attention.flash_attention_pool`` and
``repro.kernels.moe_gemm.moe_gemm``: for attention, int8 K/V with f32
scales, a static ``kv_limit`` on the ring extent, and a sliding window.
Deliberately naive: direct softmax in f32 over the whole (limited) ring.
Masked scores are -1e30, not -inf, as in the kernels, so a row with no valid
slot yields the (finite) mean of V, exactly like the kernels' online
softmax.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _limit(S: int, kv_limit) -> int:
    return S if kv_limit is None else max(1, min(int(kv_limit), S))


def _deq(x, scale):
    x = x.float()
    return x if scale is None else x * scale.float()[..., None]


def decode_attention(q, k_cache, v_cache, slot_pos, cur_pos, *, window=None,
                     k_scale=None, v_scale=None, kv_limit=None):
    """q: (B, Hq, hd); caches: (B, S, Hkv, hd), or int8 with ``k_scale``/
    ``v_scale`` (B, S, Hkv) f32; slot_pos: (B, S) int32; cur_pos: (B,).
    Only the first ``kv_limit`` ring slots are read.  Returns (B, Hq, hd)."""
    B, Hq, hd = q.shape
    S = _limit(k_cache.shape[1], kv_limit)
    Hkv = k_cache.shape[2]
    G = Hq // Hkv
    ks = None if k_scale is None else k_scale[:, :S]
    vs = None if v_scale is None else v_scale[:, :S]
    k = _deq(k_cache[:, :S], ks)  # (B, S, Hkv, hd)
    v = _deq(v_cache[:, :S], vs)
    qg = q.float().reshape(B, Hkv, G, hd)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k) / (hd ** 0.5)
    sp = slot_pos[:, :S]
    cur = cur_pos.reshape(B, 1)
    ok = (sp >= 0) & (sp <= cur)
    if window is not None:
        ok = ok & (sp > cur - window)
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v)
    return out.reshape(B, Hq, hd).to(q.dtype)


def flash_attention_pool(q, k, v, pos_q, pos_kv, *, window=None,
                         k_scale=None, v_scale=None, kv_limit=None):
    """q: (B, Hq, Sq, hd); k/v: (B, Hkv, Skv, hd), or int8 with scales
    (B, Hkv, Skv) f32; pos_q: (B, Sq); pos_kv: (B, Skv) int32 (-1 = empty).
    Only the first ``kv_limit`` ring slots are read.  Returns
    (B, Hq, Sq, hd)."""
    B, Hq, Sq, hd = q.shape
    Hkv = k.shape[1]
    S = _limit(k.shape[2], kv_limit)
    G = Hq // Hkv
    ks = None if k_scale is None else k_scale[:, :, :S]
    vs = None if v_scale is None else v_scale[:, :, :S]
    kf = _deq(k[:, :, :S], ks).repeat_interleave(G, dim=1)  # (B,Hq,S,hd)
    vf = _deq(v[:, :, :S], vs).repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) / (hd ** 0.5)
    pq = pos_q[:, :, None]
    pk = pos_kv[:, None, :S]
    ok = (pk >= 0) & (pk <= pq)
    if window is not None:
        ok = ok & (pk > pq - window)
    s = torch.where(ok[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def moe_gemm(x, w):
    """Grouped expert GEMM: x (E, C, d) @ w (E, d, f) -> (E, C, f), f32
    accumulation, output in x.dtype (``repro.kernels.ref.moe_gemm_ref``)."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)
