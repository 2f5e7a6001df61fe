"""Attention reference math: chunked flash-style prefill, cache decode,
direct attention, MLA.

PyTorch port of ``repro.models.attention``.  The GQA functions are the
model's ``kernel_backend="plain"`` path; the CUDA kernels in
``repro_torch.kernels`` compute the same masks and online softmax.  The MLA
functions (DeepSeek-V2) and ``full_attention`` (whisper's encoder and the
decoder's cross attention) have no kernel, here as in the reference, whose
callers of them reach no Pallas kernel: they are the route of that
attention under either kernel backend.

All attention math accumulates in f32.  Shapes:
  q: (B, Sq, Hq, hd)    k/v: (B, Skv, Hkv, hd)   with Hq % Hkv == 0 (GQA).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _mask_bias(pos_q, pos_kv, causal: bool, window: Optional[int],
               valid_kv=None):
    """(..., Sq, Skv) additive f32 bias from positions."""
    pq = pos_q[..., :, None]
    pk = pos_kv[..., None, :]
    shape = torch.broadcast_shapes(pq.shape, pk.shape)
    ok = ((pk >= 0) & (pk < 2 ** 29)).expand(shape)
    if causal:
        ok = ok & (pk <= pq)
    if window is not None:
        ok = ok & (pk > pq - window)
    if valid_kv is not None:
        ok = ok & valid_kv[..., None, :]
    return torch.where(ok, 0.0, NEG_INF).float()


def _attn_q_chunk(q_blk, k, v, pos_q_blk, pos_kv, *, causal, window,
                  kv_chunk, scale):
    """Online-softmax attention of one query chunk against all of k/v.

    q_blk: (B, cq, Hkv, G, hd);  k/v: (B, Skv, Hkv, hd).  Loops kv in chunks
    carrying (m, l, acc) — the flash-attention recurrence.
    """
    B, cq, Hkv, G, hd = q_blk.shape
    Skv = k.shape[1]
    qf = q_blk.float() * scale
    m = torch.full((B, Hkv, G, cq), NEG_INF, dtype=torch.float32,
                   device=q_blk.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, G, cq, hd), dtype=torch.float32,
                      device=q_blk.device)
    for s0 in range(0, Skv, kv_chunk):
        k_blk = k[:, s0:s0 + kv_chunk].float()
        v_blk = v[:, s0:s0 + kv_chunk].float()
        pk_blk = pos_kv[..., s0:s0 + kv_chunk]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k_blk)
        bias = _mask_bias(pos_q_blk, pk_blk, causal, window)  # (B?, cq, ck)
        while bias.ndim < s.ndim:
            bias = bias[..., None, :, :]
        s = s + bias
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p,
                                                   v_blk)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]  # (B, Hkv, G, cq, hd)
    return out.permute(0, 3, 1, 2, 4).to(q_blk.dtype)  # (B, cq, Hkv, G, hd)


def chunked_attention(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None, pos_q=None, pos_kv=None,
                      q_chunk: int = 512, kv_chunk: int = 512):
    """Flash-style chunked attention; memory O(cq * ck), never O(S^2).
    Returns (B, Sq, Hq, hd)."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / (hd ** 0.5)
    dev = q.device
    if pos_q is None:
        pos_q = torch.arange(Sq, device=dev)
    if pos_kv is None:
        pos_kv = torch.arange(k.shape[1], device=dev)
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, k.shape[1])
    pad_q = (-Sq) % q_chunk
    pad_kv = (-k.shape[1]) % kv_chunk
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
        pos_q = F.pad(pos_q, (0, pad_q), value=-1)
    if pad_kv:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_kv))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_kv))
        # never attended (causal) / masked
        pos_kv = F.pad(pos_kv, (0, pad_kv), value=2 ** 30)
    Sq_p = q.shape[1]
    qg = q.reshape(B, Sq_p, Hkv, G, hd)
    outs = []
    for q0 in range(0, Sq_p, q_chunk):
        outs.append(_attn_q_chunk(
            qg[:, q0:q0 + q_chunk], k, v, pos_q[..., q0:q0 + q_chunk],
            pos_kv, causal=causal, window=window, kv_chunk=kv_chunk,
            scale=scale))
    out = torch.cat(outs, dim=1).reshape(B, Sq_p, Hq, hd)
    return out[:, :Sq]


def full_attention(q, k, v, *, causal: bool = False,
                   window: Optional[int] = None, pos_q=None, pos_kv=None,
                   valid_kv=None):
    """Direct softmax attention with f32 scores, for short key sequences
    (the encoder over its frames, cross attention over the encoder's
    output); non-causal by default.  ``valid_kv`` (B, Skv) bool masks keys
    out.  Returns (B, Sq, Hq, hd) in q's dtype."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / (hd ** 0.5)
    qg = q.reshape(B, Sq, Hkv, G, hd).float() * scale
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    if causal or window is not None or valid_kv is not None:
        if pos_q is None:
            pos_q = torch.arange(Sq, device=q.device)
        if pos_kv is None:
            pos_kv = torch.arange(k.shape[1], device=q.device)
        bias = _mask_bias(pos_q, pos_kv, causal, window, valid_kv)
        while bias.ndim < s.ndim:
            bias = bias[..., None, :, :]
        s = s + bias
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, hd).to(q.dtype)


def decode_attention(q, k_cache, v_cache, pos_kv, cur_pos, *,
                     window: Optional[int] = None):
    """Single-token decode: q (B, Hq, hd) vs ring-buffer cache (B, S, Hkv, hd).

    ``pos_kv`` (B, S) holds each slot's absolute position (-1 = empty);
    ``cur_pos`` (B,) is the query's absolute position.
    """
    B, Hq, hd = q.shape
    Hkv = k_cache.shape[2]
    G = Hq // Hkv
    scale = 1.0 / (hd ** 0.5)
    qg = q.reshape(B, Hkv, G, hd).float() * scale
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float())
    bias = _decode_bias(pos_kv, cur_pos, window)[:, None, None, :]
    p = torch.softmax(s + bias, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(B, Hq, hd).to(q.dtype)


def decode_attention_partial(q, k_cache, v_cache, pos_kv, cur_pos, *,
                             window: Optional[int] = None):
    """:func:`decode_attention` over one slice of the ring, unnormalised:
    f32 m (B, Hq) (the largest masked score), l (B, Hq) (the sum of
    e^{s - m}) and acc (B, Hq, hd) (the sum of e^{s - m} v), which
    :func:`merge_partials` merges across slices (split-KV)."""
    B, Hq, hd = q.shape
    Hkv = k_cache.shape[2]
    G = Hq // Hkv
    scale = 1.0 / (hd ** 0.5)
    qg = q.reshape(B, Hkv, G, hd).float() * scale
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float())
    s = s + _decode_bias(pos_kv, cur_pos, window)[:, None, None, :]
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    acc = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return (m.reshape(B, Hq), p.sum(-1).reshape(B, Hq),
            acc.reshape(B, Hq, hd))


def merge_partials(m, l, acc):
    """Split-KV merge of partials over n slices: m, l (..., n) and acc
    (..., n, d) -> sum_s e^{m_s - m*} acc_s / sum_s e^{m_s - m*} l_s,
    m* = max_s m_s.  f32 (..., d)."""
    w = torch.exp(m - m.amax(-1, keepdim=True))
    return (w[..., None] * acc).sum(-2) / (w * l).sum(-1)[..., None]


def _decode_bias(pos_kv, cur_pos, window):
    """(B, S) additive f32 bias of a decode query at ``cur_pos`` over ring
    slots at ``pos_kv`` (-1 = empty), within ``window``."""
    cur = cur_pos[:, None]
    ok = (pos_kv >= 0) & (pos_kv <= cur)
    if window is not None:
        ok = ok & (pos_kv > cur - window)
    return torch.where(ok, 0.0, NEG_INF)


# -- MLA (DeepSeek-V2) -------------------------------------------------------
def mla_expand_kv(c_kv, p):
    """Latent -> per-head K_nope, V.  c_kv: (B, S, r)."""
    k_nope = torch.einsum("bsr,rhd->bshd", c_kv, p["w_uk"])
    v = torch.einsum("bsr,rhd->bshd", c_kv, p["w_uv"])
    return k_nope, v


def mla_prefill_attention(q_nope, q_rope, c_kv, k_rope, p, *, pos_q, pos_kv,
                          window=None, q_chunk=512, kv_chunk=512):
    """MLA attention for C > 1 tokens (the expanded form).

    q_nope: (B, S, H, dn)  q_rope: (B, S, H, dr)  c_kv: (B, Skv, r)
    k_rope: (B, Skv, 1, dr).  V's head dim (dv) is padded up to dn + dr for
    ``chunked_attention`` and the result sliced back: (B, S, H, dv)."""
    B, S, H, dn = q_nope.shape
    k_nope, v = mla_expand_kv(c_kv, p)  # (B, Skv, H, dn), (B, Skv, H, dv)
    k_rope_b = k_rope.expand(B, k_rope.shape[1], H, q_rope.shape[-1])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_b], dim=-1)
    dv, dqk = v.shape[-1], q.shape[-1]
    if dv < dqk:
        v = F.pad(v, (0, dqk - dv))
    out = chunked_attention(q, k, v, causal=True, window=window, pos_q=pos_q,
                            pos_kv=pos_kv, q_chunk=q_chunk,
                            kv_chunk=kv_chunk)
    return out[..., :dv]


def mla_decode_attention(q_nope, q_rope, c_cache, kr_cache, p, pos_kv,
                         cur_pos, *, window=None):
    """Absorbed MLA decode: scores and reads in the latent space, in f32,
    at scale 1/sqrt(dn + dr).

    q_nope: (B, H, dn)  q_rope: (B, H, dr)  c_cache: (B, S, r)
    kr_cache: (B, S, dr).  Returns the per-head context (B, H, dv).  The
    f32 copy of ``c_cache`` lives for this call only."""
    dn, dr = q_nope.shape[-1], q_rope.shape[-1]
    scale = 1.0 / ((dn + dr) ** 0.5)
    c = c_cache.float()
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope.float(), p["w_uk"].float())
    s = torch.einsum("bhr,bsr->bhs", q_lat, c)
    s = s + torch.einsum("bhd,bsd->bhs", q_rope.float(), kr_cache.float())
    s = s * scale
    s = s + _decode_bias(pos_kv, cur_pos, window)[:, None, :]
    pr = torch.softmax(s, dim=-1)
    ctx_lat = torch.einsum("bhs,bsr->bhr", pr, c)
    out = torch.einsum("bhr,rhd->bhd", ctx_lat, p["w_uv"].float())
    return out.to(q_nope.dtype)


def mla_decode_partial(q_nope, q_rope, c_cache, kr_cache, w_uk, pos_kv,
                       cur_pos, *, window=None):
    """:func:`mla_decode_attention` over one slice of the latent ring,
    unnormalised, in the latent space: f32 m, l (B, H) and acc (B, H, r)
    for :func:`merge_partials`; the merged context times ``w_uv`` is the
    output."""
    dn, dr = q_nope.shape[-1], q_rope.shape[-1]
    scale = 1.0 / ((dn + dr) ** 0.5)
    c = c_cache.float()
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope.float(), w_uk.float())
    s = torch.einsum("bhr,bsr->bhs", q_lat, c)
    s = s + torch.einsum("bhd,bsd->bhs", q_rope.float(), kr_cache.float())
    s = s * scale + _decode_bias(pos_kv, cur_pos, window)[:, None, :]
    m = s.amax(-1)
    pr = torch.exp(s - m[..., None])
    return m, pr.sum(-1), torch.einsum("bhs,bsr->bhr", pr, c)
