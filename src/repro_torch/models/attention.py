"""Attention reference math: chunked flash-style prefill and cache decode.

PyTorch port of the GQA part of ``repro.models.attention``.  These plain
functions are the model's ``kernel_backend="plain"`` path; the CUDA kernels
in ``repro_torch.kernels`` compute the same masks and online softmax.

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
    cur = cur_pos[:, None]
    ok = (pos_kv >= 0) & (pos_kv <= cur)
    if window is not None:
        ok = ok & (pos_kv > cur - window)
    bias = torch.where(ok, 0.0, NEG_INF)[:, None, None, :]
    p = torch.softmax(s + bias, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(B, Hq, hd).to(q.dtype)
