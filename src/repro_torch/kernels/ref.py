"""Plain PyTorch versions of the kernels (the allclose ground truth on the
card, and what the wrappers in ``ops`` run for CPU tensors).

Same arguments, layouts and mask semantics as the Pallas kernels
``repro.kernels.decode_attention.decode_attention``,
``repro.kernels.flash_attention.flash_attention_pool``,
``repro.kernels.flash_attention.flash_attention`` (with its gradient),
``repro.kernels.moe_gemm.moe_gemm``, ``repro.kernels.rglru_scan.rglru_scan``
and ``repro.kernels.rwkv6_scan.rwkv6_scan`` (with ``ops.rwkv6_apply``'s
initial state): for attention, int8 K/V with f32 scales, a static
``kv_limit`` on the ring extent, and a sliding window.  Deliberately naive:
direct softmax in f32 over the whole (limited) ring, and the recurrences one
timestep at a time (``repro.kernels.ref``'s oracles).  Masked scores are
-1e30, not -inf, as in the kernels, so a row with no valid slot yields the
(finite) mean of V, exactly like the kernels' online softmax.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _limit(S: int, kv_limit) -> int:
    return S if kv_limit is None else max(1, min(int(kv_limit), S))


def _deq(x, scale):
    x = x.float()
    return x if scale is None else x * scale.float()[..., None]


def _decode_scores(q, k_cache, v_cache, slot_pos, cur_pos, window,
                   k_scale, v_scale, kv_limit):
    """Scaled f32 scores (B, Hkv, G, S) of the first S = ``kv_limit`` slots,
    masked to -1e30, and the dequantised f32 V (B, S, Hkv, hd)."""
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
    return torch.where(ok[:, None, None, :], s, NEG_INF), v


def decode_attention(q, k_cache, v_cache, slot_pos, cur_pos, *, window=None,
                     k_scale=None, v_scale=None, kv_limit=None):
    """q: (B, Hq, hd); caches: (B, S, Hkv, hd), or int8 with ``k_scale``/
    ``v_scale`` (B, S, Hkv) f32; slot_pos: (B, S) int32; cur_pos: (B,).
    Only the first ``kv_limit`` ring slots are read.  Returns (B, Hq, hd)."""
    s, v = _decode_scores(q, k_cache, v_cache, slot_pos, cur_pos, window,
                          k_scale, v_scale, kv_limit)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v)
    return out.reshape(q.shape).to(q.dtype)


def split_bounds(S: int, n_split: int, tile: int):
    """The slot ranges [lo, hi) of the decode kernel's splits: the first S
    slots as T = ceil(S / tile) tiles, split z taking tiles [z T / n,
    (z + 1) T / n), so each of the n <= T splits holds at least one tile and
    together they cover [0, S) exactly."""
    T = -(-S // tile)
    if not 1 <= n_split <= T:
        raise ValueError(f"{n_split} splits of {T} tiles of {tile} slots")
    return [(min(S, z * T // n_split * tile),
             min(S, (z + 1) * T // n_split * tile)) for z in range(n_split)]


def decode_attention_partials(q, k_cache, v_cache, slot_pos, cur_pos, *,
                              n_split, tile=64, window=None, k_scale=None,
                              v_scale=None, kv_limit=None):
    """What the split decode kernel writes for ``n_split`` > 1: per query
    head and split (``split_bounds``), the split's max scaled score m
    (masked slots count as -1e30), l = sum_j e^{s_j - m} and the
    unnormalised acc = sum_j e^{s_j - m} v_j.  Returns f32 m, l (B, Hq,
    n_split) and acc (B, Hq, n_split, hd); ``merge_partials`` turns them
    into ``decode_attention``'s output."""
    B, Hq, hd = q.shape
    s, v = _decode_scores(q, k_cache, v_cache, slot_pos, cur_pos, window,
                          k_scale, v_scale, kv_limit)
    ms, ls, accs = [], [], []
    for lo, hi in split_bounds(s.shape[-1], n_split, tile):
        part = s[..., lo:hi]
        m = part.amax(-1)
        p = torch.exp(part - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhgs,bshd->bhgd", p, v[:, lo:hi]))
    return (torch.stack(ms, -1).reshape(B, Hq, n_split),
            torch.stack(ls, -1).reshape(B, Hq, n_split),
            torch.stack(accs, -2).reshape(B, Hq, n_split, hd))


def merge_partials(m, l, acc):
    """The merge kernel: out = sum_s e^{m_s - m*} acc_s / sum_s e^{m_s - m*}
    l_s, m* = max_s m_s.  m, l (B, Hq, n); acc (B, Hq, n, hd).  Returns f32
    (B, Hq, hd)."""
    w = torch.exp(m - m.amax(-1, keepdim=True))
    return (w[..., None] * acc).sum(-2) / (w * l).sum(-1)[..., None]


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


def _flash_scores(q, k, causal, window):
    """Scaled f32 scores (B, Hq, Sq, Skv) of q (B, Hq, Sq, hd) against K
    (B, Hkv, Skv, hd), masked to -1e30, and the validity mask (Sq, Skv).
    Query i and key j sit at positions pos_base + i and pos_base + j, so
    the offset cancels in the masks."""
    B, Hq, Sq, hd = q.shape
    Skv = k.shape[2]
    G = Hq // k.shape[1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                     k.float().repeat_interleave(G, dim=1)) / (hd ** 0.5)
    i = torch.arange(Sq, device=q.device)[:, None]
    j = torch.arange(Skv, device=q.device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (j <= i)
    if window is not None:
        ok = ok & (j > i - window)
    return torch.where(ok, s, NEG_INF), ok


def flash_attention_lse(q, k, v, *, causal=True, window=None, pos_base=0):
    """Contiguous GQA attention by a direct softmax
    (``repro.kernels.ref.flash_attention_ref``), and the f32 log-sum-exp of
    each query's scaled scores (B, Hq, Sq), from which the backward
    recomputes P.  q (B, Hq, Sq, hd); k/v (B, Hkv, Skv, hd); Sq may differ
    from Skv.  Returns (out (B, Hq, Sq, hd) in q.dtype, lse)."""
    s, _ = _flash_scores(q, k, causal, window)
    G = q.shape[1] // k.shape[1]
    out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1),
                       v.float().repeat_interleave(G, dim=1))
    return out.to(q.dtype), torch.logsumexp(s, dim=-1)


def flash_attention(q, k, v, *, causal=True, window=None, pos_base=0):
    """``flash_attention_lse``'s output alone."""
    return flash_attention_lse(q, k, v, causal=causal, window=window)[0]


def flash_attention_bwd(q, k, v, out, lse, d_out, *, causal=True,
                        window=None):
    """The gradient of ``flash_attention`` written out, without autograd,
    as the oracle of the backward kernel: P = exp(scale q K^T - lse) on
    valid pairs (0 off them), dV = P^T dO, dS = P o (dO V^T - delta) with
    delta = rowsum(dO o out), dK = scale dS^T q and dV summed over the G
    query heads of a kv head, dQ = scale dS K.  Returns (dq, dk, dv) in the
    dtypes of q, k and v."""
    B, Hq, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / hd ** 0.5
    s, ok = _flash_scores(q, k, causal, window)
    p = torch.where(ok, torch.exp(s - lse.float()[..., None]), 0.0)
    dof = d_out.float()
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    delta = (dof * out.float()).sum(-1)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf) - delta[..., None])
    dq = scale * torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = scale * torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dk = dk.reshape(B, Hkv, G, Skv, hd).sum(2)
    dv = dv.reshape(B, Hkv, G, Skv, hd).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def moe_gemm(x, w):
    """Grouped expert GEMM: x (E, C, d) @ w (E, d, f) -> (E, C, f), f32
    accumulation, output in x.dtype (``repro.kernels.ref.moe_gemm_ref``)."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def rglru_scan(x, a_log, gate, h0):
    """Per-timestep RG-LRU (``repro.kernels.ref.rglru_scan_ref``):
    ``h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (gate_t x_t)``, ``a = exp(a_log)``.
    x/gate: (B, S, W); a_log: (B, S, W) f32; h0: (B, W) f32.  Returns
    (h (B, S, W) in x.dtype, h_final (B, W) f32)."""
    a = torch.exp(a_log.float())
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 0.0)) * (gate.float()
                                                         * x.float())
    h = h0.float()
    hs = []
    for t in range(x.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(x.dtype), h


def rwkv6_scan(r, k, v, w_log, u, state0=None):
    """Per-timestep WKV6 (``repro.kernels.ref.rwkv6_scan_ref``, from
    ``state0`` as ``repro.kernels.ops.rwkv6_apply`` folds it in):
    ``o_t = r_t (S + diag(u) k_t^T v_t)``, ``S <- diag(e^{w_t}) S + k_t^T
    v_t``.  r/k/v/w_log: (..., S, D); u: (..., 1, D), broadcast over the
    leading axes; state0: (..., D, D) f32 or None (zeros).  Returns (out
    (..., S, D) in r.dtype, final state (..., D, D) f32)."""
    lead, (S, D) = r.shape[:-2], r.shape[-2:]
    rf, kf, vf, wf = r.float(), k.float(), v.float(), w_log.float()
    uf = u.float().expand(lead + (1, D))[..., 0, :]
    st = torch.zeros(lead + (D, D), dtype=torch.float32, device=r.device) \
        if state0 is None else state0.float()
    outs = []
    for t in range(S):
        kv = kf[..., t, :, None] * vf[..., t, None, :]
        outs.append(torch.einsum("...d,...de->...e", rf[..., t, :],
                                 st + uf[..., :, None] * kv))
        st = st * torch.exp(wf[..., t, :])[..., None] + kv
    return torch.stack(outs, dim=-2).to(r.dtype), st
