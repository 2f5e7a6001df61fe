"""The yardstick of the rooflines and of the model FLOP share: the card's
published peaks, and the operations and bytes each kernel call needs,
computed from the call's logical inputs at the ``ops.*`` boundary.

The work functions are frozen copies of ``chip_smoke.py``'s
``moe_work`` / ``decode_work`` / ``pool_work``, changed only so that the
counts that depend on the data (live rows, valid ring slots) stay on the
device: a roofline metric's file names the ``ops`` entry points it wraps
and their least-time function (``WRAPS``), each call appends a 0-d f32
tensor of its least time, and the sum is fetched once, after the profiled
span; ``share`` divides it by the device time of the metric's kernels.  Each input byte is counted
read once and each output byte written once; where the work depends on
the data, what these inputs need: the live rows of an expert GEMM and the
weights of the experts that have one, the ring slots some query sees.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core FLOP/s and HBM3 bytes/s
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def _bound(moved, ops):
    """Least time of a call, as a 0-d f32 tensor: the larger of its bytes
    over the bandwidth and its operations over the bf16 peak."""
    import torch
    return torch.maximum(moved.float() / PEAK_HBM_BYTES,
                         ops.float() / PEAK_BF16_FLOPS)


def moe_gemm_bound(x, w):
    """``ops.moe_gemm(x (E, C, d), w (E, d, f))``: the live rows of x (a
    capacity slot the dispatch left empty is all zero) and the weights of
    the experts with a live row read once, the live rows' outputs written
    once; 2 d f operations a live row."""
    E, C, d = x.shape
    f = w.shape[2]
    es = x.element_size()
    live = x[..., :8].ne(0).any(-1)  # (E, C)
    rows = live.sum()
    experts = live.any(-1).sum()
    moved = rows * d * es + experts * d * f * es + rows * f * es
    return _bound(moved, 2 * rows * d * f)


def decode_bound(q, k, v, sp, cur, *, window=None, k_scale=None,
                 kv_limit=None, **_):
    """``ops.decode_attention``: q read and the output written once, every
    slot_pos of the read extent, K/V (and scales) of the valid slots only;
    4 hd operations per (query head, valid slot)."""
    Bq, Hq, hd = q.shape
    Hkv = k.shape[2]
    S = kv_limit or k.shape[1]
    spp, c = sp[:, :S], cur[:, None]
    ok = (spp >= 0) & (spp <= c)
    if window is not None:
        ok &= spp > c - window
    n = ok.sum()
    es = k.element_size()
    moved = (q.numel() * q.element_size() * 2 + Bq * S * 4 + Bq * 4
             + n * Hkv * hd * es * 2
             + (n * Hkv * 4 * 2 if k_scale is not None else 0))
    return _bound(moved, 4 * Hq * hd * n)


def pool_bound(q, k, v, pos_q, pos_kv, *, window=None, k_scale=None,
               kv_limit=None, **_):
    """``ops.flash_attention_pool``: the valid (query, slot) pairs of the
    plain version's mask, 4 hd operations per pair and query head; q read
    and the output written once, K/V (and scales) of the slots some query
    sees, every position."""
    B, Hq, C, hd = q.shape
    Hkv = k.shape[1]
    S = kv_limit or k.shape[2]
    pq, pk = pos_q[:, :, None], pos_kv[:, None, :S]
    ok = (pk >= 0) & (pk <= pq)
    if window is not None:
        ok &= pk > pq - window
    pairs, n = ok.sum(), ok.any(1).sum()
    es = k.element_size()
    moved = (q.numel() * q.element_size() * 2 + B * S * 4 + B * C * 4
             + n * Hkv * hd * es * 2
             + (n * Hkv * 4 * 2 if k_scale is not None else 0))
    return _bound(moved, 4 * Hq * hd * pairs)


def model_flops(cfg: dict, tokens: int, ctx_pairs: int) -> float:
    """Model FLOPs of ``tokens`` processed tokens with ``ctx_pairs``
    (query, key position) pairs of attention in all: 2 x the parameters a
    token multiplies (every matrix but the embedding; the routed experts
    at top-k; the router), plus 2 (d_qk + d_v) a head a pair a layer.
    Read from the configuration file's published keys."""
    d = cfg["hidden_size"]
    L = cfg["num_hidden_layers"]
    H = cfg["num_attention_heads"]
    V = cfg["vocab_size"]
    f = cfg["moe_intermediate_size"]
    K = cfg["num_experts_per_tok"]
    E = cfg.get("num_experts") or cfg.get("n_routed_experts")
    if cfg.get("kv_lora_rank"):
        dn, dr, dv, r = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                         cfg["v_head_dim"], cfg["kv_lora_rank"])
        attn = d * H * (dn + dr) + d * (r + dr) + r * H * (dn + dv) \
            + H * dv * d
        dqk = dn + dr
        n_dense = cfg.get("first_k_dense_replace", 0)
        shared = cfg.get("n_shared_experts", 0) * f
    else:
        hd = d // H
        Hkv = cfg["num_key_value_heads"]
        attn = d * (H + 2 * Hkv) * hd + H * hd * d
        dqk = dv = hd
        n_dense = 0
        shared = cfg.get("shared_expert_intermediate_size", 0)
    dense = 3 * d * cfg.get("intermediate_size", 0)
    moe = 3 * d * f * K + 3 * d * shared + d * E
    per_tok = L * attn + n_dense * dense + (L - n_dense) * moe + d * V
    return 2.0 * per_tok * tokens + 2.0 * (dqk + dv) * H * L * ctx_pairs


def share(r, metric: str, kernel_names):
    """A roofline metric's reading: the summed least time of the calls its
    ``WRAPS`` recorded in the profiled span, over the device time of the
    kernels whose names contain one of ``kernel_names``, in %; None where
    the run has nothing to read."""
    p, bound = r.profile, r.work_s.get(metric)
    if not p or not bound:
        return None
    t = sum(v for n, v in p["by_name"].items()
            if any(k in n for k in kernel_names))
    return 100.0 * bound / t if t > 0 else None
