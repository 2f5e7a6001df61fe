"""Recurrent sequence mixers: RWKV-6 (Finch) and RG-LRU (Griffin).

PyTorch port of ``repro.models.ssm``: serving (prefill chunks and decode
steps against a slot-pool cache) and training (whole sequences from zero
state).  ``kernel_backend="plain"`` runs
the reference's model math: the RG-LRU recurrence as a log-depth scan over
the ``(a, b)`` pairs (what ``jax.lax.associative_scan`` computes) and WKV6
in the stable pairwise log-space form, chunks of 32, with single-step forms
for decode.  ``"cuda"`` sends the recurrence of every call, prefill chunk
or C == 1 step, to the CUDA kernels ``ops.rglru_scan`` and
``ops.rwkv6_scan``, with the state in and the state out.

States are read from the layer's cache views and written back in place,
only into active rows (``store_rows``): a bound but inactive row (mid
prefill, or preempted) keeps its state, as the reference's
``kvcache.select_rows`` keeps it.  States are carried in f32.

With ``st=None`` each block takes the reference's training form: the whole
sequence from zero state (zero token shifts, zero WKV state, ``h0 = 0`` and
zero conv history), always on the plain scans, whatever the kernel backend
(the kernels have no backward), and writes no state, so nothing that
autograd tracks is changed in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.params import P
from repro_torch.models.sharding import (constrain_rows, heads_spec,
                                         is_dtensor, local_call, local_rows,
                                         merge_heads, split_heads)


def store_rows(buf: torch.Tensor, new: torch.Tensor, active) -> None:
    """Write ``new`` into the state view ``buf`` in place; with an
    ``active`` (B,) mask, only the active rows change.  A sharded state
    (a DTensor, sharded on batch only) is written by each rank into its
    own rows."""
    if is_dtensor(buf):
        with torch.no_grad():  # a state is never differentiated
            store_rows(buf.to_local(), local_rows(new, buf),
                       None if active is None else local_rows(active, buf))
        return
    new = new.to(buf.dtype)
    if active is not None:
        m = active.reshape((-1,) + (1,) * (new.ndim - 1))
        new = torch.where(m, new, buf)
    buf.copy_(new)


# =============================== RWKV-6 =====================================
def rwkv6_chunk(r, k, v, w_log, u, state):
    """One chunk of the WKV6 recurrence.

    r/k/v: (B,H,C,D)   w_log: (B,H,C,D) = log of data-dependent decay (<0)
    u: (H,D) bonus     state: (B,H,D,D) f32 (k-dim x v-dim)
    Returns (out (B,H,C,D), new_state).
    """
    rf, kf, vf = r.float(), k.float(), v.float()
    wf = w_log.float()
    L = torch.cumsum(wf, dim=2)  # inclusive
    L_prev = L - wf  # exclusive
    # inter-chunk: o_t += (r_t * exp(L_{t-1})) @ S0
    o = torch.einsum("bhtd,bhde->bhte", rf * torch.exp(L_prev), state)
    # intra-chunk (pairwise, stable):
    # P[t,s] = sum_i r[t,i] k[s,i] e^{L[t-1,i]-L[s,i]}
    ratio = torch.exp(L_prev[:, :, :, None, :] - L[:, :, None, :, :])
    P = torch.einsum("bhtd,bhsd,bhtsd->bhts", rf, kf, ratio)
    C = r.shape[2]
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    P = torch.where(mask, P, 0.0)
    # diagonal bonus term: s == t weighted by u
    diag = torch.einsum("bhtd,hd->bht", rf * kf, u.float())
    idx = torch.arange(C, device=r.device)
    P[..., idx, idx] = diag
    o = o + torch.einsum("bhts,bhse->bhte", P, vf)
    # state update: S_C = diag(e^{L_C}) S0 + sum_s (k_s e^{L_C - L_s}) v_s^T
    last = L[:, :, -1:, :]
    k_dec = kf * torch.exp(last - L)  # ratios <= 1
    new_state = state * torch.exp(last).squeeze(2)[..., None] + \
        torch.einsum("bhtd,bhte->bhde", k_dec, vf)
    return o.to(r.dtype), new_state


def rwkv6_scan_chunked(r, k, v, w_log, u, state, chunk: int = 32):
    """Full-sequence WKV6 over chunks.  r/k/v/w_log: (B,H,S,D); returns
    (out (B,H,S,D), final_state).  A ragged last chunk is padded with
    k = v = 0 and w_log = 0 (decay 1), which leaves the state unchanged."""
    S = r.shape[2]
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        r, k, v, w_log = (F.pad(t, (0, 0, 0, pad)) for t in (r, k, v, w_log))
    outs = []
    for c0 in range(0, S + pad, chunk):
        sl = slice(c0, c0 + chunk)
        o, state = rwkv6_chunk(r[:, :, sl], k[:, :, sl], v[:, :, sl],
                               w_log[:, :, sl], u, state)
        outs.append(o)
    return torch.cat(outs, dim=2)[:, :, :S], state


def rwkv6_step(r, k, v, w_log, u, state):
    """Single-token WKV6.  r/k/v/w_log: (B,H,D); state: (B,H,D,D)."""
    rf, kf, vf = r.float(), k.float(), v.float()
    kv = kf[..., None] * vf[..., None, :]
    out = torch.einsum("bhd,bhde->bhe", rf,
                       state + u.float()[None, :, :, None] * kv)
    new_state = state * torch.exp(w_log.float())[..., None] + kv
    return out.to(r.dtype), new_state


def _token_shift(x, shift):
    """The previous token's activation at every position: ``shift`` (the
    last token of the previous call) then ``x[:, :-1]``."""
    return torch.cat([shift[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def rwkv6_block(x, p, cfg, st, ctx):
    """RWKV6 time-mix (token shift, ddlerp decay, WKV, group norm, gate,
    out) of a (B, S, d) chunk against layer state ``st`` (``shift_tm``,
    ``wkv``), which it advances in place.  S == 1 is a decode step;
    ``st=None`` the training form (chunked WKV at ``ctx["ssm_chunk"]`` from
    zero state)."""
    D = cfg.ssm_head_dim
    d = cfg.d_model
    H = d // D
    B, S, _ = x.shape
    train = st is None
    prev = _token_shift(x, x.new_zeros((B, d)) if train else st["shift_tm"])

    def mix(mu):
        return x + (prev - x) * mu  # lerp toward previous token

    xr, xk, xv, xg, xw = (mix(p[f"mu_{n}"]) for n in ("r", "k", "v", "g",
                                                      "w"))
    r = xr @ p["wr"]
    k = xk @ p["wk"]
    v = xv @ p["wv"]
    g = F.silu(xg @ p["wg"])
    # data-dependent decay (the Finch contribution): low-rank ddlerp
    w_dd = torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]
    w_log = -torch.exp(torch.clamp((p["w0"] + w_dd).float(), -8.0, 1.0))

    def hsplit(t):  # (B, S, d) -> (B, H, S, D), a strided view
        return split_heads(t, H, D, ctx).transpose(1, 2)

    r_, k_, v_, wl_ = hsplit(r), hsplit(k), hsplit(v), hsplit(w_log)
    chunk = ctx["ssm_chunk"]
    cuda = ctx["kernel_backend"] == "cuda"

    def wkv(r_, k_, v_, wl_, u, s0):  # one rank's rows and heads
        if s0 is None:
            s0 = torch.zeros(r_.shape[:2] + (D, D), dtype=torch.float32,
                             device=r_.device)
        if train or (not cuda and S > 1):
            return rwkv6_scan_chunked(r_, k_, v_, wl_, u, s0, chunk=chunk)
        if cuda:
            return kops.rwkv6_scan(r_, k_, v_, wl_, u[:, None], state0=s0)
        o_, s_ = rwkv6_step(r_[:, :, 0], k_[:, :, 0], v_[:, :, 0],
                            wl_[:, :, 0], u, s0)
        return o_[:, :, None], s_

    hs = heads_spec(ctx, H, dim=1)  # (B, H, ...): rows and heads
    o, new_state = local_call(
        ctx, wkv, (r_, k_, v_, wl_, p["u"], None if train else st["wkv"]),
        (hs, hs, hs, hs, P(hs[1], None), hs), (hs, hs))
    if not train:
        active = ctx.get("active")
        store_rows(st["wkv"], new_state, active)
        store_rows(st["shift_tm"], x[:, -1], active)
    # per-head group norm
    o32 = o.transpose(1, 2).float()  # (B, S, H, D)
    o32 = (o32 - o32.mean(-1, keepdim=True)) * torch.rsqrt(
        o32.var(-1, unbiased=False, keepdim=True) + 1e-5)
    o = (merge_heads(o32, ctx) * p["ln_w"].float()
         + p["ln_b"].float()).to(x.dtype)
    return (o * g) @ p["wo"]


def rwkv6_channel_mix(x, p, st, ctx):
    """RWKV channel-mix FFN of a (B, S, d) chunk with its own token shift
    (``shift_cm``, advanced in place; ``st=None``: from a zero shift)."""
    if st is None:
        prev = _token_shift(x, x.new_zeros((x.shape[0], x.shape[2])))
    else:
        prev = _token_shift(x, st["shift_cm"])
    xk = x + (prev - x) * p["mu"]
    k = torch.square(torch.relu(xk @ p["wk_cm"]))
    kv = k @ p["wv_cm"]
    r = torch.sigmoid(xk @ p["wr_cm"])
    if st is not None:
        store_rows(st["shift_cm"], x[:, -1], ctx.get("active"))
    return r * kv


# =============================== RG-LRU =====================================
def rglru_scan(x, a_log, gate_i):
    """Linear recurrence as a log-depth (Hillis-Steele) scan.

    x: (B,S,W)  a_log: (B,S,W) log decay (<0)  gate_i: (B,S,W) input gate.
    h_t = a_t h_{t-1} + sqrt(1-a_t^2) * (i_t * x_t) from h_{-1} = 0; returns
    (h (B,S,W) f32, cumulative decay a_1...a_t (B,S,W) f32), as the
    reference's associative scan of ``(a1, b1) o (a2, b2) = (a1 a2,
    a2 b1 + b2)``, in ceil(log2 S) elementwise passes."""
    al = a_log.float()
    a = torch.exp(al)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * al), 0.0)) * (
        gate_i.float() * x.float())
    S = x.shape[1]
    off = 1
    while off < S:
        a_prev, b_prev = a[:, :-off], b[:, :-off]
        a_cur, b_cur = a[:, off:], b[:, off:]
        b = torch.cat([b[:, :off], a_cur * b_prev + b_cur], dim=1)
        a = torch.cat([a[:, :off], a_cur * a_prev], dim=1)
        off *= 2
    return b, a


def rglru_block(x, p, cfg, st, ctx):
    """Griffin recurrent block (in-proj, causal depthwise conv, RG-LRU,
    gate) of a (B, S, d) chunk against layer state ``st`` (``h`` f32,
    ``conv`` the last cw-1 conv inputs), which it advances in place.
    S == 1 is a decode step; ``st=None`` the training form (from ``h0 = 0``
    and zero conv history)."""
    cw = cfg.conv1d_width
    B, S, _ = x.shape
    xb = x @ p["w_x"]
    gb = x @ p["w_gate"]
    train = st is None
    if train:
        W = xb.shape[-1]
        h0 = torch.zeros((B, W), dtype=torch.float32, device=x.device)
        conv_buf = xb.new_zeros((B, cw - 1, W))
    else:
        h0, conv_buf = st["h"], st["conv"].to(xb.dtype)
    # causal depthwise conv over time (width cw), history from the buffer
    hist = torch.cat([conv_buf, xb], dim=1)  # (B,S+cw-1,W)
    conv = sum(hist[:, i:i + S, :] * p["conv_w"][cw - 1 - i]
               for i in range(cw))
    conv = conv + p["conv_b"]
    # gates (sharded: conv whole over its channels before the products
    # that shard theirs)
    conv = constrain_rows(conv, ctx)
    r_gate = torch.sigmoid(conv @ p["w_a"] + p["b_a"])
    i_gate = torch.sigmoid(conv @ p["w_i"] + p["b_i"])
    a_log = -8.0 * F.softplus(p["lam"].float()) * r_gate.float()  # < 0
    if train:
        hs, a_cum = rglru_scan(conv, a_log, i_gate)
        h_seq = hs + a_cum * h0[:, None, :]  # the reference's form
    elif ctx["kernel_backend"] == "cuda":
        h_seq, new_h = kops.rglru_scan(conv, a_log, i_gate, h0)
    elif S == 1:
        a = torch.exp(a_log[:, 0])
        beta = torch.sqrt(torch.clamp_min(1.0 - a * a, 0.0))
        new_h = a * h0 + beta * (i_gate[:, 0].float() * conv[:, 0].float())
        h_seq = new_h[:, None, :]
    else:
        hs, a_cum = rglru_scan(conv, a_log, i_gate)
        h_seq = hs + a_cum * h0[:, None, :]  # fold the initial state in
        new_h = h_seq[:, -1, :]
    if not train:
        active = ctx.get("active")
        store_rows(st["h"], new_h, active)
        if cw > 1:
            store_rows(st["conv"], hist[:, -(cw - 1):, :], active)
    y = h_seq.to(x.dtype) * F.gelu(gb, approximate="tanh")
    return y @ p["w_out"]
