"""Attention-family decoder: init, prefill/extend, masked slot-pool decode.

PyTorch port of the serving half of ``repro.models.transformer`` for GQA
decoders with a dense or MoE FFN (the llama and qwen2-moe families).  One
code path (``extend``) covers chunked prefill (C tokens against an existing
cache) and decode (C == 1).

Differences from the reference, all forced by the frameworks:

* The reference returns a new cache from every call and relies on buffer
  donation to make that in place.  Here the cache tensors are updated in
  place and the same dict is returned.
* ``jax.lax.scan`` over the stacked ``blocks`` becomes a Python loop over
  repeats, and the scan of ``decode_run`` a loop that keeps tokens on the
  device.
* A masked decode step writes the new K/V, ``slot_pos`` and ``pos`` only
  into active rows, where the reference writes every row and then restores
  the inactive ones with ``kvcache.select_rows``: an in-place write into a
  bound but inactive row (mid-prefill, or preempted) would corrupt it.

``kernel_backend`` mirrors the reference's ``"xla" | "pallas"`` knob as
``"plain" | "cuda"``.  ``"cuda"`` (the default) sends attention and the MoE
expert products through ``repro_torch.kernels.ops``, whose wrappers launch
the CUDA kernels on CUDA tensors and fall to their plain versions only for
CPU tensors; ``"plain"`` runs ``models.attention`` and ``torch.einsum``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import kvcache
from repro_torch.models.attention import chunked_attention, decode_attention
from repro_torch.models.layers import (apply_rope, embed_tokens, lm_logits,
                                       mlp, rms_norm)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.params import to_module

KERNEL_BACKENDS = ("plain", "cuda")


# ============================ layout helpers ================================
def layout(cfg):
    """(head_kinds, pattern, repeats, tail_kinds)."""
    head = tuple("attn" for _ in range(cfg.first_k_dense_layers))
    if cfg.layer_pattern:
        pattern, repeats, tail = (tuple(cfg.layer_pattern), cfg.pattern_repeats,
                                  tuple(cfg.tail_pattern))
    else:
        kind = cfg.block_kind(cfg.first_k_dense_layers) \
            if cfg.num_layers > cfg.first_k_dense_layers else "attn"
        pattern = (kind,)
        repeats = cfg.num_layers - len(head)
        tail = ()
    assert len(head) + len(pattern) * repeats + len(tail) == cfg.num_layers, \
        (cfg.name, len(head), pattern, repeats, tail)
    return head, pattern, repeats, tail


def check_supported(cfg) -> None:
    """The port covers GQA decoders with a dense or an all-MoE FFN so far;
    every other family raises, naming the ROADMAP.md item that ports it."""
    if cfg.is_encoder_decoder or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and vision forms are not ported yet "
            "(ROADMAP.md queue 1, item 10)")
    if cfg.use_mla:
        raise NotImplementedError(
            f"{cfg.name}: MLA attention is not ported yet "
            "(ROADMAP.md queue 1, item 8)")
    if cfg.is_moe and cfg.first_k_dense_layers:
        raise NotImplementedError(
            f"{cfg.name}: dense head layers before the MoE trunk are not "
            "ported yet (ROADMAP.md queue 1, item 8)")
    head, pattern, _, tail = layout(cfg)
    if head or tail or any(k != "attn" for k in pattern):
        raise NotImplementedError(
            f"{cfg.name}: RG-LRU / RWKV6 blocks are not ported yet "
            "(ROADMAP.md queue 1, item 8)")


# ============================ initialization ================================
def _normal(gen, shape, std, dtype, device):
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * std).to(dtype)


def _stacked(gen, R, shape, std, dtype, device):
    """A (R,) + shape leaf drawn one repeat at a time, so the f32 staging
    buffer stays one layer's leaf."""
    w = torch.empty((R,) + shape, dtype=dtype, device=device)
    for r in range(R):
        w[r] = _normal(gen, shape, std, dtype, device)
    return w


def _init_ffn(cfg, R, gen, dtype, device, d_ff):
    d = cfg.d_model
    out_std = 0.02 / (2 * cfg.num_layers) ** 0.5
    ffn = {"w1": _stacked(gen, R, (d, d_ff), 0.02, dtype, device),
           "w2": _stacked(gen, R, (d_ff, d), out_std, dtype, device)}
    if cfg.mlp_gated:
        ffn["wg"] = _stacked(gen, R, (d, d_ff), 0.02, dtype, device)
    return ffn


def _init_moe(cfg, R, gen, dtype, device):
    """Router (f32 whatever ``dtype``), experts stacked (R, E, ...), and the
    shared experts fused into one gated MLP of ``num_shared_experts *
    moe_d_ff`` (``repro.models.transformer._init_moe``'s scales)."""
    d, E, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    out_std = 0.02 / (2 * cfg.num_layers) ** 0.5
    experts = {"w1": _stacked(gen, R, (E, d, f), 0.02, dtype, device),
               "w2": _stacked(gen, R, (E, f, d), out_std, dtype, device)}
    if cfg.mlp_gated:
        experts["wg"] = _stacked(gen, R, (E, d, f), 0.02, dtype, device)
    p = {"router": _stacked(gen, R, (d, E), 0.02, torch.float32, device),
         "experts": experts}
    if cfg.num_shared_experts:
        p["shared"] = _init_ffn(cfg, R, gen, dtype, device,
                                cfg.num_shared_experts * cfg.moe_d_ff)
    return p


def _init_layer(cfg, R, gen, dtype, device):
    """One stacked attention block: every leaf has a leading repeats axis."""
    d = cfg.d_model
    Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    std = 0.02
    out_std = 0.02 / (2 * cfg.num_layers) ** 0.5

    def stacked(shape, s):
        return _stacked(gen, R, shape, s, dtype, device)

    ones = lambda: torch.ones((R, d), dtype=dtype, device=device)
    attn = {"wq": stacked((d, Hq * hd), std),
            "wk": stacked((d, Hkv * hd), std),
            "wv": stacked((d, Hkv * hd), std),
            "wo": stacked((Hq * hd, d), out_std)}
    if cfg.qkv_bias:
        for n, width in (("bq", Hq * hd), ("bk", Hkv * hd), ("bv", Hkv * hd)):
            attn[n] = torch.zeros((R, width), dtype=dtype, device=device)
    p = {"norm1": {"w": ones()}, "norm2": {"w": ones()}, "attn": attn}
    if cfg.is_moe:
        p["moe"] = _init_moe(cfg, R, gen, dtype, device)
    else:
        p["ffn"] = _init_ffn(cfg, R, gen, dtype, device, cfg.d_ff)
    return p


def init_params(cfg, seed: int = 0, dtype=torch.bfloat16, device=None):
    """Random weights at the reference's init scales (std 0.02; output
    projections 0.02 / sqrt(2 L)), drawn from a ``torch.Generator`` on
    ``device`` seeded with ``seed``.  The draws differ from JAX's: tests that
    compare the two frameworks carry JAX's weights across with
    ``params.from_jax_params`` instead.  Returns an ``nn.Module`` whose
    ``state_dict`` keys are the reference's tree paths.

    ``device=None`` means ``"cuda"`` and raises when no GPU is visible, as
    the engine does: the CPU is used only when asked for."""
    check_supported(cfg)
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_params draws on CUDA by default and no GPU "
                           "is visible; pass device='cpu' to use the CPU")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    _, pattern, repeats, _ = layout(cfg)
    d = cfg.d_model
    tree = {"embed": {"w": _normal(gen, (cfg.vocab_size, d), 0.02, dtype,
                                   device)},
            "final_norm": {"w": torch.ones((d,), dtype=dtype,
                                           device=device)}}
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"w": _normal(gen, (d, cfg.vocab_size), 0.02,
                                        dtype, device)}
    tree["blocks"] = {str(pi): _init_layer(cfg, repeats, gen, dtype, device)
                      for pi in range(len(pattern))}
    return to_module(tree)


# ============================ block application =============================
def _attn_mix_extend(cfg, ap, x, st, ctx):
    """Self-attention of a C-token chunk against one layer's ring cache.

    Writes the chunk's K/V into the cache (in place) first, then attends with
    position masks; C == 1 uses the single-token decode path."""
    B, C, d = x.shape
    window = ctx.get("window") or cfg.sliding_window
    pos = ctx["pos"]  # (B, C) int32 absolute positions
    active = ctx.get("active")  # (B,) bool or None (every row writes)
    alloc = st["slot_pos"].shape[1]
    n = min(C, alloc)
    slots = (pos[:, C - n:] % alloc).long()  # chunk tail -> ring slots
    bidx = torch.arange(B, device=x.device)[:, None]

    def write(buf, val):
        val = val[:, C - n:].to(buf.dtype)
        if active is not None:
            keep = buf[bidx, slots]
            m = active.reshape((B, 1) + (1,) * (val.ndim - 2))
            val = torch.where(m, val, keep)
        buf[bidx, slots] = val

    Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ ap["wq"]
    k = x @ ap["wk"]
    v = x @ ap["wv"]
    if cfg.qkv_bias:
        q, k, v = q + ap["bq"], k + ap["bk"], v + ap["bv"]
    q = apply_rope(q.reshape(B, C, Hq, hd), pos, cfg.rope_theta)
    k = apply_rope(k.reshape(B, C, Hkv, hd), pos, cfg.rope_theta)
    v = v.reshape(B, C, Hkv, hd)
    quant = "k_scale" in st
    if quant:
        qk, ks = kvcache.quantize_kv(k)
        qv, vs = kvcache.quantize_kv(v)
        write(st["k"], qk)
        write(st["v"], qv)
        write(st["k_scale"], ks)
        write(st["v_scale"], vs)
    else:
        write(st["k"], k)
        write(st["v"], v)
    write(st["slot_pos"], pos)
    cuda = ctx["kernel_backend"] == "cuda"
    if C == 1:
        if cuda:
            out = kops.decode_attention(
                q[:, 0], st["k"], st["v"], st["slot_pos"], pos[:, 0],
                window=window, k_scale=st.get("k_scale"),
                v_scale=st.get("v_scale"))[:, None]
        else:
            k_r, v_r = st["k"], st["v"]
            if quant:
                k_r = kvcache.dequantize_kv(k_r, st["k_scale"], k.dtype)
                v_r = kvcache.dequantize_kv(v_r, st["v_scale"], v.dtype)
            out = decode_attention(q[:, 0], k_r, v_r, st["slot_pos"],
                                   pos[:, 0], window=window)[:, None]
    elif cuda:
        # (B, C, H, hd) -> (B, H, C, hd) are free strided views here
        out = kops.flash_attention_pool(
            q.transpose(1, 2), st["k"].transpose(1, 2),
            st["v"].transpose(1, 2), pos, st["slot_pos"], window=window,
            k_scale=st["k_scale"].transpose(1, 2) if quant else None,
            v_scale=st["v_scale"].transpose(1, 2) if quant else None)
        out = out.transpose(1, 2)
    else:
        kk, vv = st["k"], st["v"]
        if quant:
            kk = kvcache.dequantize_kv(kk, st["k_scale"], k.dtype)
            vv = kvcache.dequantize_kv(vv, st["v_scale"], v.dtype)
        out = chunked_attention(q, kk, vv, causal=True, window=window,
                                pos_q=pos, pos_kv=st["slot_pos"],
                                q_chunk=ctx["q_chunk"],
                                kv_chunk=ctx["kv_chunk"])
    return out.reshape(B, C, Hq * hd) @ ap["wo"]


def _ffn_apply(cfg, lp, x, ctx):
    """FFN / MoE sublayer on (B, C, d).  A decode step (C == 1, as the
    reference's ``extend`` sets its mode) is dropless, capacity B; a
    prefill chunk uses ``moe_ffn``'s capacity factor, 1.25 (the
    reference's default).  The MoE aux loss is dropped, as the reference's
    ``extend`` drops it."""
    if "moe" not in lp:
        return mlp(x, lp["ffn"], cfg.mlp_gated)
    B, C, d = x.shape
    y, _ = moe_ffn(x.reshape(B * C, d), lp["moe"], cfg,
                   capacity_override=B * C if C == 1 else 0,
                   kernel_backend=ctx["kernel_backend"])
    return y.reshape(B, C, d)


def apply_block(cfg, lp, x, st, ctx):
    """One residual attention block over (B, C, d); ``st`` is updated in
    place."""
    h = rms_norm(x, lp["norm1"]["w"], cfg.norm_eps)
    x = x + _attn_mix_extend(cfg, lp["attn"], h, st, ctx)
    h2 = rms_norm(x, lp["norm2"]["w"], cfg.norm_eps)
    return x + _ffn_apply(cfg, lp, h2, ctx)


def _at(tree, r):
    """Per-repeat views ``leaf[r]`` of a stacked (params or cache) tree."""
    if isinstance(tree, torch.Tensor):
        return tree[r]
    return {k: _at(tree[k], r) for k in tree.keys()}


def layer_views(cfg, params):
    """Per-layer parameter views in execution order: (pattern index,
    repeat, tree of views).  Built once per call so a fused decode run
    indexes the stacked weights once, not once per step."""
    _, pattern, repeats, _ = layout(cfg)
    return [(pi, r, _at(params["blocks"][str(pi)], r))
            for r in range(repeats) for pi in range(len(pattern))]


def _run_trunk(cfg, layers, x, cache, ctx):
    for pi, r, lp in layers:
        st = _at(cache["blocks"][str(pi)], r)
        x = apply_block(cfg, lp, x, st, ctx)
    return x


# ============================ public entry points ===========================
def init_cache(cfg, params, batch, max_len, dtype=torch.bfloat16, *,
               window=None, kv_dtype=None, device=None):
    """Fresh decode state.  ``kv_dtype="int8"`` builds a quantized ring
    (int8 payload + f32 ``k_scale``/``v_scale``); ``None``/"bf16" keeps the
    plain ``dtype`` ring.  ``device`` defaults to the parameters' device."""
    check_supported(cfg)
    if device is None:
        device = params["embed"]["w"].device
    _, pattern, repeats, _ = layout(cfg)
    kv_dtype = None if kv_dtype == "bf16" else kv_dtype

    def stacked(kind):
        st = kvcache.init_layer_state(cfg, kind, batch, max_len, dtype,
                                      window=window, kv_dtype=kv_dtype,
                                      device=device)
        return {n: x[None].repeat((repeats,) + (1,) * x.ndim)
                for n, x in st.items()}
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=device),
            "head": (),
            "blocks": {str(pi): stacked(kind)
                       for pi, kind in enumerate(pattern)},
            "tail": ()}


def _check_backend(kernel_backend):
    if kernel_backend not in KERNEL_BACKENDS:
        raise ValueError(f"kernel_backend must be one of {KERNEL_BACKENDS}: "
                         f"{kernel_backend!r}")


def _extend(cfg, params, cache, tokens, *, window=None, q_chunk=512,
            kv_chunk=512, kernel_backend="cuda", active=None, layers=None):
    _check_backend(kernel_backend)
    B, C = tokens.shape
    x = embed_tokens(tokens, params["embed"]["w"])
    pos = cache["pos"][:, None] + torch.arange(
        C, dtype=torch.int32, device=tokens.device)[None, :]
    ctx = {"pos": pos, "window": window, "q_chunk": q_chunk,
           "kv_chunk": kv_chunk, "kernel_backend": kernel_backend,
           "active": active}
    layers = layer_views(cfg, params) if layers is None else layers
    x = _run_trunk(cfg, layers, x, cache, ctx)
    if active is None:
        cache["pos"] += C
    else:
        cache["pos"] += active.to(torch.int32) * C
    x_last = rms_norm(x[:, -1, :], params["final_norm"]["w"], cfg.norm_eps)
    return lm_logits(x_last, params)


def extend(cfg, params, cache, tokens, *, window=None, q_chunk=512,
           kv_chunk=512, kernel_backend="cuda"):
    """Process a chunk of C tokens against the cache (C == 1 => decode
    step).  tokens: (B, C) int.  Updates ``cache`` in place and returns
    (logits_last (B, V), cache)."""
    logits = _extend(cfg, params, cache, tokens, window=window,
                     q_chunk=q_chunk, kv_chunk=kv_chunk,
                     kernel_backend=kernel_backend)
    return logits, cache


def extend_row(cfg, params, pool, tokens, slot: int, kv_limit=None,
               full_alloc=None, **kw):
    """Chunked prefill straight into batch row ``slot`` of a slot-pool cache
    (DESIGN.md §7).  The row view and its ``kv_limit`` ring prefix are views
    of the pool, so the chunk's K/V land in the live row exactly once.

    tokens: (1, C).  Returns (logits_last (1, V), pool)."""
    one = kvcache.read_row(pool, slot)
    start = one["pos"][0].clone()  # the row's position before the chunk
    view = one if kv_limit is None else \
        kvcache.truncate_rings(one, kv_limit, full_alloc)
    logits, view = extend(cfg, params, view, tokens, **kw)
    return logits, kvcache.write_row_slice(pool, view, slot, start,
                                           tokens.shape[1])


def decode_step(cfg, params, cache, tokens, active, kv_limit=None,
                full_alloc=None, **kw):
    """One masked decode iteration over a slot-pool cache (DESIGN.md §3).

    tokens: (B,) last token per slot; active: (B,) bool.  All B rows are
    computed, but rows with ``active == False`` keep their K/V, slot
    positions and ``pos``.  ``kv_limit`` bounds every active row's live
    prefix (``kvcache.truncate_rings``).  Returns (next_tokens (B,) int32,
    logits (B, V), cache)."""
    view = cache if kv_limit is None else \
        kvcache.truncate_rings(cache, kv_limit, full_alloc)
    logits = _extend(cfg, params, view, tokens[:, None], active=active, **kw)
    nxt = logits.argmax(-1).to(torch.int32)
    if kv_limit is not None:
        cache = kvcache.untruncate_rings(cache, view, kv_limit, full_alloc)
    return nxt, logits, cache


def decode_run(cfg, params, cache, tokens, active, n_steps: int,
               kv_limit=None, full_alloc=None, **kw):
    """``n_steps`` fused masked decode iterations (DESIGN.md §6): the tokens
    and the greedy feedback stay on the device, and the ``(n_steps, B)``
    token block is returned for one host fetch at the boundary.  The
    ``kv_limit`` view is taken once for the whole run, so it must cover the
    run's end.  Returns (token_block (n_steps, B), final_tokens (B,),
    cache)."""
    view = cache if kv_limit is None else \
        kvcache.truncate_rings(cache, kv_limit, full_alloc)
    layers = layer_views(cfg, params)
    toks = tokens
    block = []
    for _ in range(int(n_steps)):
        logits = _extend(cfg, params, view, toks[:, None], active=active,
                         layers=layers, **kw)
        nxt = logits.argmax(-1).to(torch.int32)
        toks = torch.where(active, nxt, toks)
        block.append(nxt)
    if kv_limit is not None:
        cache = kvcache.untruncate_rings(cache, view, kv_limit, full_alloc)
    return torch.stack(block), toks, cache


__all__ = ["layout", "check_supported", "init_params", "init_cache",
           "extend", "extend_row", "decode_step", "decode_run",
           "layer_views", "KERNEL_BACKENDS"]
