"""Decoder trunk: init, training forward, prefill/extend, masked slot-pool
decode.

PyTorch port of ``repro.models.transformer``.  Serving covers the
attention family (GQA decoders with a dense or MoE FFN: llama, qwen2-moe;
MLA with dense head layers before an MoE trunk: deepseek-v2), the hybrid
RG-LRU + local attention family (recurrentgemma) and the attention-free
RWKV6 family.  One code path (``extend``) covers chunked prefill (C tokens
against an existing cache) and decode (C == 1).  The cacheless training
``forward`` covers the same families (dense or MoE attention, MLA, RG-LRU
hybrids, RWKV6) with the MoE aux loss summed over the layers.  Layers run
in the reference's order: the unrolled ``head``, the repeated ``blocks``
pattern, then the unrolled ``tail``.

The model entry points also take the reference's two frontend forms,
whose embeddings come from a stub (``frontend_emb``): the encoder-decoder
form (whisper: a bidirectional ``encode``r over the frames, and cross
attention in every decoder layer over its output, whose K/V ``init_cache``
computes once per layer) and the vision-prefix form (llava: the patch
embeddings ``prepend_frontend``-ed to the prompt's token embeddings).  The
real serving backends refuse both, as the reference's do.

Differences from the reference, all forced by the frameworks:

* The reference returns a new cache from every call and relies on buffer
  donation to make that in place.  Here the cache tensors are updated in
  place and the same dict is returned.
* ``jax.lax.scan`` over the stacked ``blocks`` becomes a Python loop over
  repeats, and the scan of ``decode_run`` a loop that keeps tokens on the
  device.
* A masked decode step writes the new K/V, ``slot_pos``, recurrent state
  (``h``, ``conv``, ``wkv``, the token shifts) and ``pos`` only into active
  rows, where the reference writes every row and then restores the
  inactive ones with ``kvcache.select_rows``: an in-place write into a
  bound but inactive row (mid-prefill, or preempted) would corrupt it.

``kernel_backend`` mirrors the reference's ``"xla" | "pallas"`` knob as
``"plain" | "cuda"``.  ``"cuda"`` (the default) sends attention (in
training the differentiable ``ops.flash_attention_train``, whose backward
is a kernel too), and in serving the MoE expert products and the RG-LRU /
WKV6 recurrences, through ``repro_torch.kernels.ops``, whose wrappers
launch the CUDA kernels on CUDA tensors and fall to their plain versions
only for CPU tensors; ``"plain"`` runs ``models.attention`` (differentiated
by autograd in training), ``torch.einsum`` and ``models.ssm``'s scans.
Training runs the expert products and the scans on the plain path under
either backend (``check_trainable``).  MLA attention has no kernel (the
reference's XLA path is its only one): it runs ``models.attention``'s MLA
functions under either backend, in serving and in training.  Neither has
the encoder's self-attention nor the decoder's cross attention: both run
``models.attention.full_attention`` under either backend, as the
reference's reach no Pallas kernel.

``forward``, ``prefill`` and ``extend`` take the reference's
``batch_axes`` (the mesh axes the batch is sharded over) and ``tp_axis``
(the tensor-parallel axis) for a sharded program on a ``DeviceMesh``: the
parameters are DTensors (``params.param_shardings``), and a sharded cache
comes from ``init_cache(..., mesh=)`` (``params.cache_pspecs``).  The
ops between the layouts below run on DTensor, which propagates their
sharding as GSPMD does in the reference:

* The reference's constraints become redistributions to its specs
  (``_constrain``, ``_constrain_heads``, ``_expand_kv``,
  ``_constrain_cache_seq``), each the identity on a plain tensor and when
  its axes are ``None``, so the unsharded path does not change.  They
  constrain the gradient too (``sharding.redistribute_to``), as
  ``with_sharding_constraint`` constrains the cotangent.
* Each layer's weights are gathered over the data axes for its forward
  (FSDP, ``sharding.unshard``), their model-axis sharding kept.
* Attention, plain or through the kernels, and the WKV scan run on each
  rank's own rows and, under ``tp_axis``, heads (``sharding.local_call``,
  ``local_map``); a decode step under ``tp_axis`` is split-KV over the
  sequence-sharded ring, each model rank's partial softmax merged.
* A sharded call runs under ``implicit_replication()``: the tensors the
  model makes itself (positions, RoPE tables, masks, zero states, the
  MoE's dispatch indices) are the same on every rank, so they enter as
  replicated rather than each being built on the mesh.

Under ``tp_axis`` attention takes the plain path whatever
``kernel_backend`` says (the reference's Pallas kernels are
single-device); under ``batch_axes`` alone the attention kernels run on
each rank's rows, and the expert products and the scans take the plain
path.  A sharded call whose parameters are not DTensors raises.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.kernels import ops as kops
from repro_torch.models import kvcache
from repro_torch.models.attention import (chunked_attention, decode_attention,
                                          decode_attention_partial,
                                          full_attention, merge_partials,
                                          mla_decode_attention,
                                          mla_decode_partial,
                                          mla_prefill_attention)
from repro_torch.models.layers import (apply_rope, embed_tokens, lm_logits,
                                       mlp, rms_norm)
from repro_torch.models.moe import moe_capacity, moe_ffn, moe_routed
from repro_torch.models.params import (P, batch_pspec, cache_pspecs,
                                       param_placements, to_module)
from repro_torch.models.sharding import (axis_index, axis_size,
                                         constrain_rows, heads_spec,
                                         is_dtensor, local_call, local_rows,
                                         merge_heads, mesh_axes,
                                         redistribute_to, replicated,
                                         rows_spec, sharded_mesh,
                                         split_heads, unshard)
from repro_torch.models.ssm import (rglru_block, rwkv6_block,
                                    rwkv6_channel_mix)

KERNEL_BACKENDS = ("plain", "cuda")
LAYER_KINDS = ("attn", "rglru", "rwkv6")


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
    """The port covers models built of attention (GQA or MLA; a dense or
    MoE FFN, dense head layers before an MoE trunk), RG-LRU and RWKV6
    layers, with the encoder-decoder and vision-prefix forms; a layer kind
    the reference has no block for raises."""
    head, pattern, _, tail = layout(cfg)
    unknown = set(head + pattern + tail) - set(LAYER_KINDS)
    if unknown:
        raise NotImplementedError(
            f"{cfg.name}: no port of {sorted(unknown)} layers (the "
            "reference has none either)")


# ============================ initialization ================================
def _normal(gen, shape, std, dtype, device):
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * std).to(dtype)


def _stacked(gen, R, shape, std, dtype, device):
    """A (R,) + shape leaf drawn one repeat at a time, so the f32 staging
    buffer stays one layer's leaf; ``R=None`` draws one unrolled layer's
    ``shape`` leaf."""
    if R is None:
        return _normal(gen, shape, std, dtype, device)
    w = torch.empty((R,) + shape, dtype=dtype, device=device)
    for r in range(R):
        w[r] = _normal(gen, shape, std, dtype, device)
    return w


def _full(R, shape, value, dtype, device):
    return torch.full(((R,) if R is not None else ()) + shape, value,
                      dtype=dtype, device=device)


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


def _init_attn(cfg, R, gen, dtype, device, cross=False):
    """Self-attention's projections and, with ``cross``, the cross
    attention's ``xq``/``xk``/``xv``/``xo``
    (``repro.models.transformer._init_attn``)."""
    d = cfg.d_model
    Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    out_std = 0.02 / (2 * cfg.num_layers) ** 0.5
    if cfg.use_mla:
        dn, dr, dv, r = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                         cfg.v_head_dim, cfg.kv_lora_rank)
        return {"w_q": _stacked(gen, R, (d, Hq * (dn + dr)), 0.02, dtype,
                                device),
                "w_dkv": _stacked(gen, R, (d, r), 0.02, dtype, device),
                "w_krope": _stacked(gen, R, (d, dr), 0.02, dtype, device),
                "w_uk": _stacked(gen, R, (r, Hq, dn), 0.02, dtype, device),
                "w_uv": _stacked(gen, R, (r, Hq, dv), 0.02, dtype, device),
                "wo": _stacked(gen, R, (Hq * dv, d), out_std, dtype, device),
                "kv_norm": _full(R, (r,), 1.0, dtype, device)}
    attn = {"wq": _stacked(gen, R, (d, Hq * hd), 0.02, dtype, device),
            "wk": _stacked(gen, R, (d, Hkv * hd), 0.02, dtype, device),
            "wv": _stacked(gen, R, (d, Hkv * hd), 0.02, dtype, device),
            "wo": _stacked(gen, R, (Hq * hd, d), out_std, dtype, device)}
    if cfg.qkv_bias:
        for n, width in (("bq", Hq * hd), ("bk", Hkv * hd), ("bv", Hkv * hd)):
            attn[n] = _full(R, (width,), 0.0, dtype, device)
    if cross:
        for n, shape in (("xq", (d, Hq * hd)), ("xk", (d, Hkv * hd)),
                         ("xv", (d, Hkv * hd))):
            attn[n] = _stacked(gen, R, shape, 0.02, dtype, device)
        attn["xo"] = _stacked(gen, R, (Hq * hd, d), out_std, dtype, device)
    return attn


def _init_rwkv6(cfg, R, gen, dtype, device):
    """Time mix with its channel mix (``cm``) inside, at
    ``repro.models.transformer._init_rwkv6``'s scales; ``w0`` is f32."""
    d, D, lora_r = cfg.d_model, cfg.ssm_head_dim, 64
    out_std = 0.02 / (2 * cfg.num_layers) ** 0.5

    def nrm(shape, std=0.02):
        return _stacked(gen, R, shape, std, dtype, device)

    p = {"wr": nrm((d, d)), "wk": nrm((d, d)), "wv": nrm((d, d)),
         "wg": nrm((d, d)), "wo": nrm((d, d), out_std),
         # base decay ~ e^{-e^{0.5}}
         "w0": _full(R, (d,), 0.5, torch.float32, device),
         "w_lora_a": nrm((d, lora_r)), "w_lora_b": nrm((lora_r, d)),
         "u": nrm((d // D, D)),
         "ln_w": _full(R, (d,), 1.0, dtype, device),
         "ln_b": _full(R, (d,), 0.0, dtype, device)}
    for n in ("r", "k", "v", "g", "w"):
        p[f"mu_{n}"] = _full(R, (d,), 0.5, dtype, device)
    p["cm"] = {"mu": _full(R, (d,), 0.5, dtype, device),
               "wk_cm": nrm((d, cfg.d_ff)),
               "wv_cm": nrm((cfg.d_ff, d), out_std),
               "wr_cm": nrm((d, d))}
    return p


def _init_rglru(cfg, R, gen, dtype, device):
    """``repro.models.transformer._init_rglru``'s scales; ``lam`` is f32
    (softplus(0.2) ~ 0.8: decay exp(-8 * 0.8 * sigmoid))."""
    d, W, cw = cfg.d_model, cfg.lru_width, cfg.conv1d_width
    out_std = 0.02 / (2 * cfg.num_layers) ** 0.5

    def nrm(shape, std=0.02):
        return _stacked(gen, R, shape, std, dtype, device)

    return {"w_x": nrm((d, W)), "w_gate": nrm((d, W)),
            "conv_w": nrm((cw, W)), "conv_b": _full(R, (W,), 0.0, dtype,
                                                    device),
            "w_a": nrm((W, W)), "b_a": _full(R, (W,), 0.0, dtype, device),
            "w_i": nrm((W, W)), "b_i": _full(R, (W,), 0.0, dtype, device),
            "lam": _full(R, (W,), 0.2, torch.float32, device),
            "w_out": nrm((W, d), out_std)}


def _init_layer(cfg, kind, R, gen, dtype, device, dense_head=False,
                cross=False):
    """One block of ``kind``: with a leading repeats axis of R (stacked
    ``blocks``), or unrolled (``R=None``: ``head`` and ``tail``).  A
    ``dense_head`` layer (one of the first ``first_k_dense_layers``) has a
    dense FFN, of ``dense_d_ff`` in an MoE config.  A ``cross`` attention
    layer (an encoder-decoder's decoder) adds cross attention and its
    pre-norm ``norm_x``."""
    d = cfg.d_model
    p = {"norm1": {"w": _full(R, (d,), 1.0, dtype, device)},
         "norm2": {"w": _full(R, (d,), 1.0, dtype, device)}}
    if kind == "attn":
        p["attn"] = _init_attn(cfg, R, gen, dtype, device, cross)
        if cross:
            p["norm_x"] = {"w": _full(R, (d,), 1.0, dtype, device)}
    elif kind == "rglru":
        p["rg"] = _init_rglru(cfg, R, gen, dtype, device)
    else:  # rwkv6: its FFN is the channel mix inside "tm"
        p["tm"] = _init_rwkv6(cfg, R, gen, dtype, device)
        return p
    if cfg.is_moe and not dense_head:
        p["moe"] = _init_moe(cfg, R, gen, dtype, device)
    else:
        p["ffn"] = _init_ffn(cfg, R, gen, dtype, device,
                             cfg.dense_d_ff if cfg.is_moe else cfg.d_ff)
    return p


def init_params(cfg, seed: int = 0, dtype=torch.bfloat16, device=None):
    """Random weights at the reference's init scales (std 0.02; output
    projections 0.02 / sqrt(2 L)), drawn from a ``torch.Generator`` on
    ``device`` seeded with ``seed``, one layer's leaf at a time.  An
    encoder-decoder config adds cross attention to every decoder layer and
    the stacked ``encoder``; a frontend whose ``frontend_dim`` is not
    ``d_model`` adds ``frontend_proj``.  The draws differ from JAX's: tests that
    compare the two frameworks carry JAX's weights across with
    ``params.from_jax_params`` instead.  Returns an ``nn.Module`` whose
    ``state_dict`` keys are the reference's tree paths.

    ``device=None`` means ``"cuda"`` and raises when no GPU is visible, as
    the engine does: the CPU is used only when asked for.  On
    ``device="meta"`` the leaves have shapes and dtypes only (the dry
    run's parameters)."""
    check_supported(cfg)
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_params draws on CUDA by default and no GPU "
                           "is visible; pass device='cpu' to use the CPU")
    gen = None  # meta tensors have shapes only: nothing is drawn
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
    head, pattern, repeats, tail = layout(cfg)
    d = cfg.d_model
    tree = {"embed": {"w": _normal(gen, (cfg.vocab_size, d), 0.02, dtype,
                                   device)},
            "final_norm": {"w": torch.ones((d,), dtype=dtype,
                                           device=device)}}
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"w": _normal(gen, (d, cfg.vocab_size), 0.02,
                                        dtype, device)}
    cross = cfg.is_encoder_decoder
    # the unrolled sections under str(i), as from_jax_params names them;
    # an empty one adds no key
    for sec, kinds in (("head", head), ("tail", tail)):
        if kinds:
            tree[sec] = {str(i): _init_layer(cfg, kind, None, gen, dtype,
                                             device,
                                             dense_head=sec == "head",
                                             cross=cross)
                         for i, kind in enumerate(kinds)}
    tree["blocks"] = {str(pi): _init_layer(cfg, kind, repeats, gen, dtype,
                                           device, cross=cross)
                      for pi, kind in enumerate(pattern)}
    if cross:
        tree["encoder"] = _init_layer(cfg, "attn", cfg.num_encoder_layers,
                                      gen, dtype, device)
    if cfg.frontend != "none" and cfg.frontend_dim != d:
        tree["frontend_proj"] = {"w": _normal(gen, (cfg.frontend_dim, d),
                                              0.02, dtype, device)}
    return to_module(tree)


# ============================ sharding ======================================
def _shard_kw(ctx, mesh, batch_axes, tp_axis, kernel_backend):
    """The sharding keys of ``ctx``: the mesh and axes, and which path
    attention takes (``attn_backend``).  Unsharded, attention follows
    ``kernel_backend``.  Sharded: attention kernels only under
    ``batch_axes`` alone, and the other kernels' paths plain."""
    ctx.update(mesh=mesh, batch_axes=batch_axes, tp_axis=tp_axis,
               attn_backend=kernel_backend)
    if mesh is not None:
        ctx["kernel_backend"] = "plain"
        if tp_axis:
            ctx["attn_backend"] = "plain"
    return ctx


def _constrain(x, ctx):
    """Pin the residual stream's batch dim to the data axes (DTensor, as
    GSPMD, can otherwise drop batch sharding and replicate activations);
    the logits too, whole over the vocabulary, for the loss and the
    argmax."""
    ax = ctx.get("batch_axes")
    if not ax:
        return x
    return redistribute_to(x, P(ax, *([None] * (x.ndim - 1))))


def _constrain_heads(t, ctx):
    """Shard (B, S, H, hd) attention tensors: batch over data axes, heads
    over the model axis.  Keeps the score contraction (over hd) local."""
    tp = ctx.get("tp_axis")
    if not tp:
        return t
    return redistribute_to(t, P(ctx.get("batch_axes"), None, tp, None))


def _expand_kv(k, G):
    """GQA -> MHA expansion (``jnp.repeat`` over the head axis) so the head
    axis is cleanly shardable on the plain path (the kernels do grouped
    GQA natively instead)."""
    if G == 1:
        return k
    B, S, H, hd = k.shape
    return k[:, :, :, None, :].expand(B, S, H, G, hd).reshape(B, S, H * G,
                                                              hd)


def _constrain_cache_seq(t, ctx, seq_axis=1):
    """Sequence-shard a decode cache read over the model axis (split-KV):
    each model rank scores its S/TP slice for all heads instead of
    gathering the whole cache per layer per step."""
    tp = ctx.get("tp_axis")
    if not tp:
        return t
    spec = [None] * t.ndim
    spec[0] = ctx.get("batch_axes")
    spec[seq_axis] = tp
    return redistribute_to(t, P(*spec))


def _embed(tokens, w, ctx):
    """The token embeddings; sharded, through ``F.embedding`` on the
    tokens' rows, whose DTensor rule (a vocabulary-sharded table's masked
    partial lookup, and its backward) every release has, where an indexed
    gather's backward (an indexed write) has none in some."""
    if ctx.get("mesh") is None:
        return embed_tokens(tokens, w)
    if not is_dtensor(tokens):  # the same batch on every rank: its rows
        from torch.distributed.tensor import distribute_tensor
        tokens = distribute_tensor(
            tokens, ctx["mesh"], param_placements(rows_spec(ctx, 2),
                                                  ctx["mesh"]),
            src_data_rank=None)
    return constrain_rows(torch.nn.functional.embedding(tokens.long(), w),
                          ctx)


def _top(params, ctx):
    """The embedding, final norm and LM head, unsharded for the call."""
    return unshard({k: params[k] for k in ("embed", "final_norm", "lm_head",
                                            "frontend_proj")
                     if k in params}, ctx)


_DOTS = None


def _dots_policy(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.checkpoint_dots``: keep the matmul
    outputs, recompute the rest."""
    global _DOTS
    if _DOTS is None:
        aten = torch.ops.aten
        _DOTS = {aten.mm.default, aten.bmm.default, aten.addmm.default}
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else \
        CheckpointPolicy.PREFER_RECOMPUTE


# ============================ block application =============================
def _mla_project(cfg, ap, x, pos, ctx):
    """MLA's projections of (B, S, d) at positions ``pos``: q split into
    its no-RoPE and RoPE parts (B, S, H, dn), (B, S, H, dr), the normed
    latent (B, S, r) and the shared RoPE key (B, S, 1, dr)."""
    B, S, _ = x.shape
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = split_heads(x @ ap["w_q"], cfg.num_heads, dn + dr, ctx)
    q_rope = apply_rope(q[..., dn:], pos, cfg.rope_theta)
    c_kv = rms_norm(x @ ap["w_dkv"], ap["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope((x @ ap["w_krope"])[:, :, None, :], pos,
                        cfg.rope_theta)
    return q[..., :dn], q_rope, c_kv, k_rope


def _attn_mix_extend(cfg, ap, x, st, ctx):
    """Self-attention of a C-token chunk against one layer's ring cache.

    Writes the chunk's K/V (MLA: its latent and RoPE key) into the cache
    (in place) first, then attends with position masks; C == 1 uses the
    single-token decode path (MLA: the absorbed form)."""
    B, C, d = x.shape
    window = ctx.get("window") or cfg.sliding_window
    pos = ctx["pos"]  # (B, C) int32 absolute positions
    active = ctx.get("active")  # (B,) bool or None (every row writes)
    alloc = st["slot_pos"].shape[1]
    n = min(C, alloc)
    slots = (pos[:, C - n:] % alloc).long()  # chunk tail -> ring slots
    bidx = torch.arange(B, device=x.device)[:, None]

    def write(buf, val):
        val = val[:, C - n:]
        idx, sl, act = bidx, slots, active
        if is_dtensor(buf):  # a sharded ring: each rank writes its rows
            with torch.no_grad():  # a cache is never differentiated
                val, sl = local_rows(val, buf), local_rows(slots, buf)
                act = None if active is None else local_rows(active, buf)
                buf = buf.to_local()
                idx = torch.arange(buf.shape[0], device=buf.device)[:, None]
                _write_rows(buf, idx, sl, val, act)
            return
        _write_rows(buf, idx, sl, val, act)

    if cfg.use_mla:
        q_nope, q_rope, c_kv, k_rope = _mla_project(cfg, ap, x, pos, ctx)
        write(st["c"], c_kv)
        write(st["kr"], k_rope[:, :, 0])
        write(st["slot_pos"], pos)
        if C == 1:
            out = _mla_decode(cfg, ctx, ap, q_nope[:, 0], q_rope[:, 0], st,
                              pos[:, 0], window)[:, None]
        else:
            out = _mla_prefill(cfg, ctx, ap, q_nope, q_rope, st["c"],
                               st["kr"][:, :, None], pos, st["slot_pos"],
                               window)
        return merge_heads(out, ctx) @ ap["wo"]
    Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ ap["wq"]
    k = x @ ap["wk"]
    v = x @ ap["wv"]
    if cfg.qkv_bias:
        q, k, v = q + ap["bq"], k + ap["bk"], v + ap["bv"]
    q = apply_rope(split_heads(q, Hq, hd, ctx), pos, cfg.rope_theta)
    k = apply_rope(split_heads(k, Hkv, hd, ctx), pos, cfg.rope_theta)
    v = split_heads(v, Hkv, hd, ctx)
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
    R = functools.partial(rows_spec, ctx)
    if ctx["attn_backend"] == "cuda":  # the kernels, on each rank's rows
        if C == 1:
            out = local_call(
                ctx, lambda q_, k_, v_, sp, cur, ks, vs: kops.decode_attention(
                    q_, k_, v_, sp, cur, window=window, k_scale=ks,
                    v_scale=vs),
                (q[:, 0], st["k"], st["v"], st["slot_pos"], pos[:, 0],
                 st.get("k_scale"), st.get("v_scale")),
                (R(3), R(4), R(4), R(2), R(1), R(3), R(3)), R(3))[:, None]
        else:
            # (B, C, H, hd) -> (B, H, C, hd) are free strided views here
            out = local_call(
                ctx, lambda q_, k_, v_, pq, pk, ks, vs:
                    kops.flash_attention_pool(q_, k_, v_, pq, pk,
                                              window=window, k_scale=ks,
                                              v_scale=vs),
                (q.transpose(1, 2), st["k"].transpose(1, 2),
                 st["v"].transpose(1, 2), pos, st["slot_pos"],
                 st["k_scale"].transpose(1, 2) if quant else None,
                 st["v_scale"].transpose(1, 2) if quant else None),
                (R(4), R(4), R(4), R(2), R(2), R(3), R(3)),
                R(4)).transpose(1, 2)
        return merge_heads(out, ctx) @ ap["wo"]
    kk, vv = st["k"], st["v"]
    if quant:
        kk = kvcache.dequantize_kv(kk, st["k_scale"], k.dtype)
        vv = kvcache.dequantize_kv(vv, st["v_scale"], v.dtype)
    if C == 1:
        out = _decode_plain(ctx, q[:, 0], kk, vv, st["slot_pos"], pos[:, 0],
                            window)[:, None]
    else:
        out = _attend_plain(ctx, q, kk, vv, pos, st["slot_pos"], window)
    return merge_heads(out, ctx) @ ap["wo"]


def _attend_plain(ctx, q, k, v, pos_q, pos_kv, window):
    """``chunked_attention`` (causal, windowed) of q (B, S, Hq, hd) over
    K/V (B, Skv, Hkv, hd) at positions ``pos_q`` / ``pos_kv``; sharded,
    on each rank's rows and, under ``tp_axis``, its heads: K/V expanded to
    Hq heads (``_expand_kv``) and each model rank attending with its slice
    of them, the output laid out as ``_constrain_heads`` lays it.  Where
    the model axis does not divide Hq (40 heads over 16), the heads are
    padded with zeros to a multiple of it, as GSPMD pads an uneven dim, and
    the pad is gathered and sliced off after."""
    Hq, Hkv = q.shape[2], k.shape[2]
    R2, R4 = rows_spec(ctx, 2), rows_spec(ctx, 4)

    def attend(q_, k_, v_, pq, pk):
        return chunked_attention(q_, k_, v_, causal=True, window=window,
                                 pos_q=pq, pos_kv=pk, q_chunk=ctx["q_chunk"],
                                 kv_chunk=ctx["kv_chunk"])
    tp = ctx.get("tp_axis")
    if not tp:
        return local_call(ctx, attend, (q, k, v, pos_q, pos_kv),
                          (R4, R4, R4, R2, R2), R4)
    r, n = axis_index(ctx, tp)
    h = -(-Hq // n)  # heads a model rank, the last ranks' padded

    def part(q_, k_, v_, pq, pk):
        k_, v_ = _expand_kv(k_, Hq // Hkv), _expand_kv(v_, Hq // Hkv)
        if h * n > Hq:
            q_, k_, v_ = (torch.nn.functional.pad(t, (0, 0, 0, h * n - Hq))
                          for t in (q_, k_, v_))
        sl = slice(r * h, (r + 1) * h)
        return attend(q_[:, :, sl], k_[:, :, sl], v_[:, :, sl], pq, pk)
    # whole heads in, each rank's gradient a part: a partial sum over tp
    out = local_call(ctx, part, (q, k, v, pos_q, pos_kv),
                     (R4, R4, R4, R2, R2),
                     P(ctx.get("batch_axes"), None, tp, None),
                     grad_partial=((tp,), (tp,), (tp,), (), ()))
    if h * n == Hq:
        return _constrain_heads(out, ctx)
    return _constrain(out, ctx)[:, :, :Hq]


def _decode_plain(ctx, q, k, v, pos_kv, cur, window):
    """``decode_attention`` of q (B, Hq, hd) over the ring; sharded, on
    each rank's rows, and under ``tp_axis`` split-KV: the ring
    sequence-sharded over the model axis (``_constrain_cache_seq``), each
    model rank's partial softmax merged across the axis."""
    R = functools.partial(rows_spec, ctx)
    if not ctx.get("tp_axis"):
        return local_call(
            ctx, lambda q_, k_, v_, sp, c: decode_attention(
                q_, k_, v_, sp, c, window=window),
            (q, k, v, pos_kv, cur), (R(3), R(4), R(4), R(2), R(1)), R(3))
    k, v, pos_kv = (_constrain_cache_seq(t, ctx) for t in (k, v, pos_kv))
    tp = ctx["tp_axis"]
    S4, S2 = P(ctx.get("batch_axes"), tp, None, None), \
        P(ctx.get("batch_axes"), tp)
    split = P(ctx.get("batch_axes"), None, tp)

    def part(q_, k_, v_, sp, c):
        m, l, acc = decode_attention_partial(q_, k_, v_, sp, c,
                                             window=window)
        return m[..., None], l[..., None], acc[:, :, None]
    m, l, acc = local_call(ctx, part, (q, k, v, pos_kv, cur),
                            (R(3), S4, S4, S2, R(1)),
                            (split, split, P(*split, None)))
    return merge_partials(m, l, acc).to(q.dtype)


def _mla_prefill(cfg, ctx, ap, q_nope, q_rope, c, kr, pos_q, pos_kv, window):
    """``mla_prefill_attention``; sharded, on each rank's rows and, under
    ``tp_axis``, its heads (``w_uk`` / ``w_uv`` by heads, the latent
    whole)."""
    H = heads_spec(ctx, cfg.num_heads)
    W = P(None, H[2], None)
    return local_call(
        ctx, lambda qn, qr, c_, kr_, wk, wv, pq, pk: mla_prefill_attention(
            qn, qr, c_, kr_, {"w_uk": wk, "w_uv": wv}, pos_q=pq, pos_kv=pk,
            window=window, q_chunk=ctx["q_chunk"],
            kv_chunk=ctx["kv_chunk"]),
        (q_nope, q_rope, c, kr, ap["w_uk"], ap["w_uv"], pos_q, pos_kv),
        (H, H, rows_spec(ctx, 3), rows_spec(ctx, 4), W, W, rows_spec(ctx, 2),
         rows_spec(ctx, 2)), H)


def _mla_decode(cfg, ctx, ap, q_nope, q_rope, st, cur, window):
    """``mla_decode_attention`` (absorbed); sharded, on each rank's rows,
    and under ``tp_axis`` split-KV over the sequence-sharded latent ring,
    as the reference's ``_constrain_cache_seq`` lays it out."""
    R = functools.partial(rows_spec, ctx)
    if not ctx.get("tp_axis"):
        return local_call(
            ctx, lambda qn, qr, c_, kr_, wk, wv, sp, c: mla_decode_attention(
                qn, qr, c_, kr_, {"w_uk": wk, "w_uv": wv}, sp, c,
                window=window),
            (q_nope, q_rope, st["c"], st["kr"], ap["w_uk"], ap["w_uv"],
             st["slot_pos"], cur),
            (R(3), R(3), R(3), R(3), P(None, None, None),
             P(None, None, None), R(2), R(1)), R(3))
    c, kr, sp = (_constrain_cache_seq(st[n], ctx)
                 for n in ("c", "kr", "slot_pos"))
    tp = ctx["tp_axis"]
    b = ctx.get("batch_axes")
    split = P(b, None, tp)

    def part(qn, qr, c_, kr_, wk, sp_, cur_):
        m, l, acc = mla_decode_partial(qn, qr, c_, kr_, wk, sp_, cur_,
                                       window=window)
        return m[..., None], l[..., None], acc[:, :, None]
    m, l, acc = local_call(
        ctx, part, (q_nope, q_rope, c, kr, ap["w_uk"], sp, cur),
        (R(3), R(3), P(b, tp, None), P(b, tp, None), P(None, None, None),
         P(b, tp), R(1)), (split, split, P(*split, None)))
    ctx_lat = merge_partials(m, l, acc)
    return torch.einsum("bhr,rhd->bhd", ctx_lat,
                        ap["w_uv"].float()).to(q_nope.dtype)


def _write_rows(buf, idx, slots, val, active):
    """``buf[idx, slots] = val`` in place, only into ``active`` rows."""
    val = val.to(buf.dtype)
    if active is not None:
        keep = buf[idx, slots]
        m = active.reshape((-1, 1) + (1,) * (val.ndim - 2))
        val = torch.where(m, val, keep)
    buf[idx, slots] = val


def _cross_attn(cfg, ap, x, st, ctx):
    """Encoder-decoder cross attention of (B, C, d) over the encoder's
    output: its K/V from the layer's state (``xk``/``xv``, computed by
    ``init_cache``) when ``st`` has them, else projected from
    ``ctx["enc_out"]`` (training).  Plain ``full_attention``, non-causal,
    under either kernel backend."""
    B, C, _ = x.shape
    Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = split_heads(x @ ap["xq"], Hq, hd, ctx)
    if st is not None and "xk" in st:
        xk, xv = st["xk"], st["xv"]
    else:
        enc = ctx["enc_out"]
        xk = split_heads(enc @ ap["xk"], Hkv, hd, ctx)
        xv = split_heads(enc @ ap["xv"], Hkv, hd, ctx)
    return merge_heads(_full_attention(ctx, q, xk, xv), ctx) @ ap["xo"]


def _full_attention(ctx, q, k, v):
    """Non-causal ``full_attention``; sharded, on each rank's rows (heads
    whole: the reference leaves the encoder and the cross attention
    unconstrained)."""
    R4 = rows_spec(ctx, 4)
    return local_call(ctx, lambda q_, k_, v_: full_attention(
        q_, k_, v_, causal=False), (q, k, v), (R4, R4, R4), R4)


def _ffn_apply(cfg, lp, x, ctx):
    """FFN / MoE sublayer on (B, C, d).  A decode step (C == 1, as the
    reference's ``extend`` sets its mode) is dropless, capacity B; a
    prefill chunk uses ``moe_ffn``'s capacity factor, 1.25 (the
    reference's default).  The MoE aux loss is dropped, as the reference's
    ``extend`` drops it."""
    if "moe" not in lp:
        return mlp(x, lp["ffn"], cfg.mlp_gated)
    B, C, d = x.shape
    y, _ = _moe(cfg, lp["moe"], _tokens(x, ctx), ctx,
                capacity_factor=ctx.get("capacity_factor", 1.25),
                capacity_override=B * C if C == 1 else 0,
                kernel_backend=ctx["kernel_backend"])
    return _untokens(y, B, C, ctx)


def _tokens(x, ctx):
    """(B, S, d) -> (B * S, d), the tokens split over the data axes as
    their rows are, on both sides of the view (and so its gradient's)."""
    B, S, d = x.shape
    return _constrain(_constrain(x, ctx).reshape(B * S, d), ctx)


def _untokens(y, B, S, ctx):
    """The inverse of :func:`_tokens`."""
    return _constrain(_constrain(y, ctx).reshape(B, S, y.shape[-1]), ctx)


def _moe(cfg, p, x, ctx, **kw):
    """``moe_ffn`` of the tokens x (T, d).  Sharded: the router's
    probabilities and the shared experts on DTensor, and the routing, the
    dispatch, the expert products and the combine on each rank
    (``local_call``) over the whole token set, as the reference routes the
    global batch: each data rank runs its slice of every expert's capacity
    slots, each model rank its slice of d_ff (where the axis divides it),
    so a rank's output, and its gradients, are partial sums over both
    (the dispatch's indexed writes run on plain tensors: DTensor has no
    sharding rule for them in every release)."""
    if ctx.get("mesh") is None:
        return moe_ffn(x, p, cfg, **kw)
    T = x.shape[0]
    capacity = moe_capacity(cfg, T, kw["capacity_factor"],
                            kw["capacity_override"])
    probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    data = mesh_axes(ctx.get("batch_axes"))
    i, n = axis_index(ctx, data)
    per = -(-capacity // n)
    lo = min(capacity, i * per)
    slots = (lo, min(capacity, lo + per))
    tp = ctx.get("tp_axis")
    ftp = tp if tp and cfg.moe_d_ff % axis_size(ctx, tp) == 0 else None
    ep = p["experts"]
    names = [k for k in ("w1", "wg", "w2") if k in ep]
    wspec = [P(None, ftp, None) if k == "w2" else P(None, None, ftp)
             for k in names]
    part_axes = data + ((ftp,) if ftp else ())

    def routed(x_, probs_, *ws):
        return moe_routed(x_, probs_, dict(zip(names, ws)), cfg, capacity,
                          "plain", slots=slots)
    y, ce = local_call(
        ctx, routed, (x, probs, *(ep[k] for k in names)),
        (P(None, None), P(None, None), *wspec), (P(None, None), P(None)),
        grad_partial=(part_axes, part_axes) + (data,) * len(names),
        out_partial=(part_axes, ()))
    aux = cfg.num_experts * torch.sum(probs.mean(dim=0) * ce)
    if "shared" in p:
        y = y + mlp(x, p["shared"], cfg.mlp_gated)
    return y, aux


def _cross_step(cfg, lp, x, st, ctx):
    """The cross-attention sublayer of an encoder-decoder's decoder layer
    (pre-norm ``norm_x``, residual); the identity for any other layer."""
    if not (cfg.is_encoder_decoder and "norm_x" in lp):
        return x
    hx = rms_norm(x, lp["norm_x"]["w"], cfg.norm_eps)
    return x + _cross_attn(cfg, lp["attn"], hx, st, ctx)


def apply_block(cfg, kind, lp, x, st, ctx):
    """One residual block of ``kind`` over (B, C, d); ``st`` is updated in
    place."""
    lp = unshard(lp, ctx)
    h = rms_norm(x, lp["norm1"]["w"], cfg.norm_eps)
    if kind == "rwkv6":
        x = x + rwkv6_block(h, lp["tm"], cfg, st, ctx)
        h2 = rms_norm(x, lp["norm2"]["w"], cfg.norm_eps)
        return x + rwkv6_channel_mix(h2, lp["tm"]["cm"], st, ctx)
    if kind == "rglru":
        x = x + rglru_block(h, lp["rg"], cfg, st, ctx)
    else:
        x = x + _attn_mix_extend(cfg, lp["attn"], h, st, ctx)
        x = _cross_step(cfg, lp, x, st, ctx)
    h2 = rms_norm(x, lp["norm2"]["w"], cfg.norm_eps)
    return x + _ffn_apply(cfg, lp, h2, ctx)


def _at(tree, r):
    """Per-repeat views ``leaf[r]`` of a stacked (params or cache) tree."""
    if isinstance(tree, torch.Tensor):
        return tree[r]
    return {k: _at(tree[k], r) for k in tree.keys()}


def layer_views(cfg, params):
    """Per-layer parameter views in execution order (head, each repeat of
    the pattern, tail): (kind, where its state lives, tree of views), the
    state's place as (section, key, repeat or None).  Built once per call so
    a fused decode run indexes the stacked weights once, not once per
    step."""
    head, pattern, repeats, tail = layout(cfg)
    out = [(kind, ("head", i, None), params["head"][str(i)])
           for i, kind in enumerate(head)]
    out += [(kind, ("blocks", str(pi), r), _at(params["blocks"][str(pi)], r))
            for r in range(repeats) for pi, kind in enumerate(pattern)]
    out += [(kind, ("tail", i, None), params["tail"][str(i)])
            for i, kind in enumerate(tail)]
    return out


def _run_trunk(cfg, layers, x, cache, ctx):
    x = _constrain(x, ctx)
    for kind, (sec, key, r), lp in layers:
        st = cache[sec][key]
        x = apply_block(cfg, kind, lp, x, st if r is None else _at(st, r),
                        ctx)
        x = _constrain(x, ctx)
    return x


# ============================ training forward ==============================
def check_trainable(cfg) -> None:
    """``forward`` trains every family that ``check_supported`` accepts:
    dense or MoE attention, MLA with dense head layers, RG-LRU hybrids and
    RWKV6, and the encoder-decoder and vision-prefix forms (given their
    ``frontend_emb``).

    Kernels in training are fixed by mode, not chosen at run time: with
    ``kernel_backend="cuda"`` every GQA attention layer runs the CUDA
    ``flash_attention`` forward and ``flash_attention_bwd`` backward
    (``ops.flash_attention_train``), while MLA attention (no kernel, as in
    the reference), the MoE expert products and the RG-LRU / WKV6
    recurrences always run their plain, autograd-differentiated forms, as
    the reference's training forward reaches no Pallas kernel:
    ``moe_gemm``, ``rglru_scan`` and ``rwkv6_scan`` are forward-only
    kernels with no backward (item 11 (c)).  The encoder and the cross
    attention run ``full_attention``, plain, under either backend."""
    check_supported(cfg)


def _attn_mix_train(cfg, ap, x, ctx):
    """Cacheless causal (or windowed) GQA or MLA self-attention over the
    whole sequence (``repro.models.transformer._attn_mix_train``)."""
    B, S, d = x.shape
    window = ctx.get("window") or cfg.sliding_window
    pos = ctx["positions"]  # (S,)
    if cfg.use_mla:
        q_nope, q_rope, c_kv, k_rope = _mla_project(cfg, ap, x, pos, ctx)
        out = _mla_prefill(cfg, ctx, ap, q_nope, q_rope, c_kv, k_rope, pos,
                           pos, window)
        return merge_heads(out, ctx) @ ap["wo"]
    Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ ap["wq"]
    k = x @ ap["wk"]
    v = x @ ap["wv"]
    if cfg.qkv_bias:
        q, k, v = q + ap["bq"], k + ap["bk"], v + ap["bv"]
    q = apply_rope(split_heads(q, Hq, hd, ctx), pos, cfg.rope_theta)
    k = apply_rope(split_heads(k, Hkv, hd, ctx), pos, cfg.rope_theta)
    v = split_heads(v, Hkv, hd, ctx)
    if ctx["attn_backend"] == "cuda":
        # (B, S, H, hd) -> (B, H, S, hd) are free strided views here, and the
        # output comes back in q's layout; sharded, each rank's rows
        R4 = rows_spec(ctx, 4)
        out = local_call(
            ctx, lambda q_, k_, v_: kops.flash_attention_train(
                q_, k_, v_, causal=True, window=window),
            (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)),
            (R4, R4, R4), R4).transpose(1, 2)
    else:
        out = _attend_plain(ctx, q, k, v, pos, pos, window)
    return merge_heads(out, ctx) @ ap["wo"]


def _ffn_train(cfg, lp, x, ctx):
    """FFN / MoE sublayer on (B, S, d) in training: (y, aux).  The MoE runs
    at the capacity factor's capacity, dropping assignments past it, with
    its expert products on the plain path (``check_trainable``)."""
    if "moe" not in lp:
        return mlp(x, lp["ffn"], cfg.mlp_gated), _zero_aux(x)
    B, S, d = x.shape
    y, aux = _moe(cfg, lp["moe"], _tokens(x, ctx), ctx,
                  capacity_factor=ctx["capacity_factor"],
                  capacity_override=0, kernel_backend="plain")
    return _untokens(y, B, S, ctx), aux


def _zero_aux(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _apply_block_train(cfg, kind, lp, x, ctx):
    """One residual block of ``kind`` over (B, S, d), no cache, from zero
    recurrent state: (x, aux) (``repro.models.transformer.apply_block`` with
    ``mode="train"``).  RWKV6's channel mix starts from a zero shift."""
    lp = unshard(lp, ctx)
    h = rms_norm(x, lp["norm1"]["w"], cfg.norm_eps)
    if kind == "rwkv6":
        x = x + rwkv6_block(h, lp["tm"], cfg, None, ctx)
        h2 = rms_norm(x, lp["norm2"]["w"], cfg.norm_eps)
        return x + rwkv6_channel_mix(h2, lp["tm"]["cm"], None, ctx), \
            _zero_aux(x)
    if kind == "rglru":
        x = x + rglru_block(h, lp["rg"], cfg, None, ctx)
    else:
        x = x + _attn_mix_train(cfg, lp["attn"], h, ctx)
        x = _cross_step(cfg, lp, x, None, ctx)
    h2 = rms_norm(x, lp["norm2"]["w"], cfg.norm_eps)
    y, aux = _ffn_train(cfg, lp, h2, ctx)
    return x + y, aux


def _unbind(tree, R):
    """The R per-repeat trees of a stacked tree, each leaf unbound once, so
    a stacked leaf's gradient is one stack of its per-layer gradients (a
    view per layer would add a full-size zero-padded gradient per
    layer)."""
    if isinstance(tree, torch.Tensor):
        return tree.unbind(0)
    parts = {k: _unbind(tree[k], R) for k in tree.keys()}
    return [{k: p[r] for k, p in parts.items()} for r in range(R)]


def _train_layers(cfg, params):
    """(kind, parameter tree) of every layer in execution order: the head,
    each repeat of the pattern (recurrentgemma's (R, R, A) x 12), then the
    tail ((R, R))."""
    head, pattern, repeats, tail = layout(cfg)
    stacked = [_unbind(params["blocks"][str(pi)], repeats)
               for pi in range(len(pattern))]
    return ([(kind, params["head"][str(i)]) for i, kind in enumerate(head)]
            + [(kind, stacked[pi][r]) for r in range(repeats)
               for pi, kind in enumerate(pattern)]
            + [(kind, params["tail"][str(i)])
               for i, kind in enumerate(tail)])


def _run_trunk_train(cfg, params, x, ctx, *, remat):
    """Every layer in order, the aux losses summed in that order; with
    ``remat`` each layer is checkpointed (``torch.utils.checkpoint``,
    non-reentrant), as the reference wraps its scanned layer group in
    ``jax.checkpoint``: only the layer inputs are kept, and each layer's
    forward, its aux among its outputs, runs again in the backward.
    ``remat="dots"`` keeps the matmul outputs too and recomputes the rest
    (``checkpoint_dots``: a selective checkpoint that saves ``mm`` /
    ``bmm`` / ``addmm``)."""
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    aux_total = _zero_aux(x)
    x = _constrain(x, ctx)
    for kind, lp in _train_layers(cfg, params):
        if remat:
            x, aux = checkpoint(_apply_block_train, cfg, kind, lp, x, ctx,
                                use_reentrant=False, **kw)
        else:
            x, aux = _apply_block_train(cfg, kind, lp, x, ctx)
        x = _constrain(x, ctx)
        aux_total = aux_total + aux
    return x, aux_total


# ============================ frontend forms ================================
def encode(cfg, params, frontend_emb, ctx=None):
    """Whisper-style bidirectional encoder over the stub's frame embeddings
    (B, F, frontend_dim): ``frontend_proj`` where the config has it, then
    every ``encoder`` layer (pre-norm self-attention through
    ``full_attention``, non-causal and without positions, and the FFN).
    ``ctx``: a sharded call's (the model's entry points pass it).
    Returns (B, F, d)."""
    ctx = ctx or {}
    x = frontend_emb
    if "frontend_proj" in params:
        x = x @ params["frontend_proj"]["w"]
    B, F, _ = x.shape
    Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    for lp in _unbind(params["encoder"], cfg.num_encoder_layers):
        lp = unshard(lp, ctx)
        h = rms_norm(x, lp["norm1"]["w"], cfg.norm_eps)
        ap = lp["attn"]
        q, k, v = h @ ap["wq"], h @ ap["wk"], h @ ap["wv"]
        if cfg.qkv_bias:
            q, k, v = q + ap["bq"], k + ap["bk"], v + ap["bv"]
        out = _full_attention(ctx, split_heads(q, Hq, hd, ctx),
                              split_heads(k, Hkv, hd, ctx),
                              split_heads(v, Hkv, hd, ctx))
        x = x + merge_heads(out, ctx) @ ap["wo"]
        h2 = rms_norm(x, lp["norm2"]["w"], cfg.norm_eps)
        x = x + mlp(h2, lp["ffn"], cfg.mlp_gated)
    return x


def prepend_frontend(cfg, params, tokens_emb, frontend_emb):
    """Vision prefix: the patch embeddings (B, F, frontend_dim), through
    ``frontend_proj`` where the config has it and cast to the token
    embeddings' dtype, before the tokens' (B, S, d): (B, F + S, d)."""
    fe = frontend_emb
    if "frontend_proj" in params:
        fe = fe @ params["frontend_proj"]["w"]
    return torch.cat([fe.to(tokens_emb.dtype), tokens_emb], dim=1)


def _need_frames(cfg, frontend_emb):
    if cfg.is_encoder_decoder and frontend_emb is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: its encoder "
                         "needs frontend_emb")


def forward(cfg, params, tokens, frontend_emb=None, *, window=None,
            remat=True, q_chunk=512, kv_chunk=512, capacity_factor=1.25,
            batch_axes=None, tp_axis=None, kernel_backend="cuda"):
    """Training forward: full-sequence logits (B, S_total, V) and the MoE
    aux loss summed over the layers (zero for the families without a
    router), mirroring ``repro.models.transformer.forward``.  tokens:
    (B, S) int.  An encoder-decoder needs ``frontend_emb`` (its frames);
    a vision config prepends it when given, so S_total = F + S.  The
    parameters' ``requires_grad`` decides what autograd tracks.  ``remat``:
    False, True (each layer checkpointed) or ``"dots"`` (the matmul
    outputs kept).  ``batch_axes`` / ``tp_axis``: a sharded program over
    the DTensor parameters' mesh (the module docstring)."""
    check_trainable(cfg)
    _check_backend(kernel_backend)
    _need_frames(cfg, frontend_emb)
    mesh = sharded_mesh(params, batch_axes, tp_axis)
    ctx = _shard_kw({"window": window, "q_chunk": q_chunk,
                     "kv_chunk": kv_chunk, "ssm_chunk": 32,
                     "capacity_factor": capacity_factor,
                     "kernel_backend": kernel_backend}, mesh, batch_axes,
                    tp_axis, kernel_backend)
    with replicated(ctx):
        top = _top(params, ctx)
        x = _embed(tokens, top["embed"]["w"], ctx)
        enc_out = None
        if cfg.is_encoder_decoder:
            enc_out = encode(cfg, params, frontend_emb, ctx)
        elif cfg.frontend == "vision" and frontend_emb is not None:
            x = prepend_frontend(cfg, params, x, frontend_emb)
        S = x.shape[1]
        ctx.update(positions=torch.arange(S, device=x.device),
                   enc_out=enc_out)
        x, aux = _run_trunk_train(cfg, params, x, ctx, remat=remat)
        x = rms_norm(x, top["final_norm"]["w"], cfg.norm_eps)
        return _constrain(lm_logits(x, top), ctx), aux


# ============================ public entry points ===========================
def init_cache(cfg, params, batch, max_len, dtype=torch.bfloat16, *,
               window=None, frontend_emb=None, kv_dtype=None, device=None,
               mesh=None):
    """Fresh decode state: attention rings, recurrent states, and ``pos``.
    ``kv_dtype="int8"`` builds quantized attention rings (int8 payload +
    f32 ``k_scale``/``v_scale``); ``None``/"bf16" keeps the plain ``dtype``
    ring.  ``device`` defaults to the parameters' device.  An
    encoder-decoder encodes ``frontend_emb`` (required) once: the cache
    holds its output ``enc_out`` and every decoder layer's cross K/V
    ``xk``/``xv`` (B, F, Hkv, hd) in ``dtype``.  Given a ``mesh`` (a
    ``DeviceMesh``), every leaf is a DTensor laid out by
    ``params.cache_pspecs``: sharded on its batch dim only, so each rank
    writes its own rows in place."""
    check_supported(cfg)
    _need_frames(cfg, frontend_emb)
    if device is None:
        device = params["embed"]["w"].device
    head, pattern, repeats, tail = layout(cfg)
    kv_dtype = None if kv_dtype == "bf16" else kv_dtype
    cross_len = frontend_emb.shape[1] if cfg.is_encoder_decoder else 0

    def mk(kind):
        return kvcache.init_layer_state(cfg, kind, batch, max_len, dtype,
                                        window=window, cross_len=cross_len,
                                        kv_dtype=kv_dtype, device=device)

    def stacked(kind):
        return {n: x[None].repeat((repeats,) + (1,) * x.ndim)
                for n, x in mk(kind).items()}
    cache = {"pos": torch.zeros((batch,), dtype=torch.int32, device=device),
             "head": tuple(mk(kind) for kind in head),
             "blocks": {str(pi): stacked(kind)
                        for pi, kind in enumerate(pattern)},
             "tail": tuple(mk(kind) for kind in tail)}
    if mesh is not None:
        cache = _distribute_cache(cache, mesh, batch)
    if cfg.is_encoder_decoder:
        ctx = {"mesh": mesh, "batch_axes": None if mesh is None else
               batch_pspec(mesh, batch, 1)[0]}
        with replicated(ctx):
            enc_out = encode(cfg, params, frontend_emb, ctx)
            if mesh is not None:
                enc_out = redistribute_to(enc_out, cache_pspecs(
                    {"enc_out": enc_out}, mesh, batch)[("enc_out",)])
            cache["enc_out"] = enc_out
            for kind, (sec, key, r), lp in layer_views(cfg, params):
                if kind == "attn":
                    st = cache[sec][key]
                    for n in ("xk", "xv"):
                        leaf = st[n] if r is None else st[n][r]
                        val = split_heads(enc_out @ lp["attn"][n],
                                           cfg.num_kv_heads, cfg.head_dim,
                                           ctx)
                        if is_dtensor(leaf):
                            with torch.no_grad():
                                leaf.to_local().copy_(local_rows(val, leaf))
                        else:
                            leaf.copy_(val)
    return cache


def _distribute_cache(cache, mesh, batch):
    """Every leaf of a fresh cache as a DTensor on ``mesh``, laid out by
    ``cache_pspecs``."""
    from torch.distributed.tensor import distribute_tensor
    specs = cache_pspecs(cache, mesh, batch)

    def dist(path, node):
        if isinstance(node, torch.Tensor):
            # the same zeros on every rank: each keeps its chunk, no
            # collective
            return distribute_tensor(node, mesh,
                                     param_placements(specs[path], mesh),
                                     src_data_rank=None)
        if isinstance(node, dict):
            return {k: dist(path + (k,), v) for k, v in node.items()}
        return tuple(dist(path + (str(i),), v) for i, v in enumerate(node))
    return dist((), cache)


def _check_backend(kernel_backend):
    if kernel_backend not in KERNEL_BACKENDS:
        raise ValueError(f"kernel_backend must be one of {KERNEL_BACKENDS}: "
                         f"{kernel_backend!r}")


def _extend(cfg, params, cache, tokens, *, window=None, frontend_emb=None,
            q_chunk=512, kv_chunk=512, capacity_factor=1.25, batch_axes=None,
            tp_axis=None, kernel_backend="cuda", active=None, layers=None):
    _check_backend(kernel_backend)
    mesh = sharded_mesh(params, batch_axes, tp_axis)
    ctx = _shard_kw({"window": window, "q_chunk": q_chunk,
                     "kv_chunk": kv_chunk, "ssm_chunk": 32,
                     "capacity_factor": capacity_factor,
                     "kernel_backend": kernel_backend, "active": active,
                     "enc_out": cache.get("enc_out")}, mesh, batch_axes,
                    tp_axis, kernel_backend)
    with replicated(ctx):
        top = _top(params, ctx)
        x = _embed(tokens, top["embed"]["w"], ctx)
        if cfg.frontend == "vision" and frontend_emb is not None:
            x = prepend_frontend(cfg, params, x, frontend_emb)
        C = x.shape[1]
        ctx["pos"] = cache["pos"][:, None] + torch.arange(
            C, dtype=torch.int32, device=tokens.device)[None, :]
        layers = layer_views(cfg, params) if layers is None else layers
        x = _run_trunk(cfg, layers, x, cache, ctx)
        if active is None:
            cache["pos"] += C
        else:
            cache["pos"] += active.to(torch.int32) * C
        x_last = rms_norm(x[:, -1, :], top["final_norm"]["w"],
                          cfg.norm_eps)
        return _constrain(lm_logits(x_last, top), ctx)


def extend(cfg, params, cache, tokens, *, window=None, frontend_emb=None,
           q_chunk=512, kv_chunk=512, capacity_factor=1.25, batch_axes=None,
           tp_axis=None, kernel_backend="cuda"):
    """Process a chunk of C tokens against the cache (C == 1 => decode
    step).  tokens: (B, C) int; a vision config's ``frontend_emb`` (B, F,
    frontend_dim) goes before them, making the chunk F + C long.  Updates
    ``cache`` in place and returns (logits_last (B, V), cache).  A prefill
    chunk's MoE runs at ``capacity_factor`` (a decode step is dropless).
    ``batch_axes`` / ``tp_axis``: a sharded program over the DTensor
    parameters' mesh, on a cache from ``init_cache(..., mesh=)``."""
    logits = _extend(cfg, params, cache, tokens, window=window,
                     frontend_emb=frontend_emb, q_chunk=q_chunk,
                     kv_chunk=kv_chunk, capacity_factor=capacity_factor,
                     batch_axes=batch_axes, tp_axis=tp_axis,
                     kernel_backend=kernel_backend)
    return logits, cache


def prefill(cfg, params, tokens, *, max_len=None, window=None,
            frontend_emb=None, dtype=torch.bfloat16, kv_dtype=None,
            q_chunk=512, kv_chunk=512, capacity_factor=1.25, batch_axes=None,
            tp_axis=None, kernel_backend="cuda"):
    """Full prefill: a fresh batch-``B`` cache of ``max_len`` (default: the
    prompt's length, plus ``frontend_tokens`` for a vision config) and one
    :func:`extend` over the whole prompt.  ``frontend_emb`` is an
    encoder-decoder's frames (encoded into the cache) or a vision config's
    patch embeddings (prepended to the prompt).  tokens: (B, S) int on the
    parameters' device.  Sharded (``batch_axes`` / ``tp_axis``), the cache
    is built on the parameters' mesh.  Returns (logits_last (B, V),
    cache)."""
    B, S = tokens.shape
    vision = cfg.frontend == "vision"
    mesh = sharded_mesh(params, batch_axes, tp_axis)
    cache = init_cache(cfg, params, B,
                       max_len or S + (cfg.frontend_tokens if vision else 0),
                       dtype, window=window, kv_dtype=kv_dtype,
                       frontend_emb=frontend_emb if cfg.is_encoder_decoder
                       else None, mesh=mesh)
    return extend(cfg, params, cache, tokens, window=window,
                  frontend_emb=frontend_emb if vision else None,
                  q_chunk=q_chunk, kv_chunk=kv_chunk,
                  capacity_factor=capacity_factor, batch_axes=batch_axes,
                  tp_axis=tp_axis, kernel_backend=kernel_backend)


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


__all__ = ["layout", "check_supported", "check_trainable", "init_params",
           "init_cache", "forward", "encode", "prepend_frontend", "extend",
           "extend_row", "decode_step", "decode_run", "layer_views",
           "KERNEL_BACKENDS"]
