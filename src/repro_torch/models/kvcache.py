"""Per-layer decode/prefill state (KV rings, recurrent states) and slot-pool
helpers.

PyTorch port of ``repro.models.kvcache`` for the attention (GQA or MLA),
RG-LRU and RWKV6 layer kinds.  The cache is the same nested dict as the
reference's::

    cache = {
      "pos":   (B,) int32     next absolute position to write,
      "head":  (state_0, ...) unrolled leading layers (batch on axis 0),
      "blocks": {pos_idx: state}   stacked over a leading repeats axis
                              (batch on axis 1),
      "tail":  (state_0, ...) unrolled trailing layers (batch on axis 0),
      "enc_out": (B, F, d)    encoder output (encoder-decoder only: the
                              decoder reads its layers' ``xk``/``xv``,
                              and the pool helpers, which serve
                              text-only decoders, leave it),
    }

Attention state is a ring buffer of ``alloc`` slots; ``slot_pos`` stores each
slot's absolute position (-1 = empty).  A GQA ring holds ``k``/``v``; an
MLA ring holds the latent ``c`` (B, alloc, kv_lora_rank) and the shared
RoPE key ``kr`` (B, alloc, qk_rope_head_dim).  An encoder-decoder layer also
holds its cross-attention K/V ``xk``/``xv`` (B, cross_len, Hkv, hd), which
have no ring axis: the helpers move them whole and ``reset_row`` leaves
them, as it leaves the ring payload.  Recurrent state (RG-LRU ``h`` and
``conv``, RWKV6 ``wkv``, ``shift_tm`` and ``shift_cm``) has no ring axis: the
helpers move it whole, row by row, and ``reset_row`` zeroes it.

Where the reference gathers a row (``read_row``), a row prefix
(``slice_rows``) or a ring prefix (``truncate_rings``) and later scatters it
back under buffer donation, the port hands out *views* of the pool: the
model writes through them in place, so the matching write-back helpers find
the view already living in the pool's memory and move nothing.  They still
copy when handed a tensor that is not a view of the pool.
"""
from __future__ import annotations

from typing import Optional

import torch

# smallest representable scale: keeps all-zero K/V rows exactly zero after
# the round trip instead of dividing by zero
_QUANT_EPS = 1e-8

# ring payload: leaves that carry the ring (alloc) axis right after batch
_RING_PAYLOAD = frozenset({"k", "v", "c", "kr", "slot_pos", "k_scale",
                           "v_scale"})
# attention payload: left stale (not rewritten) by reset_row
_ATTN_PAYLOAD = frozenset({"k", "v", "c", "kr", "xk", "xv", "k_scale",
                           "v_scale"})


def kv_supports_int8(cfg) -> bool:
    """int8 KV quantization covers the k/v ring layout; an MLA cache holds a
    latent (``c``/``kr``) with no per-head scale axis."""
    return not cfg.use_mla


def quantize_kv(x: torch.Tensor):
    """Symmetric per-(…, head) int8 quantization over the trailing
    ``head_dim`` axis: returns ``(q int8, scale f32)`` with
    ``scale = max|x| / 127`` (shape = x.shape[:-1]).  torch.round, like
    jnp.round, rounds half to even, so the payload equals the reference's."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp_min(amax, _QUANT_EPS) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: ``q * scale`` over head_dim."""
    return (q.float() * scale[..., None].float()).to(dtype)


def attn_alloc_len(cfg, max_len: int, window: Optional[int]) -> int:
    w = window if window is not None else cfg.sliding_window
    return min(max_len, w) if w is not None else max_len


def init_layer_state(cfg, kind: str, batch: int, max_len: int,
                     dtype=torch.bfloat16, window: Optional[int] = None,
                     cross_len: int = 0, kv_dtype: Optional[str] = None,
                     device=None) -> dict:
    """Fresh state of one layer of ``kind``.  ``kv_dtype="int8"``
    quantizes only attention rings; recurrent states keep f32 (``h``,
    ``wkv``) and ``dtype`` (``conv``, shifts) as in the reference.  A
    ``cross_len`` adds an attention layer's cross K/V ``xk``/``xv``
    (batch, cross_len, Hkv, hd) in ``dtype``."""
    if kind == "rglru":
        W = cfg.lru_width
        return {"h": torch.zeros((batch, W), dtype=torch.float32,
                                 device=device),
                "conv": torch.zeros((batch, cfg.conv1d_width - 1, W),
                                    dtype=dtype, device=device)}
    if kind == "rwkv6":
        D = cfg.ssm_head_dim
        H = cfg.d_model // D
        return {"wkv": torch.zeros((batch, H, D, D), dtype=torch.float32,
                                   device=device),
                "shift_tm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                        device=device),
                "shift_cm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                        device=device)}
    if kind != "attn":
        raise ValueError(kind)
    quant = kv_dtype == "int8"
    alloc = attn_alloc_len(cfg, max_len, window)
    if cfg.use_mla:
        if quant:
            raise NotImplementedError(
                "int8 KV quantization is per-(slot, kv head); MLA caches "
                "a latent without a head axis (kv_supports_int8)")
        return {"c": torch.zeros((batch, alloc, cfg.kv_lora_rank),
                                 dtype=dtype, device=device),
                "kr": torch.zeros((batch, alloc, cfg.qk_rope_head_dim),
                                  dtype=dtype, device=device),
                "slot_pos": torch.full((batch, alloc), -1,
                                       dtype=torch.int32, device=device)}
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    payload = torch.int8 if quant else dtype
    st = {
        "k": torch.zeros((batch, alloc, hkv, hd), dtype=payload,
                         device=device),
        "v": torch.zeros((batch, alloc, hkv, hd), dtype=payload,
                         device=device),
        "slot_pos": torch.full((batch, alloc), -1, dtype=torch.int32,
                               device=device),
    }
    if quant:
        st["k_scale"] = torch.zeros((batch, alloc, hkv), dtype=torch.float32,
                                    device=device)
        st["v_scale"] = torch.zeros((batch, alloc, hkv), dtype=torch.float32,
                                    device=device)
    if cross_len:
        for n in ("xk", "xv"):
            st[n] = torch.zeros((batch, cross_len, hkv, hd), dtype=dtype,
                                device=device)
    return st


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)


def cache_bytes(cache) -> int:
    return sum(x.numel() * x.element_size() for x in _leaves(cache))


# ============================ slot-pool helpers =============================
# A *slot pool* is an ordinary cache whose batch dimension is a pool of
# independent decode slots (DESIGN.md §3).  The batch axis is 0 for "pos",
# "head" and "tail" and 1 for the stacked "blocks" leaves; a ring leaf's
# alloc axis follows its batch axis.

def _walk(*caches):
    """``(name, batch axis, leaves)`` of every layer-state leaf of one or
    more structurally equal caches."""
    c0 = caches[0]
    for sec, keys, axis in (("head", range(len(c0["head"])), 0),
                            ("blocks", c0["blocks"], 1),
                            ("tail", range(len(c0["tail"])), 0)):
        for key in keys:
            for name in c0[sec][key]:
                yield name, axis, [c[sec][key][name] for c in caches]


def _map_states(fn, *caches):
    """A copy of ``caches[0]`` whose state leaves are ``fn(name, batch
    axis, *leaves)`` over the matching leaves of every cache."""
    out = dict(caches[0])
    for sec in ("head", "tail"):
        out[sec] = tuple({n: fn(n, 0, *[c[sec][i][n] for c in caches])
                          for n in st}
                         for i, st in enumerate(caches[0][sec]))
    out["blocks"] = {pi: {n: fn(n, 1, *[c["blocks"][pi][n] for c in caches])
                          for n in st}
                     for pi, st in caches[0]["blocks"].items()}
    return out


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """True when ``b`` is exactly the memory ``a`` names (a view written in
    place), so a write-back would copy a tensor onto itself."""
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride())


def _put(dst: torch.Tensor, src: torch.Tensor) -> None:
    if not _same(dst, src):
        dst.copy_(src)


def _is_full_ring(name, x, axis, full) -> bool:
    """A ring leaf whose alloc equals ``full``: no window shrank it."""
    return name in _RING_PAYLOAD and x.shape[axis + 1] == full


def write_slot(pool, one, slot: int):
    """Scatter batch-1 cache ``one`` into pool row ``slot`` whole, in
    place: every ring slot, ``pos`` and the recurrent state.  The bind
    scatter of the scratch-cache prefill baseline (``in_pool_prefill=False``):
    O(alloc) bytes a row, where in-pool prefill's :func:`write_row_slice`
    moves O(c) a chunk."""
    pool["pos"].narrow(0, slot, 1).copy_(one["pos"])
    for _, axis, (p, o) in _walk(pool, one):
        p.narrow(axis, slot, 1).copy_(o)
    return pool


def read_row(pool, slot: int):
    """Batch-1 row view of pool row ``slot`` (a host int): every leaf is a
    view, so the model's in-place writes land in the pool row directly."""
    out = _map_states(lambda n, a, x: x.narrow(a, slot, 1), pool)
    out["pos"] = pool["pos"][slot:slot + 1]
    return out


def write_row_slice(pool, one, slot: int, start: int, c: int):
    """Write the ``c`` ring positions ``[start, start+c)`` (mod alloc,
    tail-clipped like the extend write) of batch-1 cache ``one`` into pool
    row ``slot``, plus ``pos`` and the recurrent state.  A :func:`read_row`
    view already lives in the row, so nothing moves."""
    _put(pool["pos"][slot:slot + 1], one["pos"])
    for name, axis, (p, o) in _walk(pool, one):
        dst = p.narrow(axis, slot, 1)
        if name in _RING_PAYLOAD:
            if dst.data_ptr() == o.data_ptr() and dst.stride() == o.stride():
                continue  # a (possibly truncated) view of this row
            alloc = dst.shape[axis + 1]
            n = min(c, alloc)
            idx = (start + (c - n)
                   + torch.arange(n, device=p.device)) % alloc
            dst.index_copy_(axis + 1, idx, o.index_select(axis + 1, idx))
        else:
            _put(dst, o)
    return pool


def truncate_rings(one, kv_limit, full):
    """Static prefix view: ring leaves whose alloc equals ``full`` (the
    build-time ``max_len``; no window shrank them) are sliced to their first
    ``kv_limit`` slots.  Windowed leaves (alloc < full) keep their ring, and
    recurrent leaves have none."""
    if not full or kv_limit >= full:
        return one
    out = _map_states(
        lambda n, a, x: x.narrow(a + 1, 0, kv_limit)
        if _is_full_ring(n, x, a, full) else x, one)
    out["pos"] = one["pos"]
    return out


def untruncate_rings(full_cache, view, kv_limit, full):
    """Inverse of :func:`truncate_rings`: the advanced ``kv_limit`` prefix,
    ``pos`` and the recurrent state of ``view`` land in ``full_cache`` (free
    for a view)."""
    if not full or kv_limit >= full:
        return view
    _put(full_cache["pos"], view["pos"])
    for name, axis, (p, v) in _walk(full_cache, view):
        if _is_full_ring(name, p, axis, full):
            p = p.narrow(axis + 1, 0, v.shape[axis + 1])
        _put(p, v)
    return full_cache


def slice_rows(pool, rows: int):
    """Leading-rows view of a pool cache (live-row sub-pool decode,
    DESIGN.md §9): batch rows ``[0, rows)`` of every leaf."""
    out = _map_states(lambda n, a, x: x.narrow(a, 0, rows), pool)
    out["pos"] = pool["pos"][:rows]
    return out


def write_rows_prefix(pool, sub, rows: int, kv_limit, full):
    """Write an advanced ``rows``-row sub-pool back into the pool's leading
    rows, bounded to the ``kv_limit`` ring prefix (free for a view)."""
    kv = None if (not full or kv_limit >= full) else kv_limit
    _put(pool["pos"][:rows], sub["pos"])
    for name, axis, (p, s) in _walk(pool, sub):
        dst = p.narrow(axis, 0, rows)
        if kv is not None and _is_full_ring(name, p, axis, full):
            dst, s = dst.narrow(axis + 1, 0, kv), s.narrow(axis + 1, 0, kv)
        _put(dst, s)
    return pool


def reset_row(pool, slot: int):
    """Invalidate pool row ``slot`` for rebinding, in place: ``slot_pos``
    becomes -1 (every mask treats it as empty), ``pos`` and every recurrent
    state 0 (they accumulate, so masking cannot neutralise them); the K/V
    payload of the previous occupant is left as it is (O(alloc) not
    O(alloc * d)).  Every write is a fill on the device: indexing a CUDA
    tensor with a Python scalar assigned would copy it from the host."""
    pool["pos"].narrow(0, slot, 1).zero_()
    for name, axis, (x,) in _walk(pool):
        if name not in _ATTN_PAYLOAD:
            x.narrow(axis, slot, 1).fill_(-1 if name == "slot_pos" else 0)
    return pool


def _mask_prefix_view(one, hit: int, cap: int):
    """Clamp a batch-1 ring view to exactly its first ``hit`` positions:
    ``slot_pos`` entries at and beyond ``hit`` become -1 (empty: attention
    masks them out although the K/V payload still holds donor bytes) and
    ``pos`` becomes ``hit``.  ``cap`` is the view's ring alloc.  The masked
    ``slot_pos`` and ``pos`` are new tensors: the view's own may name a live
    donor row, which must not change."""
    dead = torch.arange(cap, device=one["pos"].device) >= hit
    out = _map_states(lambda n, a, x: x.masked_fill(dead, -1)
                      if n == "slot_pos" else x, one)
    out["pos"] = torch.full_like(one["pos"], hit)
    return out


def copy_prefix_rows(pool, src: int, dst: int, hit: int, hit_cap: int,
                     full):
    """Shared-prefix KV reuse, row to row (DESIGN.md §10), in place: row
    ``dst`` is reset, then ring positions ``[0, hit_cap)`` of donor row
    ``src`` land in it with ``slot_pos`` masked to ``[0, hit)``, leaving
    ``dst`` as if tokens ``[0, hit)`` had been prefilled into it.  The
    ``[hit, hit_cap)`` overhang keeps the donor's K/V bytes, invisible to
    attention.  Exact only for never-wrapping pure-attention rings
    (``prefixcache.prefix_reuse_supported``); ``src != dst``, host ints."""
    reset_row(pool, dst)
    eff = min(hit_cap, full) if full else hit_cap
    view = truncate_rings(read_row(pool, src), eff, full)
    view = _mask_prefix_view(view, hit, eff)
    return write_row_slice(pool, view, dst, 0, eff)


def snapshot_prefix(pool, src: int, depth_cap: int, full):
    """Detach the leading ``depth_cap`` ring slots of row ``src`` as a
    batch-1 prefix entry of the shared-prefix store, taken when a donor
    row is about to be rebound.  Every leaf is a copy: the entry must not
    change when the row does."""
    eff = min(depth_cap, full) if full else depth_cap
    return copy_cache(truncate_rings(read_row(pool, src), eff, full))


def copy_cache(cache):
    """A copy of every leaf of ``cache``: what a program that may not
    write its input in place writes (the reference's un-donated programs,
    the ``device_resident=False`` baseline)."""
    out = _map_states(lambda n, a, x: x.clone(), cache)
    out["pos"] = cache["pos"].clone()
    return out


def paste_prefix(pool, entry, dst: int, hit: int, hit_cap: int,
                 entry_alloc: int, full):
    """Consume a :func:`snapshot_prefix` entry, in place: the store-sourced
    twin of :func:`copy_prefix_rows` (``hit <= hit_cap <= entry_alloc``).
    The entry is read, never written."""
    reset_row(pool, dst)
    eff = min(hit_cap, entry_alloc)
    view = truncate_rings(entry, eff, entry_alloc)
    view = _mask_prefix_view(view, hit, eff)
    return write_row_slice(pool, view, dst, 0, eff)


def handoff_row(pool, entry, slot: int, entry_alloc: int, full):
    """Install a staged prefill row into pool row ``slot``, in place (the
    stage-decoupled KV handoff, DESIGN.md §14): ``entry`` is a
    :func:`truncate_rings` prefix of a batch-1 staging cache whose prefill
    ran to completion, on the pool's device.  ``reset_row`` first (ring
    slots past ``entry_alloc`` would otherwise keep the previous occupant's
    positions), then the entry's ring prefix, ``pos`` and every recurrent,
    shift and conv state land verbatim through :func:`write_row_slice`.  No
    prefix mask: the staging cache's ``slot_pos`` and ``pos`` are exact,
    which also covers windowed and recurrent leaves.  ``entry`` is read,
    never written."""
    reset_row(pool, slot)
    eff = min(entry_alloc, full) if full else entry_alloc
    return write_row_slice(pool, entry, slot, 0, eff)


def copy_into_prefix(new, old, p: int):
    """Copy the ``p`` rows of pool ``old`` into the first ``p`` rows of the
    larger, freshly initialised pool ``new`` (pool doubling)."""
    new["pos"][:p].copy_(old["pos"])
    for _, axis, (x, o) in _walk(new, old):
        x.narrow(axis, 0, p).copy_(o)
    return new


def select_rows(mask: torch.Tensor, new, old):
    """Functional masked update: row ``b`` of the result is ``new``'s where
    ``mask[b]`` else ``old``'s.  The reference applies this after every
    masked decode step; the port writes only the active rows in place
    instead (``transformer._attn_mix_extend``, ``ssm.store_rows``), and the
    tests hold the two equal."""
    def sel(name, axis, n, o):
        m = mask.reshape((1,) * axis + (-1,) + (1,) * (n.ndim - axis - 1))
        return torch.where(m, n, o)
    out = _map_states(sel, new, old)
    out["pos"] = torch.where(mask, new["pos"], old["pos"])
    return out
