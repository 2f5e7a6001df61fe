"""Per-layer decode/prefill state (KV ring caches) and slot-pool helpers.

PyTorch port of the attention part of ``repro.models.kvcache``.  The cache
is the same nested dict as the reference's::

    cache = {
      "pos":   (B,) int32     next absolute position to write,
      "head":  ()             unrolled leading layers (none: attention trunk),
      "blocks": {pos_idx: {"k", "v", "slot_pos"[, "k_scale", "v_scale"]}}
                              stacked over a leading repeats axis,
      "tail":  ()             unrolled trailing layers (none: attention trunk),
    }

Attention state is a ring buffer of ``alloc`` slots; ``slot_pos`` stores each
slot's absolute position (-1 = empty).  ``blocks`` keeps batch on axis 1.

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
_RING_PAYLOAD = frozenset({"k", "v", "slot_pos", "k_scale", "v_scale"})
# attention payload: left stale (not rewritten) by reset_row
_ATTN_PAYLOAD = frozenset({"k", "v", "k_scale", "v_scale"})


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
                     kv_dtype: Optional[str] = None, device=None) -> dict:
    if kind != "attn":
        raise NotImplementedError(
            f"{kind!r} layer state is not ported yet (ROADMAP.md queue 1, "
            "item 8: other decoder families)")
    if cfg.use_mla:
        raise NotImplementedError(
            "MLA caches are not ported yet (ROADMAP.md queue 1, item 8)")
    quant = kv_dtype == "int8"
    alloc = attn_alloc_len(cfg, max_len, window)
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
# independent decode slots (DESIGN.md §3).  The batch axis is 0 for "pos"
# and 1 for the stacked "blocks" leaves.

def _map_blocks(fn, *caches):
    """Apply ``fn(name, *leaves)`` to every ``blocks`` leaf of one or more
    structurally equal caches; returns the new ``blocks`` dict."""
    return {pi: {name: fn(name, *[c["blocks"][pi][name] for c in caches])
                 for name in caches[0]["blocks"][pi]}
            for pi in caches[0]["blocks"]}


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """True when ``b`` is exactly the memory ``a`` names (a view written in
    place), so a write-back would copy a tensor onto itself."""
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride())


def _put(dst: torch.Tensor, src: torch.Tensor) -> None:
    if not _same(dst, src):
        dst.copy_(src)


def read_row(pool, slot: int):
    """Batch-1 row view of pool row ``slot`` (a host int): every leaf is a
    view, so the model's in-place writes land in the pool row directly."""
    out = dict(pool)
    out["pos"] = pool["pos"][slot:slot + 1]
    out["blocks"] = _map_blocks(lambda n, x: x[:, slot:slot + 1], pool)
    return out


def write_row_slice(pool, one, slot: int, start: int, c: int):
    """Write the ``c`` ring positions ``[start, start+c)`` (mod alloc,
    tail-clipped like the extend write) of batch-1 cache ``one`` into pool
    row ``slot``, plus ``pos``.  A :func:`read_row` view already lives in
    the row, so nothing moves."""
    _put(pool["pos"][slot:slot + 1], one["pos"])
    for pi, st in pool["blocks"].items():
        for name, p in st.items():
            o = one["blocks"][pi][name]
            dst = p[:, slot:slot + 1]
            if name in _RING_PAYLOAD:
                alloc = dst.shape[2]
                if dst.data_ptr() == o.data_ptr() \
                        and dst.stride() == o.stride():
                    continue  # a (possibly truncated) view of this row
                n = min(c, alloc)
                idx = (start + (c - n)
                       + torch.arange(n, device=p.device)) % alloc
                dst[:, :, idx] = o[:, :, idx]
            else:
                _put(dst, o)
    return pool


def truncate_rings(one, kv_limit, full):
    """Static prefix view: ring leaves whose alloc equals ``full`` (the
    build-time ``max_len``; no window shrank them) are sliced to their first
    ``kv_limit`` slots.  Windowed leaves (alloc < full) keep their ring."""
    if not full or kv_limit >= full:
        return one
    out = dict(one)
    out["blocks"] = _map_blocks(
        lambda n, x: x[:, :, :kv_limit]
        if n in _RING_PAYLOAD and x.shape[2] == full else x, one)
    return out


def untruncate_rings(full_cache, view, kv_limit, full):
    """Inverse of :func:`truncate_rings`: the advanced ``kv_limit`` prefix
    and ``pos`` of ``view`` land in ``full_cache`` (free for a view)."""
    if not full or kv_limit >= full:
        return view
    _put(full_cache["pos"], view["pos"])
    for pi, st in full_cache["blocks"].items():
        for name, p in st.items():
            v = view["blocks"][pi][name]
            _put(p[:, :, :v.shape[2]], v)
    return full_cache


def slice_rows(pool, rows: int):
    """Leading-rows view of a pool cache (live-row sub-pool decode,
    DESIGN.md §9): batch rows ``[0, rows)`` of every leaf."""
    out = dict(pool)
    out["pos"] = pool["pos"][:rows]
    out["blocks"] = _map_blocks(lambda n, x: x[:, :rows], pool)
    return out


def write_rows_prefix(pool, sub, rows: int, kv_limit, full):
    """Write an advanced ``rows``-row sub-pool back into the pool's leading
    rows, bounded to the ``kv_limit`` ring prefix (free for a view)."""
    kv = None if (not full or kv_limit >= full) else kv_limit
    _put(pool["pos"][:rows], sub["pos"])
    for pi, st in pool["blocks"].items():
        for name, p in st.items():
            s = sub["blocks"][pi][name]
            if kv is not None and name in _RING_PAYLOAD \
                    and p.shape[2] == full:
                _put(p[:, :rows, :kv], s[:, :, :kv])
            else:
                _put(p[:, :rows], s)
    return pool


def reset_row(pool, slot: int):
    """Invalidate pool row ``slot`` for rebinding, in place: ``slot_pos``
    becomes -1 (every mask treats it as empty) and ``pos`` 0; the K/V
    payload of the previous occupant is left as it is (O(alloc) not
    O(alloc * d))."""
    pool["pos"][slot] = 0
    for st in pool["blocks"].values():
        for name, x in st.items():
            if name not in _ATTN_PAYLOAD:
                x[:, slot] = -1 if name == "slot_pos" else 0
    return pool


def copy_into_prefix(new, old, p: int):
    """Copy the ``p`` rows of pool ``old`` into the first ``p`` rows of the
    larger, freshly initialised pool ``new`` (pool doubling)."""
    new["pos"][:p].copy_(old["pos"])
    for pi, st in new["blocks"].items():
        for name, x in st.items():
            x[:, :p].copy_(old["blocks"][pi][name])
    return new


def select_rows(mask: torch.Tensor, new, old):
    """Functional masked update: row ``b`` of the result is ``new``'s where
    ``mask[b]`` else ``old``'s.  The reference applies this after every
    masked decode step; the port writes only the active rows in place
    instead (``transformer._attn_mix_extend``), and the tests hold the two
    equal."""
    out = dict(new)
    out["pos"] = torch.where(mask, new["pos"], old["pos"])

    def sel(name, n, o):
        m = mask.reshape((1, -1) + (1,) * (n.ndim - 2))
        return torch.where(m, n, o)
    out["blocks"] = _map_blocks(sel, new, old)
    return out
