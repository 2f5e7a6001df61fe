"""Wrappers of the CUDA kernels: the serving attention kernels, the
training attention kernel with its backward (and the autograd Function
that joins them), the grouped expert GEMM of the MoE FFN, and the RG-LRU
and WKV6 recurrences.

A CPU tensor goes to the kernel's plain version in ``ref``; a CUDA tensor
goes to the kernel or raises — there is no fallback.  Each wrapper checks
device, dtype, shapes and the innermost stride, allocates the output,
launches on PyTorch's current stream and raises if the launch was refused.
Other strides are passed through, so pool row views, ring prefixes,
(B, S, H, hd) -> (B, H, S, hd) transposes, the MoE dispatch buffer's
capacity slice and the WKV6 (B, S, H, D) -> (B, H, S, D) head split need no
copy.

``LAUNCHES`` counts kernel launches per kernel (plain integers, incremented
only where a kernel is launched), so a run can show that its main path went
through the kernels.

A DTensor argument raises ``TypeError``: a kernel reads one device's
memory, and a sharded model calls the wrappers on each rank's local
tensors (``local_map``), never on a DTensor's pointer.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"decode_attention": 0, "flash_attention_pool": 0, "moe_gemm": 0,
            "rglru_scan": 0, "rwkv6_scan": 0, "flash_attention": 0,
            "flash_attention_bwd": 0}
HEAD_DIMS = (32, 64, 128, 256)
RWKV6_HEAD_DIMS = (32, 64)  # WKV6 head sizes the scan kernel takes
RWKV6_CHUNK = 32  # tokens a chunk of the WKV6 kernel (csrc/rwkv6_scan.cu)
RGLRU_CHUNK = 16  # tokens a chunk of the RG-LRU kernel (kL, rglru_scan.cu)
RGLRU_TILE_W = 128  # channels a block of the RG-LRU kernel (kTW)
DECODE_MAX_GROUP = 16  # query heads per kv head the decode kernel takes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _local_only(name: str, *ts) -> None:
    """Refuse DTensor arguments (``None`` entries are skipped)."""
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in ts):
        raise TypeError(f"{name}: a DTensor argument; call the kernel on "
                        "each rank's local tensors (local_map)")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _launched(name: str, rc: int) -> None:
    """Raise if the C entry point reports a refused launch; else count it."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
    LAUNCHES[name] += 1


def _check_common(name, q, k, v, k_scale, v_scale, ints, hd, Hq, Hkv):
    dev = q.device
    tensors = [k, v, *ints] + [t for t in (k_scale, v_scale) if t is not None]
    _require(all(t.device == dev for t in tensors),
             f"{name}: every tensor must be on {dev}")
    _require(q.dtype in _DTYPE_CODE,
             f"{name}: q must be float32 or bfloat16, got {q.dtype}")
    _require(hd in HEAD_DIMS, f"{name}: head_dim {hd} not in {HEAD_DIMS}")
    _require(Hkv >= 1 and Hq % Hkv == 0,
             f"{name}: {Hq} query heads are not a multiple of {Hkv} kv heads")
    quant = k_scale is not None
    _require(quant == (v_scale is not None),
             f"{name}: k_scale and v_scale come together")
    want = torch.int8 if quant else q.dtype
    _require(k.dtype == want and v.dtype == want,
             f"{name}: K/V must be {want} (q is {q.dtype}, scales "
             f"{'given' if quant else 'absent'}), got {k.dtype}/{v.dtype}")
    if quant:
        _require(k_scale.dtype == torch.float32
                 and v_scale.dtype == torch.float32,
                 f"{name}: scales must be float32")
    _require(all(t.dtype == torch.int32 for t in ints),
             f"{name}: position tensors must be int32")
    _require(q.stride(-1) == 1 and k.stride(-1) == 1 and v.stride(-1) == 1,
             f"{name}: the head_dim axis of q, K and V must have stride 1")
    return quant


def _scale_args(s):
    return [s.data_ptr(), *s.stride()] if s is not None else [None, 0, 0, 0]


def _limit(S: int, kv_limit) -> int:
    return S if kv_limit is None else max(1, min(int(kv_limit), S))


# the split-KV decode kernel (csrc/decode_attention.cu): a split is a run
# of whole DECODE_TILE-slot tiles (ref.split_bounds)
DECODE_TILE = 64
DECODE_SMS = 132  # SMs of an H100 SXM
# the most the partials' f32 traffic (written, then read by the merge) may
# add to the K/V bytes of a call: at recurrentgemma-9b's decode shape it
# allows 8 splits (0.126 of the K/V bytes), the fastest count measured
# there (PERF.md)
PARTIAL_SHARE = 1 / 7


def decode_splits(B: int, Hkv: int, S: int, hd: int, G: int,
                  kv_size: int = 2) -> int:
    """Splits of the first S ring slots for the decode kernel's grid (Hkv,
    B, n): as many as fill one round of resident blocks (two 112 KB blocks
    an SM at head_dim <= 128, one 145 KB block at 256: on the H100 more
    blocks than that only add merge traffic, PERF.md), at most one a
    tile, and few enough that the partials' B Hq n (hd + 2) 8 bytes stay
    within PARTIAL_SHARE of the K/V bytes (``kv_size`` bytes an element).
    Shapes only, never data: a call needs no host sync and splits the same
    way every time."""
    tiles = -(-S // DECODE_TILE)
    resident = DECODE_SMS * (1 if hd >= 256 else 2)
    cap = int(PARTIAL_SHARE * 2 * S * hd * kv_size // (8 * G * (hd + 2)))
    return max(1, min(resident // (B * Hkv), tiles, cap))


def _check_decode(name, q, k_cache, v_cache, slot_pos, cur_pos, k_scale,
                  v_scale):
    """The decode kernel's checks; returns G."""
    B, Hq, hd = q.shape
    _, S, Hkv, _ = k_cache.shape
    _require(k_cache.shape == (B, S, Hkv, hd) == v_cache.shape,
             f"{name}: K/V shape {tuple(k_cache.shape)}/"
             f"{tuple(v_cache.shape)} does not fit q {tuple(q.shape)}")
    _require(slot_pos.shape == (B, S) and cur_pos.shape == (B,),
             f"{name}: slot_pos {tuple(slot_pos.shape)} / cur_pos "
             f"{tuple(cur_pos.shape)} do not fit ({B}, {S})")
    if _check_common(name, q, k_cache, v_cache, k_scale, v_scale,
                     (slot_pos, cur_pos), hd, Hq, Hkv):
        _require(k_scale.shape == (B, S, Hkv) == v_scale.shape,
                 f"{name}: scales must be ({B}, {S}, {Hkv})")
    _require(all(t.data_ptr() % 16 == 0
                 and all(st * t.element_size() % 16 == 0
                         for st in t.stride()[:3])
                 for t in (k_cache, v_cache)),
             f"{name}: K/V rows must start on 16-byte boundaries (the "
             "kernel reads them in 16-byte vectors)")
    G = Hq // Hkv
    _require(G <= DECODE_MAX_GROUP,
             f"{name}: {G} query heads per kv head > {DECODE_MAX_GROUP}")
    return G


def _decode_launch(q, k_cache, v_cache, slot_pos, cur_pos, window, k_scale,
                   v_scale, S, n_split, out, partials):
    """Launch the decode kernel over the first S slots in n_split splits:
    into ``out`` (n_split 1, no partials), into ``partials`` (m, l, acc),
    or into both (then the merge kernel writes ``out``)."""
    name = "decode_attention"
    B, Hq, hd = q.shape
    Hkv = k_cache.shape[2]
    pm, pl, pacc = ((None,) * 3 if partials is None
                    else (t.data_ptr() for t in partials))
    lib = build.load(name)
    rc = lib.decode_attention_launch(
        _DTYPE_CODE[q.dtype], int(k_scale is not None), hd, B, Hkv, S,
        Hq // Hkv, int(window or 0), n_split, 1.0 / hd ** 0.5,
        q.data_ptr(), q.stride(0), q.stride(1),
        k_cache.data_ptr(), *k_cache.stride()[:3],
        v_cache.data_ptr(), *v_cache.stride()[:3],
        *_scale_args(k_scale), *_scale_args(v_scale),
        slot_pos.data_ptr(), *slot_pos.stride(),
        cur_pos.data_ptr(), cur_pos.stride(0),
        None if out is None else out.data_ptr(),
        *((0, 0) if out is None else out.stride()[:2]), pm, pl, pacc,
        torch.cuda.current_stream(q.device).cuda_stream)
    _launched(name, rc)


def _empty_partials(rows, n_split, hd, device):
    """Split partials m, l (*rows, n_split) and acc (*rows, n_split, hd)."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty((*rows, n_split), **f32),
            torch.empty((*rows, n_split), **f32),
            torch.empty((*rows, n_split, hd), **f32))


def decode_attention(q, k_cache, v_cache, slot_pos, cur_pos, *, window=None,
                     k_scale=None, v_scale=None, kv_limit=None):
    """Single-token GQA attention over the ring: q (B, Hq, hd); caches
    (B, S, Hkv, hd) in q's dtype, or int8 with ``k_scale``/``v_scale``
    (B, S, Hkv) f32; slot_pos (B, S) and cur_pos (B,) int32.  Reads the
    first ``kv_limit`` slots, in ``decode_splits`` splits merged on the
    device.  Returns (B, Hq, hd)."""
    _local_only("decode_attention", q, k_cache, v_cache, slot_pos, cur_pos,
                k_scale, v_scale)
    if q.device.type == "cpu":
        return ref.decode_attention(q, k_cache, v_cache, slot_pos, cur_pos,
                                    window=window, k_scale=k_scale,
                                    v_scale=v_scale, kv_limit=kv_limit)
    name = "decode_attention"
    _require(q.device.type == "cuda", f"{name}: no kernel for {q.device}")
    G = _check_decode(name, q, k_cache, v_cache, slot_pos, cur_pos, k_scale,
                      v_scale)
    B, Hq, hd = q.shape
    S = _limit(k_cache.shape[1], kv_limit)
    n = decode_splits(B, k_cache.shape[2], S, hd, G, k_cache.element_size())
    out = torch.empty((B, Hq, hd), dtype=q.dtype, device=q.device)
    _decode_launch(q, k_cache, v_cache, slot_pos, cur_pos, window, k_scale,
                   v_scale, S, n, out, None if n == 1 else
                   _empty_partials((B, Hq), n, hd, q.device))
    return out


def decode_attention_partials(q, k_cache, v_cache, slot_pos, cur_pos, *,
                              n_split, window=None, k_scale=None,
                              v_scale=None, kv_limit=None):
    """The split kernel's partials alone, for ``n_split`` splits of
    DECODE_TILE-slot tiles: f32 m, l (B, Hq, n_split) and acc (B, Hq,
    n_split, hd), as ``ref.decode_attention_partials`` defines them (the
    plain version for a CPU tensor)."""
    _local_only("decode_attention", q, k_cache, v_cache, slot_pos, cur_pos,
                k_scale, v_scale)
    if q.device.type == "cpu":
        return ref.decode_attention_partials(
            q, k_cache, v_cache, slot_pos, cur_pos, n_split=n_split,
            tile=DECODE_TILE, window=window, k_scale=k_scale,
            v_scale=v_scale, kv_limit=kv_limit)
    name = "decode_attention"
    _require(q.device.type == "cuda", f"{name}: no kernel for {q.device}")
    _check_decode(name, q, k_cache, v_cache, slot_pos, cur_pos, k_scale,
                  v_scale)
    S = _limit(k_cache.shape[1], kv_limit)
    ref.split_bounds(S, n_split, DECODE_TILE)  # raises on a bad count
    partials = _empty_partials(q.shape[:2], n_split, q.shape[2], q.device)
    _decode_launch(q, k_cache, v_cache, slot_pos, cur_pos, window, k_scale,
                   v_scale, S, n_split, None, partials)
    return partials


# the tensor-core pool kernel (csrc/flash_attention_pool.cu): packed rows a
# block, and ring slots a tile (a split is a run of whole tiles)
POOL_ROWS = 64


def pool_tile(hd: int) -> int:
    return 32 if hd >= 256 else 64


# blocks the pool kernel's split aims at: one round of two resident blocks
# an SM.  A block's tile loop is bound by its warps' latency, so a chunk of
# few row tiles (the pow-2 sub-chunks) runs its ring in parallel pieces;
# the partials stay within POOL_TARGET_BLOCKS x 64 rows (PERF.md)
POOL_TARGET_BLOCKS = 2 * DECODE_SMS


def pool_splits(B: int, Hkv: int, Sq: int, S: int, hd: int, G: int) -> int:
    """Splits of the ring for the bf16 pool kernel's grid (row tiles x
    splits, Hkv, B): as many as make POOL_TARGET_BLOCKS blocks, at most one
    a tile.  Shapes only."""
    blocks = -(-Sq * G // POOL_ROWS) * Hkv * B
    return max(1, min(POOL_TARGET_BLOCKS // blocks, -(-S // pool_tile(hd))))


def flash_attention_pool(q, k, v, pos_q, pos_kv, *, window=None,
                         k_scale=None, v_scale=None, kv_limit=None):
    """Chunk-vs-ring GQA attention: q (B, Hq, Sq, hd); K/V (B, Hkv, S, hd)
    in q's dtype, or int8 with scales (B, Hkv, S) f32; pos_q (B, Sq) and
    pos_kv (B, S) int32 (-1 = empty slot).  Reads the first ``kv_limit``
    slots, for bf16 q in ``pool_splits`` splits merged on the device.  The
    rows of q, K and V start on 16-byte boundaries.  Returns (B, Hq, Sq,
    hd)."""
    _local_only("flash_attention_pool", q, k, v, pos_q, pos_kv, k_scale,
                v_scale)
    if q.device.type == "cpu":
        return ref.flash_attention_pool(q, k, v, pos_q, pos_kv,
                                        window=window, k_scale=k_scale,
                                        v_scale=v_scale, kv_limit=kv_limit)
    name = "flash_attention_pool"
    _require(q.device.type == "cuda", f"{name}: no kernel for {q.device}")
    B, Hq, Sq, hd = q.shape
    _, Hkv, S, _ = k.shape
    _require(k.shape == (B, Hkv, S, hd) == v.shape,
             f"{name}: K/V shape {tuple(k.shape)}/{tuple(v.shape)} does not "
             f"fit q {tuple(q.shape)}")
    _require(pos_q.shape == (B, Sq) and pos_kv.shape == (B, S),
             f"{name}: pos_q {tuple(pos_q.shape)} / pos_kv "
             f"{tuple(pos_kv.shape)} do not fit ({B}, {Sq}) / ({B}, {S})")
    quant = _check_common(name, q, k, v, k_scale, v_scale, (pos_q, pos_kv),
                          hd, Hq, Hkv)
    if quant:
        _require(k_scale.shape == (B, Hkv, S) == v_scale.shape,
                 f"{name}: scales must be ({B}, {Hkv}, {S})")
    _require(all(_aligned16(t) for t in (q, k, v)),
             f"{name}: the rows of q, K and V must start on 16-byte "
             "boundaries (the kernel copies them in 16-byte vectors)")
    S = _limit(S, kv_limit)
    n = 1 if q.dtype == torch.float32 else \
        pool_splits(B, Hkv, Sq, S, hd, Hq // Hkv)
    return _pool_launch(q, k, v, pos_q, pos_kv, window, k_scale, v_scale, S,
                        n)


def _pool_launch(q, k, v, pos_q, pos_kv, window, k_scale, v_scale, S,
                 n_split):
    """Launch the pool kernel over the first S slots in n_split splits
    (bf16 q only past 1), then their merge; returns the output."""
    name = "flash_attention_pool"
    B, Hq, Sq, hd = q.shape
    Hkv = k.shape[1]
    out = torch.empty((B, Hq, Sq, hd), dtype=q.dtype, device=q.device)
    parts = (None,) * 3 if n_split == 1 else \
        _empty_partials((B, Hq, Sq), n_split, hd, q.device)
    lib = build.load(name)
    rc = lib.flash_attention_pool_launch(
        _DTYPE_CODE[q.dtype], int(k_scale is not None), hd, B, Hq, Sq, S,
        Hq // Hkv, int(window or 0), n_split, 1.0 / hd ** 0.5,
        q.data_ptr(), *q.stride()[:3],
        k.data_ptr(), *k.stride()[:3],
        v.data_ptr(), *v.stride()[:3],
        *_scale_args(k_scale), *_scale_args(v_scale),
        pos_q.data_ptr(), *pos_q.stride(),
        pos_kv.data_ptr(), *pos_kv.stride(),
        out.data_ptr(), *out.stride()[:3],
        *(None if t is None else t.data_ptr() for t in parts),
        torch.cuda.current_stream(q.device).cuda_stream)
    _launched(name, rc)
    return out


def _aligned16(t: torch.Tensor) -> int:
    """1 when every row of ``t`` (all axes but the last) starts on a
    16-byte boundary, so the kernel may read it in 16-byte vectors."""
    es = t.element_size()
    return int(t.data_ptr() % 16 == 0
               and all(st * es % 16 == 0 for st in t.stride()[:-1]))


def moe_gemm(x, w):
    """Grouped expert GEMM: x (E, C, d) @ w (E, d, f) -> (E, C, f) in
    x.dtype, f32 accumulation.  x and w share a dtype (float32 or
    bfloat16); the last axis of each has stride 1, the others any stride.
    C, d and f need not divide any tile."""
    _local_only("moe_gemm", x, w)
    if x.device.type == "cpu":
        return ref.moe_gemm(x, w)
    out, rc = moe_gemm_with(build.load("moe_gemm"), x, w)
    _launched("moe_gemm", rc)
    return out


def moe_gemm_with(lib, x, w, out_dtype=None):
    """``moe_gemm`` on CUDA tensors through ``lib``, a library with the
    expert GEMM's C entry point (the kernel, or a variant such as the one
    the kernel is held bitwise equal to), into an output of ``out_dtype``
    (x's by default).  Returns (out, the entry point's return code);
    counts no launch."""
    name = "moe_gemm"
    _local_only(name, x, w)
    _require(x.device.type == "cuda", f"{name}: no kernel for {x.device}")
    _require(w.device == x.device, f"{name}: w must be on {x.device}")
    _require(x.dtype in _DTYPE_CODE and w.dtype == x.dtype,
             f"{name}: x and w must both be float32 or bfloat16, got "
             f"{x.dtype}/{w.dtype}")
    _require(x.ndim == 3 and w.ndim == 3 and w.shape[0] == x.shape[0]
             and w.shape[1] == x.shape[2],
             f"{name}: shapes {tuple(x.shape)} @ {tuple(w.shape)} are not "
             "(E, C, d) @ (E, d, f)")
    E, C, d = x.shape
    f = w.shape[2]
    _require(min(E, C, d, f) >= 1 and E <= 65535,
             f"{name}: empty or too many experts: {tuple(x.shape)} @ "
             f"{tuple(w.shape)}")
    _require(x.stride(2) == 1 and w.stride(2) == 1,
             f"{name}: the last axis of x and w must have stride 1")
    out = torch.empty((E, C, f), dtype=out_dtype or x.dtype, device=x.device)
    rc = lib.moe_gemm_launch(
        _DTYPE_CODE[x.dtype], E, C, d, f,
        x.data_ptr(), x.stride(0), x.stride(1),
        w.data_ptr(), w.stride(0), w.stride(1),
        out.data_ptr(), out.stride(0), out.stride(1),
        _aligned16(x), _aligned16(w),
        torch.cuda.current_stream(x.device).cuda_stream)
    return out, rc


def rglru_scan(x, a_log, gate, h0):
    """RG-LRU recurrence ``h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (gate_t
    x_t)``, ``a = exp(a_log)``, from ``h0``: x and gate (B, S, W) float32 or
    bfloat16 (one dtype), a_log (B, S, W) and h0 (B, W) float32.  The W axis
    has stride 1, the others any stride.  Returns (h (B, S, W) in x.dtype,
    h_final (B, W) float32)."""
    _local_only("rglru_scan", x, a_log, gate, h0)
    if x.device.type == "cpu":
        return ref.rglru_scan(x, a_log, gate, h0)
    name = "rglru_scan"
    _require(x.device.type == "cuda", f"{name}: no kernel for {x.device}")
    _require(all(t.device == x.device for t in (a_log, gate, h0)),
             f"{name}: every tensor must be on {x.device}")
    _require(x.dtype in _DTYPE_CODE and gate.dtype == x.dtype,
             f"{name}: x and gate must both be float32 or bfloat16, got "
             f"{x.dtype}/{gate.dtype}")
    _require(a_log.dtype == torch.float32 and h0.dtype == torch.float32,
             f"{name}: a_log and h0 must be float32, got "
             f"{a_log.dtype}/{h0.dtype}")
    _require(x.ndim == 3 and a_log.shape == x.shape == gate.shape
             and h0.shape == (x.shape[0], x.shape[2]),
             f"{name}: shapes x {tuple(x.shape)}, a_log "
             f"{tuple(a_log.shape)}, gate {tuple(gate.shape)}, h0 "
             f"{tuple(h0.shape)} are not (B, S, W) x3 and (B, W)")
    B, S, W = x.shape
    _require(min(B, S, W) >= 1 and B <= 65535,
             f"{name}: empty or too many rows: {tuple(x.shape)}")
    _require(all(t.stride(-1) == 1 for t in (x, a_log, gate, h0)),
             f"{name}: the W axis must have stride 1")
    out = torch.empty((B, S, W), dtype=x.dtype, device=x.device)
    h_fin = torch.empty((B, W), dtype=torch.float32, device=x.device)
    n_part = rglru_scratch_floats(B, S, W)
    part = torch.empty(n_part, dtype=torch.float32, device=x.device) \
        if n_part else None
    n_blocks = -(-S // RGLRU_CHUNK) * -(-W // RGLRU_TILE_W) * B
    sync = _chunk_sync(name, x.device, n_blocks) if n_part else None
    lib = build.load(name)
    rc = lib.rglru_scan_launch(
        _DTYPE_CODE[x.dtype], B, S, W,
        x.data_ptr(), x.stride(0), x.stride(1),
        a_log.data_ptr(), a_log.stride(0), a_log.stride(1),
        gate.data_ptr(), gate.stride(0), gate.stride(1),
        h0.data_ptr(), h0.stride(0),
        out.data_ptr(), h_fin.data_ptr(),
        None if part is None else part.data_ptr(),
        *((None, 0, None, 0) if sync is None else sync.args()),
        torch.cuda.current_stream(x.device).cuda_stream)
    _launched(name, rc)
    if sync is not None:
        sync.taken += n_blocks
    return out, h_fin


def rglru_scratch_floats(B: int, S: int, W: int) -> int:
    """f32 scratch the RG-LRU kernel takes for (B, S, W) inputs in chunks
    of RGLRU_CHUNK tokens: for each row and channel, each chunk but the
    last its pair (prod a_t, the chunk's h from 0); 0 when S fits one
    chunk."""
    return 2 * B * W * (-(-S // RGLRU_CHUNK) - 1)


class _ChunkSync:
    """A chunked scan kernel's chunk-order bookkeeping on one device
    (``csrc/chunk_order.cuh``): a tile counter that every block of a
    multi-chunk launch advances once (``taken`` blocks so far), and a flag
    per (tile of the other axes, chunk) that the chunk's block sets to the
    launch's ``epoch`` once its contribution is written, so no flag needs
    clearing between launches.  A stream's launches run in the order they
    are issued, so each one's blocks take the tiles after the ``taken`` of
    those before it: the bookkeeping is kept per (kernel, device, stream),
    so launches in flight on two streams at once never share a counter or
    a flag, and none may be captured in a graph."""

    def __init__(self, device, n_flags: int):
        self.tiles = torch.zeros(1, dtype=torch.int64, device=device)
        self.flags = torch.zeros(n_flags, dtype=torch.int32, device=device)
        self.taken = 0
        self.epoch = 0

    def args(self):
        """The C entry points' (tiles, tile_base, flags, epoch)."""
        return (self.tiles.data_ptr(), self.taken, self.flags.data_ptr(),
                self.epoch)


_CHUNK_SYNC = {}


def _chunk_sync_key(name: str, device) -> tuple:
    """``_CHUNK_SYNC``'s key of kernel ``name`` launching on ``device``:
    with the device's current stream on a GPU (a staged prefill runs its
    scans on a stream of its own beside decode's, DESIGN.md §14)."""
    device = torch.device(device)
    if device.type != "cuda":
        return name, device, None
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return name, device, torch.cuda.current_stream(device).stream_id


def _chunk_sync(name: str, device, n_flags: int) -> _ChunkSync:
    """Kernel ``name``'s bookkeeping on ``device`` and its current stream
    for a launch of ``n_flags`` chunk blocks, its epoch advanced (fresh
    buffers where the flags are too few, or the epoch would wrap).  Each
    kernel keeps its own."""
    if torch.device(device).type == "cuda" \
            and torch.cuda.is_current_stream_capturing():
        # the epoch and the tiles taken are launch arguments from the host:
        # a replayed graph would reuse them stale (ROADMAP queue 1, item 13)
        raise RuntimeError(f"{name}: the chunked kernel cannot be captured "
                           "in a CUDA graph")
    key = _chunk_sync_key(name, device)
    sync = _CHUNK_SYNC.get(key)
    if sync is None or sync.flags.numel() < n_flags \
            or sync.epoch >= 2 ** 31 - 1:
        sync = _CHUNK_SYNC[key] = _ChunkSync(device, n_flags)
    sync.epoch += 1
    return sync


def rwkv6_scratch_floats(B: int, H: int, S: int, D: int) -> int:
    """f32 scratch the WKV6 kernel takes for (B, H, S, D) inputs: for each
    (row, head), each chunk but the last its state contribution (D x D)
    and decay (D); 0 when S fits one chunk."""
    return B * H * (-(-S // RWKV6_CHUNK) - 1) * (D * D + D)


def rwkv6_scan(r, k, v, w_log, u, state0=None):
    """WKV6 from ``state0`` (zeros when None, which is the Pallas
    ``rwkv6_scan``; a state is what ``rwkv6_apply`` folds in):
    ``o_t = r_t (S + diag(u) k_t^T v_t)``, ``S <- diag(e^{w_t}) S + k_t^T
    v_t``.  r/k/v (B, H, S, D) float32 or bfloat16 (one dtype); w_log the
    same shape, float32; u (H, 1, D) or (B, H, 1, D); state0 (B, H, D, D)
    float32.  The D axis has stride 1, the others any stride.  Returns (out
    (B, H, S, D) in r.dtype, final state (B, H, D, D) float32)."""
    name = "rwkv6_scan"
    _local_only(name, r, k, v, w_log, u, state0)
    _require(r.ndim == 4 and k.shape == r.shape == v.shape == w_log.shape,
             f"{name}: r/k/v/w_log {tuple(r.shape)}/{tuple(k.shape)}/"
             f"{tuple(v.shape)}/{tuple(w_log.shape)} are not one "
             "(B, H, S, D) shape")
    if r.device.type == "cpu":
        return ref.rwkv6_scan(r, k, v, w_log, u, state0)
    _require(r.device.type == "cuda", f"{name}: no kernel for {r.device}")
    tensors = [k, v, w_log, u] + ([] if state0 is None else [state0])
    _require(all(t.device == r.device for t in tensors),
             f"{name}: every tensor must be on {r.device}")
    _require(r.dtype in _DTYPE_CODE and k.dtype == r.dtype == v.dtype,
             f"{name}: r, k and v must all be float32 or bfloat16, got "
             f"{r.dtype}/{k.dtype}/{v.dtype}")
    _require(w_log.dtype == torch.float32
             and (state0 is None or state0.dtype == torch.float32),
             f"{name}: w_log and state0 must be float32")
    B, H, S, D = r.shape
    _require(D in RWKV6_HEAD_DIMS,
             f"{name}: head size {D} not in {RWKV6_HEAD_DIMS}")
    _require(S >= 1 and B <= 65535 and H <= 65535,
             f"{name}: empty or too many rows: {tuple(r.shape)}")
    if u.dtype not in (torch.float32, r.dtype):
        u = u.float()
    uu = u.expand(B, H, 1, D)[:, :, 0]  # strides 0 where broadcast
    if state0 is not None:
        _require(state0.shape == (B, H, D, D),
                 f"{name}: state0 {tuple(state0.shape)} is not "
                 f"{(B, H, D, D)}")
    _require(all(t.stride(-1) == 1 for t in (r, k, v, w_log, uu)
                 + (() if state0 is None else (state0,))),
             f"{name}: the D axis must have stride 1")
    out = torch.empty_like(r)  # the layout of r: free to reshape back
    s_out = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    s0 = (None, 0, 0, 0) if state0 is None else (
        state0.data_ptr(), *state0.stride()[:3])
    n_part = rwkv6_scratch_floats(B, H, S, D)
    part = torch.empty(n_part, dtype=torch.float32, device=r.device) \
        if n_part else None
    sync = _chunk_sync(name, r.device, B * H * -(-S // RWKV6_CHUNK)) \
        if n_part else None
    lib = build.load(name)
    rc = lib.rwkv6_scan_launch(
        _DTYPE_CODE[r.dtype], D, B, H, S,
        r.data_ptr(), *r.stride()[:3],
        k.data_ptr(), *k.stride()[:3],
        v.data_ptr(), *v.stride()[:3],
        w_log.data_ptr(), *w_log.stride()[:3],
        uu.data_ptr(), uu.stride(0), uu.stride(1),
        *s0,
        out.data_ptr(), *out.stride()[:3],
        s_out.data_ptr(), None if part is None else part.data_ptr(),
        *((None, 0, None, 0) if sync is None else sync.args()),
        int(uu.dtype == torch.float32),
        int(state0 is not None and _aligned16(state0)),
        torch.cuda.current_stream(r.device).cuda_stream)
    _launched(name, rc)
    if sync is not None:
        sync.taken += n_part // (D * D + D) + B * H  # every chunk's block
    return out, s_out


def _check_flash(name, q, k, v, window, more=()):
    """Shapes, dtypes, devices and strides the flash kernels take: q
    (B, Hq, Sq, hd), K/V (B, Hkv, Skv, hd), one dtype, head_dim stride 1,
    and ``more`` tensors shaped like q."""
    _require(q.ndim == 4 and k.ndim == 4 and k.shape == v.shape
             and k.shape[0] == q.shape[0] and k.shape[3] == q.shape[3],
             f"{name}: q {tuple(q.shape)} and K/V {tuple(k.shape)}/"
             f"{tuple(v.shape)} are not (B, Hq, Sq, hd) and (B, Hkv, Skv, "
             "hd)")
    B, Hq, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    _require(all(t.device == q.device for t in (k, v, *more)),
             f"{name}: every tensor must be on {q.device}")
    _require(q.dtype in _DTYPE_CODE
             and all(t.dtype == q.dtype for t in (k, v, *more)),
             f"{name}: q, K, V (and d_out) must share float32 or bfloat16")
    _require(all(t.shape == q.shape for t in more),
             f"{name}: out and d_out must have q's shape {tuple(q.shape)}")
    _require(hd in HEAD_DIMS, f"{name}: head_dim {hd} not in {HEAD_DIMS}")
    _require(Hkv >= 1 and Hq % Hkv == 0,
             f"{name}: {Hq} query heads are not a multiple of {Hkv} kv heads")
    _require(min(B, Sq, Skv) >= 1 and B <= 65535 and Hq <= 65535,
             f"{name}: empty or too many rows: q {tuple(q.shape)}")
    _require(window is None or int(window) >= 1,
             f"{name}: window must be None or >= 1, got {window}")
    _require(all(t.stride(-1) == 1 for t in (q, k, v, *more)),
             f"{name}: the head_dim axis must have stride 1")
    return B, Hq, Sq, Skv, hd, Hq // Hkv


def flash_attention(q, k, v, *, causal=True, window=None, pos_base=0,
                    return_lse=False):
    """Contiguous causal / windowed GQA attention
    (``repro.kernels.flash_attention.flash_attention``): q (B, Hq, Sq, hd),
    K/V (B, Hkv, Skv, hd), float32 or bfloat16, any strides but a unit
    head_dim stride (the model passes (B, S, H, hd) transposes).  Queries
    and keys both start at ``pos_base``, which cancels in the masks.
    Returns out in q's dtype and layout, and with ``return_lse`` also the
    f32 log-sum-exp (B, Hq, Sq) of each query's scaled scores.  A query
    with no valid key (only where Sq > Skv, or with a window) is where the
    two references part: the oracle (and the plain version) averages V
    over every key, the Pallas kernel over the tiles it did not skip; the
    CUDA kernel does as the Pallas kernel, with its own 32-key tiles (0
    where it skipped them all)."""
    _local_only("flash_attention", q, k, v)
    if q.device.type == "cpu":
        out, lse = ref.flash_attention_lse(q, k, v, causal=causal,
                                           window=window, pos_base=pos_base)
        return (out, lse) if return_lse else out
    name = "flash_attention"
    _require(q.device.type == "cuda", f"{name}: no kernel for {q.device}")
    B, Hq, Sq, Skv, hd, G = _check_flash(name, q, k, v, window)
    out = torch.empty_like(q)  # q's strides where q is dense
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    lib = build.load(name)
    rc = lib.flash_attention_launch(
        _DTYPE_CODE[q.dtype], hd, B, Hq, Sq, Skv, G, int(causal),
        int(window or 0), 1.0 / hd ** 0.5,
        q.data_ptr(), *q.stride()[:3],
        k.data_ptr(), *k.stride()[:3],
        v.data_ptr(), *v.stride()[:3],
        out.data_ptr(), *out.stride()[:3],
        None if lse is None else lse.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    _launched(name, rc)
    return (out, lse) if return_lse else out


def flash_attention_bwd(q, k, v, out, lse, d_out, *, causal=True,
                        window=None):
    """The gradient of ``flash_attention`` (FA2 form): from its inputs, its
    output, its f32 ``lse`` (B, Hq, Sq) and ``d_out`` (q's shape and
    dtype), returns (dq, dk, dv) in the layouts of q, k and v.  The row sums
    delta = rowsum(d_out o out) are one torch reduction here; every matrix
    product is the kernel's."""
    _local_only("flash_attention_bwd", q, k, v, out, lse, d_out)
    if q.device.type == "cpu":
        return ref.flash_attention_bwd(q, k, v, out, lse, d_out,
                                       causal=causal, window=window)
    name = "flash_attention_bwd"
    _require(q.device.type == "cuda", f"{name}: no kernel for {q.device}")
    B, Hq, Sq, Skv, hd, G = _check_flash(name, q, k, v, window,
                                         more=(out, d_out))
    _require(lse.shape == (B, Hq, Sq) and lse.dtype == torch.float32
             and lse.is_contiguous() and lse.device == q.device,
             f"{name}: lse must be contiguous float32 ({B}, {Hq}, {Sq})")
    delta = (d_out.float() * out.float()).sum(-1)  # (B, Hq, Sq) contiguous
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = build.load(name)
    rc = lib.flash_attention_bwd_launch(
        _DTYPE_CODE[q.dtype], hd, B, Hq, Sq, Skv, G, int(causal),
        int(window or 0), 1.0 / hd ** 0.5,
        q.data_ptr(), *q.stride()[:3],
        k.data_ptr(), *k.stride()[:3],
        v.data_ptr(), *v.stride()[:3],
        d_out.data_ptr(), *d_out.stride()[:3],
        lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), *dq.stride()[:3],
        dk.data_ptr(), *dk.stride()[:3],
        dv.data_ptr(), *dv.stride()[:3],
        torch.cuda.current_stream(q.device).cuda_stream)
    _launched(name, rc)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """``flash_attention`` whose gradient is ``flash_attention_bwd``: the
    forward saves q, K, V, out and the lse; the backward launches the
    backward kernel (the plain versions for CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        if d_out.stride(-1) != 1:
            d_out = d_out.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, d_out,
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention_train(q, k, v, *, causal=True, window=None):
    """Differentiable ``flash_attention`` (same layouts): one forward
    launch, and one backward launch when the graph is differentiated."""
    _local_only("flash_attention", q, k, v)
    return _FlashAttention.apply(q, k, v, causal, window)
