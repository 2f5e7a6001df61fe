"""Wrappers of the CUDA kernels: the two attention kernels and the grouped
expert GEMM of the MoE FFN.

A CPU tensor goes to the kernel's plain version in ``ref``; a CUDA tensor
goes to the kernel or raises — there is no fallback.  Each wrapper checks
device, dtype, shapes and the innermost stride, allocates the output,
launches on PyTorch's current stream and raises if the launch was refused.
Other strides are passed through, so pool row views, ring prefixes,
(B, C, H, hd) -> (B, H, C, hd) transposes and the MoE dispatch buffer's
capacity slice need no copy.

``LAUNCHES`` counts kernel launches per kernel (plain integers, incremented
only where a kernel is launched), so a run can show that its main path went
through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"decode_attention": 0, "flash_attention_pool": 0, "moe_gemm": 0}
HEAD_DIMS = (32, 64, 128)
DECODE_MAX_GROUP = 16  # query heads per kv head the decode kernel takes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


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


def decode_attention(q, k_cache, v_cache, slot_pos, cur_pos, *, window=None,
                     k_scale=None, v_scale=None, kv_limit=None):
    """Single-token GQA attention over the ring: q (B, Hq, hd); caches
    (B, S, Hkv, hd) in q's dtype, or int8 with ``k_scale``/``v_scale``
    (B, S, Hkv) f32; slot_pos (B, S) and cur_pos (B,) int32.  Reads the
    first ``kv_limit`` slots.  Returns (B, Hq, hd)."""
    if q.device.type == "cpu":
        return ref.decode_attention(q, k_cache, v_cache, slot_pos, cur_pos,
                                    window=window, k_scale=k_scale,
                                    v_scale=v_scale, kv_limit=kv_limit)
    name = "decode_attention"
    _require(q.device.type == "cuda", f"{name}: no kernel for {q.device}")
    B, Hq, hd = q.shape
    _, S, Hkv, _ = k_cache.shape
    _require(k_cache.shape == (B, S, Hkv, hd) == v_cache.shape,
             f"{name}: K/V shape {tuple(k_cache.shape)}/"
             f"{tuple(v_cache.shape)} does not fit q {tuple(q.shape)}")
    _require(slot_pos.shape == (B, S) and cur_pos.shape == (B,),
             f"{name}: slot_pos {tuple(slot_pos.shape)} / cur_pos "
             f"{tuple(cur_pos.shape)} do not fit ({B}, {S})")
    quant = _check_common(name, q, k_cache, v_cache, k_scale, v_scale,
                          (slot_pos, cur_pos), hd, Hq, Hkv)
    if quant:
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
    out = torch.empty((B, Hq, hd), dtype=q.dtype, device=q.device)
    lib = build.load(name)
    rc = lib.decode_attention_launch(
        _DTYPE_CODE[q.dtype], int(quant), hd, B, Hkv, _limit(S, kv_limit), G,
        int(window or 0), 1.0 / hd ** 0.5,
        q.data_ptr(), q.stride(0), q.stride(1),
        k_cache.data_ptr(), *k_cache.stride()[:3],
        v_cache.data_ptr(), *v_cache.stride()[:3],
        *_scale_args(k_scale), *_scale_args(v_scale),
        slot_pos.data_ptr(), *slot_pos.stride(),
        cur_pos.data_ptr(), cur_pos.stride(0),
        out.data_ptr(), out.stride(0), out.stride(1),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
    LAUNCHES[name] += 1
    return out


def flash_attention_pool(q, k, v, pos_q, pos_kv, *, window=None,
                         k_scale=None, v_scale=None, kv_limit=None):
    """Chunk-vs-ring GQA attention: q (B, Hq, Sq, hd); K/V (B, Hkv, S, hd)
    in q's dtype, or int8 with scales (B, Hkv, S) f32; pos_q (B, Sq) and
    pos_kv (B, S) int32 (-1 = empty slot).  Reads the first ``kv_limit``
    slots.  Returns (B, Hq, Sq, hd)."""
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
    out = torch.empty((B, Hq, Sq, hd), dtype=q.dtype, device=q.device)
    lib = build.load(name)
    rc = lib.flash_attention_pool_launch(
        _DTYPE_CODE[q.dtype], int(quant), hd, B, Hq, Sq, _limit(S, kv_limit),
        Hq // Hkv, int(window or 0), 1.0 / hd ** 0.5,
        q.data_ptr(), *q.stride()[:3],
        k.data_ptr(), *k.stride()[:3],
        v.data_ptr(), *v.stride()[:3],
        *_scale_args(k_scale), *_scale_args(v_scale),
        pos_q.data_ptr(), *pos_q.stride(),
        pos_kv.data_ptr(), *pos_kv.stride(),
        out.data_ptr(), *out.stride()[:3],
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
    LAUNCHES[name] += 1
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
    if x.device.type == "cpu":
        return ref.moe_gemm(x, w)
    name = "moe_gemm"
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
    out = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
    lib = build.load(name)
    rc = lib.moe_gemm_launch(
        _DTYPE_CODE[x.dtype], E, C, d, f,
        x.data_ptr(), x.stride(0), x.stride(1),
        w.data_ptr(), w.stride(0), w.stride(1),
        out.data_ptr(), out.stride(0), out.stride(1),
        _aligned16(x), _aligned16(w),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
    LAUNCHES[name] += 1
    return out
