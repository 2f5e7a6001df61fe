"""PyTorch port: the attention and scan kernels' plain versions against
the JAX reference (``repro.kernels.ref`` / the XLA attention and the Pallas
kernels in interpret mode); the CUDA kernels are held to these plain
versions on a card in tests/test_torch_cuda.py.

Inputs are made with numpy from a seed and handed to both frameworks.
Tolerance for attention: 2e-5 in f32 — the reference's own
kernel-vs-oracle tolerance (tests/test_kernels.py); only the summation
order differs.  The scans' tolerances stand beside their tests."""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as JA
from repro.models import dequantize_kv as j_dequantize_kv
from repro.models import quantize_kv as j_quantize_kv
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as TA
from torch_attention_cases import (DECODE_CASES, POOL_CASES, decode_case,
                                   pool_call, pool_case, ring, to_torch)
from torch_recurrent_cases import (RGLRU_CASES, RWKV6_CASES, rglru_case,
                                   rwkv6_case)

TOL = 2e-5


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_plain_matches_reference(case):
    q, kc, vc, sp, cur, kw = decode_case(case)
    kvl = kw.pop("kv_limit", None)
    # reference: XLA decode attention on the truncated view, and the Pallas
    # kernel in interpret mode with the static kv_limit
    S = kc.shape[1] if kvl is None else kvl
    want = JA.decode_attention(jnp.asarray(q), jnp.asarray(kc[:, :S]),
                               jnp.asarray(vc[:, :S]), jnp.asarray(sp[:, :S]),
                               jnp.asarray(cur), **kw)
    pallas = jops.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                   jnp.asarray(vc), jnp.asarray(sp),
                                   jnp.asarray(cur), kv_limit=kvl,
                                   block_k=16, **kw)
    tq, tk, tv, tsp, tcur = to_torch(q, kc, vc, sp, cur)
    got = ops.decode_attention(tq, tk, tv, tsp, tcur, kv_limit=kvl, **kw)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), _np(pallas), rtol=TOL, atol=TOL)
    model = TA.decode_attention(tq, tk[:, :S], tv[:, :S], tsp[:, :S], tcur,
                                **kw)
    np.testing.assert_allclose(got.numpy(), model.numpy(), rtol=TOL,
                               atol=TOL)


def test_decode_plain_int8_matches_reference():
    B, Hq, Hkv, S, hd = 2, 8, 2, 64, 32
    kc, vc, sp = ring(13, B, S, Hkv, hd, np.broadcast_to(np.arange(S), (B, S)))
    q = np.random.default_rng(14).standard_normal((B, Hq, hd),
                                                  dtype=np.float32)
    cur = np.full((B,), S - 1, np.int32)
    jqk, jks = j_quantize_kv(jnp.asarray(kc))
    jqv, jvs = j_quantize_kv(jnp.asarray(vc))
    pallas = jops.decode_attention(jnp.asarray(q), jqk, jqv, jnp.asarray(sp),
                                   jnp.asarray(cur), k_scale=jks,
                                   v_scale=jvs, block_k=16)
    want = JA.decode_attention(jnp.asarray(q), j_dequantize_kv(jqk, jks),
                               j_dequantize_kv(jqv, jvs), jnp.asarray(sp),
                               jnp.asarray(cur))
    tqk, tks, tqv, tvs = to_torch(np.asarray(jqk), np.asarray(jks),
                            np.asarray(jqv), np.asarray(jvs))
    tq, tsp, tcur = to_torch(q, sp, cur)
    got = ops.decode_attention(tq, tqk, tqv, tsp, tcur, k_scale=tks,
                               v_scale=tvs)
    np.testing.assert_allclose(got.numpy(), _np(pallas), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)


def _j_pool(q, k, v, pos_q, pos_kv, **kw):
    o = jops.flash_attention_pool(jnp.swapaxes(q, 1, 2),
                                  jnp.swapaxes(k, 1, 2),
                                  jnp.swapaxes(v, 1, 2), pos_q, pos_kv,
                                  block_q=8, block_k=8, **kw)
    return jnp.swapaxes(o, 1, 2)




@pytest.mark.parametrize("case", POOL_CASES)
def test_pool_plain_matches_reference(case):
    q, kc, vc, sp, pos_q, kw = pool_case(case)
    kvl = kw.get("kv_limit")
    S = kc.shape[1] if kvl is None else kvl
    win = kw.get("window")
    want = JA.chunked_attention(jnp.asarray(q), jnp.asarray(kc[:, :S]),
                                jnp.asarray(vc[:, :S]), causal=True,
                                window=win, pos_q=jnp.asarray(pos_q),
                                pos_kv=jnp.asarray(sp[:, :S]), q_chunk=8,
                                kv_chunk=8)
    pallas = _j_pool(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                     jnp.asarray(pos_q), jnp.asarray(sp), **kw)
    tq, tk, tv, tsp, tpq = to_torch(q, kc, vc, sp, pos_q)
    got = pool_call(tq, tk, tv, tpq, tsp, **kw)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), _np(pallas), rtol=TOL, atol=TOL)
    model = TA.chunked_attention(tq, tk[:, :S], tv[:, :S], causal=True,
                                 window=win, pos_q=tpq, pos_kv=tsp[:, :S],
                                 q_chunk=8, kv_chunk=8)
    np.testing.assert_allclose(got.numpy(), model.numpy(), rtol=TOL,
                               atol=TOL)


def test_pool_plain_int8_matches_reference():
    q, kc, vc, sp, pos_q, kw = pool_case("kv_limit")
    jqk, jks = j_quantize_kv(jnp.asarray(kc))
    jqv, jvs = j_quantize_kv(jnp.asarray(vc))
    pallas = _j_pool(jnp.asarray(q), jqk, jqv, jnp.asarray(pos_q),
                     jnp.asarray(sp), k_scale=jnp.swapaxes(jks, 1, 2),
                     v_scale=jnp.swapaxes(jvs, 1, 2), **kw)
    tqk, tks, tqv, tvs = to_torch(np.asarray(jqk), np.asarray(jks),
                            np.asarray(jqv), np.asarray(jvs))
    tq, tsp, tpq = to_torch(q, sp, pos_q)
    got = pool_call(tq, tqk, tqv, tpq, tsp, k_scale=tks.transpose(1, 2),
                  v_scale=tvs.transpose(1, 2), **kw)
    np.testing.assert_allclose(got.numpy(), _np(pallas), rtol=TOL, atol=TOL)


def test_plain_versions_take_pool_row_views():
    """A row view of a larger pool and its ring prefix (strided, not
    contiguous) give what contiguous copies give."""
    q, kc, vc, sp, cur, _ = decode_case("per_batch_positions")
    rng = np.random.default_rng(3)
    pool_k = torch.from_numpy(rng.standard_normal(
        (5,) + kc.shape[1:], dtype=np.float32))
    pool_v = pool_k.clone()
    pool_sp = torch.full((5, kc.shape[1]), -1, dtype=torch.int32)
    pool_k[1:4], pool_v[1:4], pool_sp[1:4] = to_torch(kc, vc, sp)
    tq, tcur = to_torch(q, cur)
    view = ops.decode_attention(tq, pool_k[1:4, :48], pool_v[1:4, :48],
                                pool_sp[1:4, :48], tcur)
    assert not pool_k[1:4, :48].is_contiguous()
    dense = ops.decode_attention(tq, *to_torch(kc[:, :48], vc[:, :48], sp[:, :48]),
                                 tcur)
    assert torch.equal(view, dense)


# -- the split form of decode ---------------------------------------------------
# The decode kernel's plain split form: ref.decode_attention_partials (what
# each split of the kernel's grid writes) composed with ref.merge_partials
# (the merge kernel), held to the JAX reference at the file's TOL.  The
# tiny cases' rings hold 16-64 slots, less than the kernel's 64-slot tile,
# so the splits here are made of SPLIT_TILE-slot tiles: the partition rule
# (ref.split_bounds) is the kernel's, only the tile is smaller.
SPLIT_TILE = 4


@functools.lru_cache(maxsize=None)
def _decode_reference(case):
    """(XLA on the truncated view, Pallas in interpret mode) for a case."""
    q, kc, vc, sp, cur, kw = decode_case(case)
    kvl = kw.pop("kv_limit", None)
    S = kc.shape[1] if kvl is None else kvl
    want = JA.decode_attention(jnp.asarray(q), jnp.asarray(kc[:, :S]),
                               jnp.asarray(vc[:, :S]), jnp.asarray(sp[:, :S]),
                               jnp.asarray(cur), **kw)
    pallas = jops.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                   jnp.asarray(vc), jnp.asarray(sp),
                                   jnp.asarray(cur), kv_limit=kvl,
                                   block_k=16, **kw)
    return _np(want), _np(pallas)


def _split_counts(S):
    return {"1": 1, "2": 2, "3": 3, "most": -(-S // SPLIT_TILE)}


@pytest.mark.parametrize("n", ["1", "2", "3", "most"])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_partials_merge_match_reference(case, n):
    q, kc, vc, sp, cur, kw = decode_case(case)
    S = kw.get("kv_limit") or kc.shape[1]
    n_split = _split_counts(S)[n]
    tq, tk, tv, tsp, tcur = to_torch(q, kc, vc, sp, cur)
    before = dict(ops.LAUNCHES)
    m, l, acc = ref.decode_attention_partials(tq, tk, tv, tsp, tcur,
                                              n_split=n_split,
                                              tile=SPLIT_TILE, **kw)
    B, Hq, hd = q.shape
    assert m.shape == l.shape == (B, Hq, n_split)
    assert acc.shape == (B, Hq, n_split, hd)
    got = ref.merge_partials(m, l, acc).numpy()
    want, pallas = _decode_reference(case)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)
    assert ops.LAUNCHES == before


def test_decode_partials_fully_masked_split_adds_nothing():
    """Row 0 of ``per_batch_positions`` sees positions 0..5 only, so most
    of its 16 splits hold masked slots alone: their m is -1e30, and merged
    they weigh nothing; the ``masked_row`` case's second row has no valid
    slot at all and merges to the mean of V over the S slots."""
    q, kc, vc, sp, cur, kw = decode_case("per_batch_positions")
    tq, tk, tv, tsp, tcur = to_torch(q, kc, vc, sp, cur)
    m, l, acc = ref.decode_attention_partials(tq, tk, tv, tsp, tcur,
                                              n_split=16, tile=SPLIT_TILE)
    assert torch.all(m[0, :, 2:] == ref.NEG_INF)
    assert torch.all(m[0, :, :2] > ref.NEG_INF)
    live = ref.merge_partials(m[:, :, :2], l[:, :, :2], acc[:, :, :2])
    np.testing.assert_allclose(ref.merge_partials(m, l, acc)[0].numpy(),
                               live[0].numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ref.merge_partials(m, l, acc).numpy(),
                               _decode_reference("per_batch_positions")[0],
                               rtol=TOL, atol=TOL)
    q, kc, vc, sp, cur, kw = decode_case("masked_row")
    tq, tk, tv, tsp, tcur = to_torch(q, kc, vc, sp, cur)
    m, l, acc = ref.decode_attention_partials(tq, tk, tv, tsp, tcur,
                                              n_split=3, tile=SPLIT_TILE)
    assert torch.all(m[1] == ref.NEG_INF)
    mean_v = tv[1].mean(0).repeat_interleave(q.shape[1] // kc.shape[2], 0)
    np.testing.assert_allclose(ref.merge_partials(m, l, acc)[1].numpy(),
                               mean_v.numpy(), rtol=TOL, atol=TOL)


def test_split_bounds_refuses_empty_splits():
    with pytest.raises(ValueError):
        ref.split_bounds(64, 2, 64)
    with pytest.raises(ValueError):
        ref.split_bounds(64, 0, 4)


# (B, Hkv, S, hd, G, K/V bytes an element): the serving paths' decode
# shapes (llama3.2-3b at B 16, 4 and 1; qwen2-moe-a2.7b; recurrentgemma-9b
# at head_dim 256; int8 pools), the elastic kv_limit's small powers of two,
# and ragged S
SPLIT_SHAPES = [(16, 8, 2048, 128, 3, 2), (4, 8, 2048, 128, 3, 2),
                (1, 8, 2048, 128, 3, 2), (16, 16, 2048, 128, 1, 2),
                (16, 1, 2048, 256, 16, 2), (16, 1, 1024, 256, 16, 2),
                (16, 8, 2048, 128, 3, 1), (2, 2, 64, 32, 2, 2),
                (3, 8, 40, 128, 3, 2), (1, 1, 1000, 64, 16, 1),
                (1, 4, 130, 128, 4, 4), (64, 8, 4096, 128, 3, 2)]


@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_decode_splits_properties(shape):
    """The split count depends on shapes only, every split holds at least
    one tile, the splits cover the S slots exactly, the partials' bytes stay
    within their share of the K/V bytes, and the grid fills one round of
    resident blocks (and no more) unless a tile per split or that share
    stops it."""
    B, Hkv, S, hd, G, kv_size = shape
    n = ops.decode_splits(*shape)
    assert isinstance(n, int) and n == ops.decode_splits(*shape)
    tile = ops.DECODE_TILE
    bounds = ref.split_bounds(S, n, tile)
    assert bounds[0][0] == 0 and bounds[-1][1] == S
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all(lo % tile == 0 and hi > lo for lo, hi in bounds)
    assert all(hi % tile == 0 for _, hi in bounds[:-1])

    def partial_share(k):
        return (B * G * Hkv * k * (hd + 2) * 8) / (2 * B * S * Hkv * hd
                                                    * kv_size)
    assert n == 1 or partial_share(n) <= ops.PARTIAL_SHARE
    resident = ops.DECODE_SMS * (1 if hd >= 256 else 2)
    assert B * Hkv * n <= max(resident, B * Hkv)
    assert (B * Hkv * (n + 1) > resident or n == -(-S // tile)
            or partial_share(n + 1) > ops.PARTIAL_SHARE)


# (B, Hkv, Sq, S, hd, G): the serving paths' prefill chunks (llama3.2-3b
# at C 512 down to its pow-2 sub-chunks, qwen2-moe-a2.7b, recurrentgemma-9b
# at head_dim 256), a batch of rows, and rings below one tile
POOL_SPLIT_SHAPES = [(1, 8, 512, 2048, 128, 3), (1, 8, 128, 2048, 128, 3),
                     (1, 8, 16, 2048, 128, 3), (1, 8, 2, 2048, 128, 3),
                     (1, 16, 512, 2048, 128, 1), (1, 1, 512, 2048, 256, 16),
                     (1, 1, 128, 1024, 256, 16), (4, 8, 64, 2048, 64, 3),
                     (2, 2, 17, 40, 32, 2), (1, 4, 700, 100, 128, 4)]


@pytest.mark.parametrize("shape", POOL_SPLIT_SHAPES)
def test_pool_splits_properties(shape):
    """The pool split count depends on shapes only, every split holds at
    least one tile, and the grid reaches POOL_TARGET_BLOCKS blocks (and no
    more) unless a tile per split stops it."""
    B, Hkv, Sq, S, hd, G = shape
    n = ops.pool_splits(*shape)
    assert isinstance(n, int) and n == ops.pool_splits(*shape)
    tiles = -(-S // ops.pool_tile(hd))
    bounds = ref.split_bounds(S, n, ops.pool_tile(hd))
    assert bounds[0][0] == 0 and bounds[-1][1] == S and len(bounds) == n
    blocks = -(-Sq * G // ops.POOL_ROWS) * Hkv * B
    assert blocks * n <= max(ops.POOL_TARGET_BLOCKS, blocks)
    assert blocks * (n + 1) > ops.POOL_TARGET_BLOCKS or n == tiles


def test_decode_splits_spread_recurrentgemma_mqa():
    """recurrentgemma-9b decodes at Hkv 1: one block a row without splits;
    the split count takes its 16 rows to 8 blocks a row, one on nearly
    every SM."""
    assert ops.decode_splits(16, 1, 2048, 256, 16) == 8


def test_wrappers_raise_off_cpu_without_kernel():
    """Only a CPU tensor reaches the plain version: any other device must
    reach a kernel or raise (here: no kernel for the meta device)."""
    q = torch.empty((1, 4, 32), device="meta")
    k = torch.empty((1, 8, 2, 32), device="meta")
    sp = torch.empty((1, 8), dtype=torch.int32, device="meta")
    cur = torch.empty((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.decode_attention(q, k, k, sp, cur)
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention_pool(q[:, :, None], k.transpose(1, 2),
                                 k.transpose(1, 2), sp[:, :1], sp)


# -- the recurrent scans ------------------------------------------------------
# The plain versions (what ops.rglru_scan / ops.rwkv6_scan run for CPU
# tensors, and what the CUDA kernels are held to on the card) against the
# Pallas kernels in interpret mode, ops.rwkv6_apply with a nonzero initial
# state, and the per-timestep oracles of repro.kernels.ref.  Tolerances:
# 1e-5 where both sides run the same per-timestep recurrence in f32
# (summation order only); 2e-3 against the Pallas WKV6 kernel, the
# reference's own kernel-vs-oracle tolerance (its chunked log-space form
# rounds differently).
def _t(*xs):
    return [torch.from_numpy(np.array(x, copy=True)) for x in xs]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("B,S,W", RGLRU_CASES)
def test_rglru_scan_plain_matches_pallas_and_oracle(B, S, W):
    x, a, g, h0 = rglru_case(B, S, W)
    jx = [jnp.asarray(t) for t in (x, a, g, h0)]
    p_h, p_f = jops.rglru_scan(*jx)  # Pallas, interpret mode on the CPU
    o_h, o_f = jref.rglru_scan_ref(*jx)
    before = dict(ops.LAUNCHES)
    h, f = ops.rglru_scan(*_t(x, a, g, h0))
    assert ops.LAUNCHES == before  # CPU tensors never reach a kernel
    assert h.shape == (B, S, W) and f.shape == (B, W)
    for want_h, want_f in ((p_h, p_f), (o_h, o_f)):
        _close(h, want_h, 1e-5)
        _close(f, want_f, 1e-5)
    _close(f, h[:, -1], 0)


@pytest.mark.parametrize("BH,S,D", RWKV6_CASES)
def test_rwkv6_scan_plain_matches_pallas_apply_and_oracle(BH, S, D):
    r, k, v, w, u, s0 = rwkv6_case(BH, S, D)
    jx = [jnp.asarray(t) for t in (r, k, v, w, u)]
    chunk = min(32, S) if S % min(32, S) == 0 else S
    # the port takes (B, H, S, D): the Pallas layout (BH, S, D) as B = 1
    tr, tk, tv, tw, tu, ts0 = (t[None] for t in _t(r, k, v, w, u, s0))
    # zero state: the Pallas kernel (interpret mode) and the oracle
    o, s = ops.rwkv6_scan(tr, tk, tv, tw, tu)
    o, s = o[0], s[0]
    p_o, p_s = jops.rwkv6_scan(*jx, chunk=chunk)
    _close(o, p_o, 2e-3)
    _close(s, p_s, 2e-3)
    o_o, o_s = jref.rwkv6_scan_ref(*jx)
    _close(o, o_o, 1e-5)
    _close(s, o_s, 1e-5)
    # a nonzero initial state: rwkv6_apply folds it in by linearity
    o, s = ops.rwkv6_scan(tr, tk, tv, tw, tu, ts0)
    o, s = o[0], s[0]
    a_o, a_s = jops.rwkv6_apply(*jx, jnp.asarray(s0), chunk=chunk)
    _close(o, a_o, 2e-3)
    _close(s, a_s, 2e-3)
    o_o, o_s = jref.rwkv6_scan_ref(*jx, state0=jnp.asarray(s0))
    _close(o, o_o, 1e-5)
    _close(s, o_s, 1e-5)


def test_scan_wrappers_raise_off_cpu_without_kernel():
    """Only a CPU tensor reaches a scan's plain version: any other device
    must reach a kernel or raise (here: no kernel for the meta device)."""
    x = torch.empty((1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.rglru_scan(x, x, x, x[:, 0])
    r = torch.empty((1, 2, 4, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.rwkv6_scan(r, r, r, r, r[:, :, :1])
    # the WKV6 wrapper takes only the model's (B, H, S, D), on any device
    r = torch.zeros((2, 4, 32))
    with pytest.raises(ValueError, match=r"\(B, H, S, D\)"):
        ops.rwkv6_scan(r, r, r, r, r[:, :1])



@pytest.mark.parametrize("S,chunks", [(1, 1), (31, 1), (32, 1), (33, 2),
                                      (128, 4), (512, 16), (513, 17)])
def test_rwkv6_scratch_holds_every_chunk_but_the_last(S, chunks):
    """The WKV6 kernel's scratch: per (row, head), a (D x D) state
    contribution and a D decay for every 32-token chunk but the last, none
    when S fits one chunk; its chunk is the Pallas kernel's and the plain
    model path's."""
    import inspect
    from repro_torch.models import ssm
    B, H, D = 2, 3, 64
    assert ops.rwkv6_scratch_floats(B, H, S, D) == \
        B * H * (chunks - 1) * (D * D + D)
    for fn in (jops.rwkv6_scan, ssm.rwkv6_scan_chunked):
        assert inspect.signature(fn).parameters["chunk"].default == \
            ops.RWKV6_CHUNK


def _check_chunk_sync(name):
    """A chunked scan's chunk-order bookkeeping (ops._chunk_sync): each
    launch a new epoch on the same buffers while they hold enough flags;
    more flags than they hold (or an epoch at the int32 limit) start fresh
    zeroed buffers."""
    dev = torch.device("cpu")
    key = ops._chunk_sync_key(name, dev)
    ops._CHUNK_SYNC.pop(key, None)
    a = ops._chunk_sync(name, dev, 64)
    assert (a.epoch, a.taken, a.flags.numel()) == (1, 0, 64)
    assert a.args()[1::2] == (0, 1)  # (tiles, taken, flags, epoch)
    a.taken = 64
    b = ops._chunk_sync(name, dev, 32)
    assert b is a and (b.epoch, b.taken) == (2, 64)
    assert b.args()[1::2] == (64, 2)
    c = ops._chunk_sync(name, dev, 65)
    assert c is not a and (c.epoch, c.taken, c.flags.numel()) == (1, 0, 65)
    assert not c.flags.any() and not c.tiles.any()
    c.epoch = 2 ** 31 - 1
    assert ops._chunk_sync(name, dev, 8).epoch == 1
    ops._CHUNK_SYNC.pop(key)


def test_rwkv6_sync_epochs_and_buffers():
    """The WKV6 kernel's chunk-order bookkeeping (the helper both scans
    share)."""
    _check_chunk_sync("rwkv6_scan")


def test_rglru_sync_epochs_and_buffers():
    """The RG-LRU kernel's chunk-order bookkeeping (the helper both scans
    share)."""
    _check_chunk_sync("rglru_scan")


def test_scans_keep_their_own_chunk_sync():
    """Each kernel keeps its own counter and flags on a device: a launch of
    one scan never advances the other's epoch or tiles taken."""
    dev = torch.device("cpu")
    for name in ("rwkv6_scan", "rglru_scan"):
        ops._CHUNK_SYNC.pop(ops._chunk_sync_key(name, dev), None)
    w = ops._chunk_sync("rwkv6_scan", dev, 16)
    w.taken = 16
    r = ops._chunk_sync("rglru_scan", dev, 16)
    assert r is not w and (r.epoch, r.taken) == (1, 0)
    assert ops._chunk_sync("rwkv6_scan", dev, 16).epoch == 2
    assert (r.epoch, r.taken, w.taken) == (1, 0, 16)
    for name in ("rwkv6_scan", "rglru_scan"):
        ops._CHUNK_SYNC.pop(ops._chunk_sync_key(name, dev))


@pytest.mark.parametrize("S", [1, 15, 16, 17, 32, 33, 300, 512])
def test_rglru_scratch_holds_every_chunk_but_the_last(S):
    """The RG-LRU kernel's scratch: per (row, channel), a pair (prod a_t,
    the chunk's h from 0) for every chunk of RGLRU_CHUNK tokens but the
    last, none when S fits one chunk."""
    B, W = 3, 520
    chunks = -(-S // ops.RGLRU_CHUNK)
    assert ops.rglru_scratch_floats(B, S, W) == B * W * (chunks - 1) * 2
    assert (ops.rglru_scratch_floats(B, S, W) == 0) == \
        (S <= ops.RGLRU_CHUNK)


@pytest.mark.parametrize("const,kernel,name", [
    ("RGLRU_CHUNK", "rglru_scan", "kL"),
    ("RGLRU_TILE_W", "rglru_scan", "kTW"),
    ("RWKV6_CHUNK", "rwkv6_scan", "kT")])
def test_scan_wrappers_size_scratch_by_the_kernels_constants(const, kernel,
                                                            name):
    """The wrappers size each chunked scan's scratch and flags by a copy of
    its kernel's chunk and tile constants: the copy equals the constant in
    the kernel's source."""
    import re
    from repro_torch.kernels import build
    src = (build.CSRC / f"{kernel}.cu").read_text()
    found = re.findall(rf"constexpr int {name} = (\d+);", src)
    assert found == [str(getattr(ops, const))]


@pytest.mark.parametrize("name", ["rwkv6_scan", "rglru_scan"])
def test_chunked_scans_refuse_graph_capture(name, monkeypatch):
    """The chunk-order epoch and tiles taken are launch arguments from the
    host, which a replayed CUDA graph would reuse stale: a chunked scan
    launched while its stream captures raises, and keeps no bookkeeping."""
    dev = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="CUDA graph"):
        ops._chunk_sync(name, dev, 8)
    assert not any(k[:2] == (name, dev) for k in ops._CHUNK_SYNC)


# the RG-LRU kernel's chunk boundaries (a chunk is 16 tokens) and the
# serve's largest prefill bucket, at ragged W
RGLRU_BOUNDARIES = [(1, 15, 40), (2, 16, 40), (1, 17, 40), (2, 33, 24),
                    (1, 128, 24), (2, 384, 24), (1, 256, 40)]


@pytest.mark.parametrize("B,S,W", RGLRU_BOUNDARIES)
def test_rglru_plain_matches_pallas_at_chunk_boundaries(B, S, W):
    """The plain version the RG-LRU kernel is held to on the card, at the
    kernel's chunk boundaries and long prompts, against the Pallas kernel
    in interpret mode (its own 128-step chunks) and the oracle: 1e-5."""
    x, a, g, h0 = rglru_case(B, S, W, seed=S)
    jx = [jnp.asarray(t) for t in (x, a, g, h0)]
    h, f = ops.rglru_scan(*_t(x, a, g, h0))
    for want_h, want_f in (jops.rglru_scan(*jx), jref.rglru_scan_ref(*jx)):
        _close(h, want_h, 1e-5)
        _close(f, want_f, 1e-5)


@pytest.mark.parametrize("decay,tol", [("strong", 1e-5), ("weak", 1e-3)])
def test_rglru_plain_at_extreme_decays(decay, tol):
    """Log decays near -8 (the kernel's chunk products underflow to 0) and
    near 0 (h carried across all of S 300): the plain version the kernel
    is held to stays finite and within ``tol`` (of the largest |value|) of
    the same recurrence in float64.  Near 0, sqrt(1 - a^2) turns one f32
    rounding of a a (1e-7) into ~1e-4 of beta, hence the wider limit."""
    x, a, g, h0 = rglru_case(2, 300, 24, seed=3)
    a = (a * 1e-3 - 8.0) if decay == "strong" else a * 1e-4
    h, f = ops.rglru_scan(*_t(x, a, g, h0))
    a64 = np.exp(a.astype(np.float64))
    u = np.sqrt(np.maximum(1 - a64 * a64, 0)) * (g.astype(np.float64) * x)
    want, hs = h0.astype(np.float64), []
    for t in range(x.shape[1]):
        want = a64[:, t] * want + u[:, t]
        hs.append(want)
    want_h = np.stack(hs, 1)
    assert torch.isfinite(h).all() and torch.isfinite(f).all()
    scale = np.abs(want_h).max()
    assert np.abs(h.double().numpy() - want_h).max() <= tol * scale
    assert np.abs(f.double().numpy() - want).max() <= tol * scale


# -- contiguous flash attention and its gradient ------------------------------
# The plain versions (what ops.flash_attention / ops.flash_attention_bwd run
# for CPU tensors, and what the CUDA kernels are held to on the card) against
# the Pallas flash_attention in interpret mode and repro.kernels.ref's
# oracle, on the reference's own cases (tests/test_kernels.py): 2e-5 in f32
# (summation order only), 2e-2 in bf16 (the reference's bf16 tolerance:
# each side rounds its f32 result to bf16 once).  The gradient is held to
# jax.vjp of the oracle, the autograd Function to torch autograd through
# models.attention.chunked_attention.
#   name: (B, Hq, Hkv, S, hd, dtype, window, Pallas blocks)
FLASH_CASES = {
    "mha": (1, 4, 4, 128, 64, "f32", None, 64),
    "gqa2": (2, 4, 2, 256, 64, "f32", None, 64),
    "mqa": (1, 8, 1, 128, 128, "f32", None, 64),
    "bf16": (1, 4, 2, 128, 64, "bf16", None, 64),
    "window32": (1, 2, 2, 128, 64, "f32", 32, 64),
    "window64": (1, 2, 2, 128, 64, "f32", 64, 64),
    "s40_hd32": (1, 4, 2, 40, 32, "f32", None, 128),
}


def _flash_inputs(case, seed=0):
    B, Hq, Hkv, S, hd, dt, window, blk = FLASH_CASES[case]
    rng = np.random.default_rng(seed)
    q, k, v, d_out = (rng.standard_normal(sh, dtype=np.float32) for sh in
                      [(B, Hq, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hd),
                       (B, Hq, S, hd)])
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dt == "bf16" else \
        (jnp.float32, torch.float32)
    jx = [jnp.asarray(x, jdt) for x in (q, k, v, d_out)]
    tx = [t.to(tdt) for t in _t(q, k, v, d_out)]
    tol = 2e-2 if dt == "bf16" else TOL
    return jx, tx, window, blk, tol


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_matches_pallas_and_oracle(case):
    (jq, jk, jv, _), (tq, tk, tv, _), window, blk, tol = _flash_inputs(case)
    pallas = jops.flash_attention(jq, jk, jv, causal=True, window=window,
                                  block_q=blk, block_k=blk)
    oracle = jref.flash_attention_ref(jq, jk, jv, causal=True, window=window)
    before = dict(ops.LAUNCHES)
    out, lse = ops.flash_attention(tq, tk, tv, window=window,
                                   return_lse=True)
    assert ops.LAUNCHES == before  # CPU tensors never reach a kernel
    assert out.dtype == tq.dtype and lse.dtype == torch.float32
    _close(out.float(), pallas, tol)
    _close(out.float(), oracle, tol)
    # the lse is the log-normaliser of the scaled, masked scores
    hd = tq.shape[-1]
    G = tq.shape[1] // tk.shape[1]
    sc = torch.einsum("bhqd,bhkd->bhqk", tq.float(),
                      tk.float().repeat_interleave(G, 1)) / hd ** 0.5
    S = tq.shape[2]
    i, j = torch.arange(S)[:, None], torch.arange(S)[None, :]
    ok = (j <= i) & ((j > i - window) if window else True)
    want = torch.logsumexp(sc.masked_fill(~ok, float("-inf")), -1)
    _close(lse, want, 1e-5)


def test_flash_plain_takes_unequal_lengths_and_pos_base():
    """Sq != Skv, as the oracle takes them: query i and key j at pos_base + i
    and pos_base + j, so pos_base cancels."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 6, 24, 32), dtype=np.float32)
    k, v = (rng.standard_normal((2, 2, 40, 32), dtype=np.float32)
            for _ in range(2))
    for window in (None, 8):
        want = jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                        causal=True, window=window,
                                        pos_base=5)
        got = ops.flash_attention(*_t(q, k, v), window=window, pos_base=5)
        _close(got, want, TOL)


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_bwd_plain_matches_jax_vjp(case):
    (jq, jk, jv, jdo), (tq, tk, tv, tdo), window, _, tol = \
        _flash_inputs(case, seed=1)
    _, vjp = jax.vjp(lambda q, k, v: jref.flash_attention_ref(
        q, k, v, causal=True, window=window), jq, jk, jv)
    want = vjp(jdo)
    out, lse = ops.flash_attention(tq, tk, tv, window=window,
                                   return_lse=True)
    got = ops.flash_attention_bwd(tq, tk, tv, out, lse, tdo, window=window)
    for g, w, t in zip(got, want, (tq, tk, tv)):
        assert g.shape == t.shape and g.dtype == t.dtype
        # relative to the gradient's own scale: dq, dk and dv differ in size
        scale = float(np.abs(np.asarray(w, np.float32)).max())
        np.testing.assert_allclose(np.asarray(g.float()),
                                   np.asarray(w, np.float32), rtol=tol,
                                   atol=tol * scale)


@pytest.mark.parametrize("case", ["gqa2", "window32", "s40_hd32"])
def test_flash_train_autograd_matches_chunked_attention(case):
    """ops.flash_attention_train on CPU tensors in the model's (B, S, H,
    hd) layout (transposed views) against torch autograd through the
    plain model attention: outputs and the three input gradients."""
    _, (tq, tk, tv, tdo), window, _, _ = _flash_inputs(case, seed=2)
    q, k, v = (t.transpose(1, 2).contiguous().requires_grad_(True)
               for t in (tq, tk, tv))
    out = ops.flash_attention_train(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), window=window)
    out = out.transpose(1, 2)
    (out * tdo.transpose(1, 2)).sum().backward()
    got = [out.detach()] + [t.grad for t in (q, k, v)]
    q2, k2, v2 = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    ref_out = TA.chunked_attention(q2, k2, v2, causal=True, window=window,
                                   q_chunk=32, kv_chunk=32)
    (ref_out * tdo.transpose(1, 2)).sum().backward()
    want = [ref_out.detach()] + [t.grad for t in (q2, k2, v2)]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)


def test_flash_wrappers_raise_off_cpu_without_kernel():
    """Only a CPU tensor reaches the plain versions: any other device must
    reach a kernel or raise (here: no kernel for the meta device)."""
    q = torch.empty((1, 4, 8, 32), device="meta")
    k = torch.empty((1, 2, 8, 32), device="meta")
    lse = torch.empty((1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention_bwd(q, k, k, q, lse, q)


# -- sharding and cost tooling: the reference's production meshes, sharding
# rules, sharded entry points, op costs and dry run (torch_shard_cases.py)
class _StandInMesh:
    """What the reference's rules read of a ``Mesh``: ``axis_names`` and
    the ``shape`` mapping."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.shape = dict(zip(names, shape))


SHARD_MESHES = {"16x16": ((16, 16), ("data", "model")),
                "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SHARD_ARCHS = sorted(J_ARCHS)


def _jax_spec_tree(tree):
    """{path tuple: tuple(spec)} of a tree of ``PartitionSpec``s."""
    from jax.sharding import PartitionSpec
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                  for k in path): tuple(s)
            for path, s in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, PartitionSpec))}


@functools.lru_cache(maxsize=None)
def _full_width(arch):
    """The reference's parameter shapes (``jax.eval_shape``) and the port's
    (``init_params`` on the meta device) of ``arch`` at full width."""
    from repro import models as J
    from repro.configs import get_config
    from repro_torch.configs import get_config as t_config
    from repro_torch.models import init_params
    cfg = get_config(arch)
    jp = jax.eval_shape(lambda k: J.init_params(cfg, k, dtype=jnp.bfloat16),
                        jax.random.PRNGKey(0))
    return cfg, jp, t_config(arch), init_params(
        t_config(arch), dtype=torch.bfloat16, device="meta")


@pytest.mark.parametrize("fsdp", ["auto", "off"])
@pytest.mark.parametrize("mesh", SHARD_MESHES)
@pytest.mark.parametrize("arch", SHARD_ARCHS)
def test_param_pspecs_match_reference(arch, mesh, fsdp):
    """Every parameter leaf of every config at full width gets the
    reference's spec, on both production meshes, FSDP on and off."""
    from repro.models.params import param_pspecs as j_pspecs
    from repro_torch.models.params import param_pspecs
    _, jp, _, tp = _full_width(arch)
    m = _StandInMesh(*SHARD_MESHES[mesh])
    want = {".".join(k): v for k, v in
            _jax_spec_tree(j_pspecs(jp, m, fsdp=fsdp)).items()}
    got = param_pspecs(tp, m, fsdp=fsdp)
    assert set(got) == set(want)
    for name, spec in want.items():
        assert got[name] == spec, (name, got[name], spec)
        assert repr(got[name]).startswith("PartitionSpec(")


@pytest.mark.parametrize("mesh", SHARD_MESHES)
@pytest.mark.parametrize("arch", SHARD_ARCHS)
def test_batch_and_cache_pspecs_match_reference(arch, mesh):
    """``batch_pspec`` for the four shapes' batches and a batch of 2 (the
    pod axis alone), and ``cache_pspecs`` on every cache leaf of a batch
    of 128 and of 2, equal the reference's."""
    from repro import models as J
    from repro.models.params import batch_pspec as j_batch
    from repro.models.params import cache_pspecs as j_cache
    from repro_torch.models import init_cache
    from repro_torch.models.params import batch_pspec, cache_pspecs
    cfg, jp, tcfg, tp = _full_width(arch)
    m = _StandInMesh(*SHARD_MESHES[mesh])
    for b in (1, 2, 32, 128, 256):
        for nd in (1, 2, 3):
            assert batch_pspec(m, b, nd) == tuple(j_batch(m, b, nd))
    for b in (128, 2):
        fe = None if cfg.frontend == "none" else jax.ShapeDtypeStruct(
            (b, cfg.frontend_tokens, cfg.frontend_dim), jnp.bfloat16)
        jc = jax.eval_shape(lambda p, f: J.init_cache(
            cfg, p, b, 4096, jnp.bfloat16, frontend_emb=f), jp, fe)
        tfe = None if fe is None else torch.empty(
            fe.shape, dtype=torch.bfloat16, device="meta")
        tc = init_cache(tcfg, tp, b, 4096, torch.bfloat16, frontend_emb=tfe)
        want = _jax_spec_tree(j_cache(jc, m, b))
        got = cache_pspecs(tc, m, b)
        assert set(got) == set(want)
        for path, spec in want.items():
            assert got[path] == spec, (path, got[path], spec)


def test_param_placements_follow_mesh_order():
    """A dim sharded over ("pod", "data") is ``Shard`` on both mesh dims,
    in mesh (major-to-minor) order; unnamed mesh dims replicate."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.models.params import P, param_placements
    m = _StandInMesh(*SHARD_MESHES["2x16x16"])
    assert param_placements(P(("pod", "data"), "model"), m) == [
        Shard(0), Shard(0), Shard(1)]
    assert param_placements(P(None, "data"), m) == [
        Replicate(), Shard(1), Replicate()]


def test_production_mesh_raises_typed_on_world_of_one():
    """As the reference on a short device list: a typed error carrying the
    requested and available counts, never a silent reshape."""
    from repro_torch.launch.mesh import MeshDeviceError, make_production_mesh
    for mp, n in ((False, 256), (True, 512)):
        with pytest.raises(MeshDeviceError) as ei:
            make_production_mesh(multi_pod=mp, device="cpu")
        assert (ei.value.requested, ei.value.available) == (n, 1)
        assert isinstance(ei.value, RuntimeError)


def test_sharded_call_without_a_mesh_raises():
    """``batch_axes`` / ``tp_axis`` on plain parameters: no unsharded
    fallback."""
    from repro_torch.configs import get_tiny_config
    from repro_torch.models import forward, init_params, prefill
    cfg = get_tiny_config("llama3-405b")
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    toks = torch.zeros((2, 8), dtype=torch.int64)
    for kw in (dict(batch_axes="data"), dict(tp_axis="model")):
        with pytest.raises(ValueError, match="DeviceMesh"):
            forward(cfg, params, toks, kernel_backend="plain", **kw)
        with pytest.raises(ValueError, match="DeviceMesh"):
            prefill(cfg, params, toks, kernel_backend="plain", **kw)


def test_op_cost_matmul_flops_exact():
    from repro_torch.launch.opcost import op_cost
    c = op_cost(lambda a, b: a @ b, torch.zeros(128, 256),
                torch.zeros(256, 512))
    assert c["flops"] == 2 * 128 * 256 * 512
    assert c["collective_total"] == 0 and c["collective_count"] == 0


def test_op_cost_counts_every_iteration():
    """A Python loop of N products counts N times (the reference multiplies
    a scan body by its trip count)."""
    from repro_torch.launch.opcost import op_cost
    N = 17

    def f(w, x):
        for _ in range(N):
            x = x @ w
        return x
    c = op_cost(f, torch.zeros(64, 64), torch.zeros(8, 64))
    assert c["flops"] == 2 * 8 * 64 * 64 * N


@pytest.mark.parametrize("how", ["slice", "index"])
def test_op_cost_inplace_row_write_not_whole_buffer(how):
    """A 1-row write into a big buffer counts the row, not the buffer."""
    from repro_torch.launch.opcost import op_cost
    buf, row = torch.zeros(4096, 1024), torch.ones(1, 1024)

    def f(buf, row):
        if how == "slice":
            buf[17:18] = row
        else:
            buf[torch.tensor([17])] = row
    c = op_cost(f, buf, row)
    assert 0 < c["bytes"] < 4 * 1024 * 4, c["bytes"]


def test_remat_dots_keeps_matmuls_and_gradients():
    """``remat="dots"``: the gradients of ``remat=True`` bit for bit, and a
    backward that recomputes fewer matmul flops (their outputs are
    kept)."""
    from repro_torch.configs import get_tiny_config
    from repro_torch.launch.opcost import op_cost
    from repro_torch.models import forward, init_params
    cfg = get_tiny_config("llama3-405b")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 16)))
    grads, flops = {}, {}
    for remat in (True, "dots"):
        params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
        for p in params.parameters():
            p.requires_grad_(True)
        logits, _ = forward(cfg, params, toks, remat=remat,
                            kernel_backend="plain")
        flops[remat] = op_cost(lambda: logits.float().square().mean()
                               .backward())["flops"]
        grads[remat] = {n: p.grad for n, p in params.named_parameters()}
    for n, g in grads[True].items():
        assert torch.equal(g, grads["dots"][n]), n
    assert flops["dots"] < flops[True]


@pytest.fixture(scope="module")
def shard_probe():
    import torch_shard_cases as SC
    return SC.run_probe()


def test_production_meshes_on_fake_group(shard_probe):
    """On a fake 512-rank group: the reference's shapes and axis names,
    over the group's first ranks in order, on the CPU when asked."""
    m = shard_probe["meshes"]
    assert m["False"] == [[16, 16], ["data", "model"], "cpu", [0, 1, 2]]
    assert m["True"] == [[2, 16, 16], ["pod", "data", "model"], "cpu",
                         [0, 1, 2]]


def test_op_cost_sharded_product_is_per_chip(shard_probe):
    """A (512, 256) @ (256, 128) product with its rows over 4 ranks: each
    chip counts a quarter of the global flops."""
    assert shard_probe["sharded_flops"] == 2 * 512 * 256 * 128 / 4


def test_op_cost_collective_bytes(shard_probe):
    """An all-gather of a (64, 32) f32 tensor and the all-reduce of a
    (64, 16) f32 partial sum, by kind, at their result's local bytes."""
    ag, ar = shard_probe["all_gather"], shard_probe["all_reduce"]
    assert ag["collectives"]["all-gather"] == 64 * 32 * 4
    assert ag["collective_count"] == 1
    assert ar["collectives"]["all-reduce"] == 64 * 16 * 4
    assert ar["collective_count"] == 1
    assert ar["flops"] == 2 * 64 * 8 * 16  # the local (64, 8) @ (8, 16)


@pytest.mark.parametrize("name", [
    "decode_attention", "decode_attention_partials", "flash_attention_pool",
    "moe_gemm", "moe_gemm_with", "rglru_scan", "rwkv6_scan",
    "flash_attention", "flash_attention_bwd", "flash_attention_train"])
def test_kernel_wrappers_refuse_dtensor(shard_probe, name):
    assert shard_probe["refused"][name] == "TypeError"


_REFERENCE_RECORD_KEYS = {
    "arch", "shape", "mesh", "chips", "status", "serve_sharding", "q_chunk",
    "kv_chunk", "lower_s", "compile_s", "memory", "cost_analysis_raw",
    "hlo_flops_per_chip", "hlo_bytes_per_chip", "collectives",
    "collective_bytes_per_chip", "collective_count", "model_flops_global",
    "hlo_lines", "roofline"}


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k",
                                   "long_500k"])
@pytest.mark.parametrize("arch", ["llama3-405b", "qwen2-moe-a2.7b"])
def test_dryrun_tiny_records(shard_probe, arch, shape):
    """The dry run of a dense and an MoE arch (tiny) on both production
    meshes: ``ok`` with the reference's keys and an H100 roofline, or
    ``skipped`` exactly where ``shape_supported`` says."""
    from repro.configs import get_tiny_config
    from repro.launch.shapes import shape_supported
    from repro_torch.launch import dryrun
    recs = [r for r in shard_probe["dryrun"]
            if r["arch"] == arch and r["shape"] == shape]
    assert sorted(r["mesh"] for r in recs) == ["16x16", "2x16x16"]
    supported, _ = shape_supported(get_tiny_config(arch), shape)
    for r in recs:
        if not supported:
            assert r["status"] == "skipped"
            continue
        assert r["status"] == "ok"
        assert set(r) == _REFERENCE_RECORD_KEYS
        assert r["hlo_flops_per_chip"] > 0 and r["hlo_bytes_per_chip"] > 0
        rf = r["roofline"]
        assert rf["t_compute"] == r["hlo_flops_per_chip"] / dryrun.PEAK_FLOPS
        assert rf["t_memory"] == r["hlo_bytes_per_chip"] / dryrun.HBM_BW
        assert rf["t_collective"] == \
            r["collective_bytes_per_chip"] / dryrun.NVLINK_BW
        assert (dryrun.PEAK_FLOPS, dryrun.HBM_BW, dryrun.NVLINK_BW) == \
            (989e12, 3.35e12, 450e9)
        assert r["memory"]["argument_bytes"] > 0


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    """The reference's unsharded runs and the port's sharded ones on four
    gloo ranks (``torch_shard_cases``)."""
    import torch_shard_cases as SC
    tmp = str(tmp_path_factory.mktemp("shard"))
    refs = {a: SC.reference(a, tmp) for a in {a for a, _ in SC.CASES}}
    out = os.path.join(tmp, "sharded.npz")
    rcs, logs = SC.run_workers({a: r["weights"] for a, r in refs.items()},
                               out)
    assert rcs == [0] * SC.WORLD, logs[0][-4000:]
    return refs, dict(np.load(out))


@pytest.mark.parametrize("check", ["forward", "prefill_decode",
                                   "rows_kernels", "loss_grads",
                                   "remat_dots", "train_step"])
@pytest.mark.parametrize("case", ["llama3-405b-2x2", "llama3-405b-1x4",
                                  "qwen2-moe-a2.7b-2x2"])
def test_sharded_entry_points_match_reference(sharded_runs, case, check):
    """``forward``, ``prefill`` + 4 decode ``extend`` calls (also
    batch-sharded through the attention kernels' wrappers), the loss and
    every gradient, ``remat="dots"`` and one train step, all sharded
    (``batch_axes="data"``, ``tp_axis="model"``) on four gloo ranks, held
    to the reference's unsharded runs at the parity standard."""
    import torch_shard_cases as SC
    refs, res = sharded_runs
    arch = case.rsplit("-", 1)[0]
    ref = refs[arch]
    if check == "forward":
        np.testing.assert_allclose(res[f"{case}/forward"], ref["forward"],
                                   rtol=SC.PREFILL_TOL, atol=SC.PREFILL_TOL)
    elif check in ("prefill_decode", "rows_kernels"):
        key = "steps" if check == "prefill_decode" else "rows_steps"
        got = res[f"{case}/{key}"]
        assert len(got) == SC.DECODE_STEPS + 1
        for i, (g, w) in enumerate(zip(got, ref["steps"])):
            tol = SC.PREFILL_TOL if i == 0 else SC.DECODE_TOL
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol)
    elif check in ("loss_grads", "remat_dots"):
        remat = "True" if check == "loss_grads" else "dots"
        loss = float(res[f"{case}/loss/{remat}"])
        assert abs(loss - ref["loss"]) <= SC.LOSS_REL * abs(ref["loss"])
        for name, w in ref["grads"].items():
            g = res[f"{case}/grad/{remat}/{name}"]
            assert g.shape == w.shape, name
            rel = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert rel <= SC.GRAD_REL, (name, rel)
            if remat == "dots":
                assert np.array_equal(g, res[f"{case}/grad/True/{name}"]), \
                    name
    else:
        loss = float(res[f"{case}/step_loss"])
        assert abs(loss - ref["loss"]) <= SC.LOSS_REL * abs(ref["loss"])
        assert bool(res[f"{case}/moments_laid_out"])
