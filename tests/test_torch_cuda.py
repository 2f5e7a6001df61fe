"""PyTorch port on the card: the CUDA kernels (attention up to head_dim
256, the training flash attention and its backward, the MoE grouped expert
GEMM, the RG-LRU and WKV6 scans) against their plain versions, the tiny
serving paths (dense, MoE, RG-LRU hybrid, RWKV6) through the kernels
against the plain path, the attention kernels at the encoder-decoder and
vision forms' heads and those forms' tiny prefill and decode through the
kernels against the plain path, and a tiny training step's loss and
gradients through the kernels against the plain path.  Every test here is
marked ``cuda`` and skips without an NVIDIA GPU;
on the card run them with ``python -m pytest -q -m cuda
tests/test_torch_cuda.py`` (the file imports no JAX).

Tolerances: f32 outputs agree to 1e-4 (summation order only); bf16 outputs
to 2e-2, a few units of bf16's 2^-8 relative rounding of the output."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.models import quantize_kv
from torch_attention_cases import (DECODE_CASES, POOL_CASES, decode_case,
                                   pool_call, pool_case, to_torch)
from torch_frontend_cases import (LLAVA, WHISPER, frames, frontend_tiny,
                                  tokens)
from torch_recurrent_cases import (RGLRU_CASES, RWKV6_CASES, TAIL,
                                   rglru_case, rwkv6_case, tiny)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def _assert_close(got, want, dtype):
    """f32: 1e-4.  bf16: both sides accumulate in f32 and round once to
    bf16, so they differ by at most one ulp of an element; allow two ulps
    (2^-6 relative) of the largest plain output."""
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        return
    err = (got.float() - want.float()).abs().max().item()
    tol = 4 * 2.0 ** -8 * want.float().abs().max().item()
    assert err <= tol, f"max abs err {err} > {tol}"


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain(cuda, case, dtype):
    q, kc, vc, sp, cur, kw = decode_case(case)
    tq, tk, tv, tsp, tcur = [x.to(cuda) for x in to_torch(q, kc, vc, sp,
                                                          cur)]
    tq, tk, tv = tq.to(dtype), tk.to(dtype), tv.to(dtype)
    before = ops.LAUNCHES["decode_attention"]
    got = ops.decode_attention(tq, tk, tv, tsp, tcur, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == before + 1
    want = ref.decode_attention(tq, tk, tv, tsp, tcur, **kw)
    _assert_close(got, want, dtype)


def test_decode_kernel_int8_and_strided_rows(cuda):
    q, kc, vc, sp, cur, _ = decode_case("per_batch_positions")
    tq, tk, tv, tsp, tcur = [x.to(cuda) for x in to_torch(q, kc, vc, sp,
                                                          cur)]
    (qk, ks), (qv, vs) = quantize_kv(tk), quantize_kv(tv)
    # rows 1..3 of a 5-row pool, ring prefix of 48 slots: strided views
    pool = {n: torch.zeros((5,) + x.shape[1:], dtype=x.dtype, device=cuda)
            for n, x in (("k", qk), ("v", qv), ("ks", ks), ("vs", vs))}
    pool_sp = torch.full((5, sp.shape[1]), -1, dtype=torch.int32,
                         device=cuda)
    for n, x in (("k", qk), ("v", qv), ("ks", ks), ("vs", vs)):
        pool[n][1:4] = x
    pool_sp[1:4] = tsp
    v = {n: x[1:4, :48] for n, x in pool.items()}
    got = ops.decode_attention(tq, v["k"], v["v"], pool_sp[1:4, :48], tcur,
                               k_scale=v["ks"], v_scale=v["vs"])
    want = ref.decode_attention(tq, qk[:, :48], qv[:, :48], tsp[:, :48],
                                tcur, k_scale=ks[:, :48], v_scale=vs[:, :48])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", POOL_CASES)
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_pool_kernel_matches_plain(cuda, case, mode):
    q, kc, vc, sp, pos_q, kw = pool_case(case)
    tq, tk, tv, tsp, tpq = [x.to(cuda) for x in to_torch(q, kc, vc, sp,
                                                         pos_q)]
    if mode == "bf16":
        tq, tk, tv = tq.bfloat16(), tk.bfloat16(), tv.bfloat16()
    if mode == "int8":
        (tk, ks), (tv, vs) = quantize_kv(tk), quantize_kv(tv)
        kw = dict(kw, k_scale=ks.transpose(1, 2), v_scale=vs.transpose(1, 2))
    before = ops.LAUNCHES["flash_attention_pool"]
    got = pool_call(tq, tk, tv, tpq, tsp, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention_pool"] == before + 1
    want = ref.flash_attention_pool(tq.transpose(1, 2), tk.transpose(1, 2),
                                    tv.transpose(1, 2), tpq, tsp,
                                    **kw).transpose(1, 2)
    _assert_close(got, want, tq.dtype)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 4, 48), device=cuda)  # head_dim 48
    k = torch.zeros((1, 8, 2, 48), device=cuda)
    sp = torch.zeros((1, 8), dtype=torch.int32, device=cuda)
    cur = torch.zeros((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        ops.decode_attention(q, k, k, sp, cur)
    q = torch.zeros((1, 4, 32), device=cuda)
    k = torch.zeros((1, 8, 2, 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="K/V must be"):
        ops.decode_attention(q, k, k, sp, cur)
    with pytest.raises(ValueError, match="stride 1"):
        ops.decode_attention(q, k.float().transpose(2, 3).contiguous()
                             .transpose(2, 3), k.float(), sp, cur)
    # the pool kernel copies rows of q, K and V in 16-byte vectors: a row
    # that starts off a 16-byte boundary (an odd offset, or a row stride of
    # 33 bf16) is refused
    kb = torch.zeros((1, 2, 8, 32), device=cuda, dtype=torch.bfloat16)
    pq = torch.zeros((1, 4), dtype=torch.int32, device=cuda)
    pk = torch.zeros((1, 8), dtype=torch.int32, device=cuda)
    shifted = torch.zeros(1 * 4 * 4 * 32 + 1, device=cuda,
                          dtype=torch.bfloat16)[1:].view(1, 4, 4, 32)
    wide = torch.zeros((1, 4, 4, 33), device=cuda,
                       dtype=torch.bfloat16)[..., :32]
    for bad in (shifted, wide):
        with pytest.raises(ValueError, match="16-byte"):
            ops.flash_attention_pool(bad, kb, kb, pq, pk)
    q4 = torch.zeros((1, 4, 4, 32), device=cuda, dtype=torch.bfloat16)
    k4 = torch.zeros((1, 2, 4, 32), device=cuda, dtype=torch.bfloat16)
    kv_wide = torch.zeros((1, 2, 4, 33), device=cuda,
                          dtype=torch.bfloat16)[..., :32]
    for bad_k, bad_v in ((kv_wide, k4), (k4, kv_wide)):
        with pytest.raises(ValueError, match="16-byte"):
            ops.flash_attention_pool(q4, bad_k, bad_v, pq, pk[:, :4])
    # the split decode kernel takes n_split in [1, tiles]
    kd = torch.zeros((1, 64, 2, 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="splits"):
        ops.decode_attention_partials(
            q4[:, :, 0], kd, kd, torch.zeros((1, 64), dtype=torch.int32,
                                             device=cuda),
            cur, n_split=2)


# -- the split decode kernel ---------------------------------------------------
def _decode_inputs(cuda, B, Hq, Hkv, hd, S, *, live=None, wrap=None,
                   window=None, kv_limit=None, dtype=torch.bfloat16,
                   int8=False, seed=0):
    """Ring rows holding positions [0, live) in slots [0, live), or (wrap)
    the last S positions up to ``wrap`` at slot pos % S; q, K and V from a
    seed, K/V in ``dtype`` or int8 with scales."""
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            cuda)
    k, v, q = randn(B, S, Hkv, hd), randn(B, S, Hkv, hd), randn(B, Hq, hd)
    sp = torch.full((B, S), -1, dtype=torch.int32)
    if wrap is None:
        sp[:, :live] = torch.arange(live, dtype=torch.int32)
        cur = torch.full((B,), live - 1, dtype=torch.int32)
    else:
        pos = torch.arange(wrap - S + 1, wrap + 1, dtype=torch.int32)
        sp[:, pos.long() % S] = pos
        cur = torch.full((B,), wrap, dtype=torch.int32)
    kw = dict(window=window, kv_limit=kv_limit)
    q = q.to(dtype)
    if int8:
        (k, kw["k_scale"]), (v, kw["v_scale"]) = quantize_kv(k), quantize_kv(v)
    else:
        k, v = k.to(dtype), v.to(dtype)
    return (q, k, v, sp.to(cuda), cur.to(cuda)), kw


# (label, B, Hq, Hkv, hd, S, extra): llama3.2-3b at B 1 (32 splits, the
# most) and an int8 kv_limit, a ring below one 64-slot tile, a ragged ring
# whose splits are uneven, recurrentgemma-9b's MQA at head_dim 256 with its
# window, and a wrapped ring with a window at head_dim 64
DECODE_SPLIT_CASES = [
    ("B1 most splits", 1, 24, 8, 128, 2048, dict(live=2041)),
    ("S below one tile", 3, 24, 8, 128, 40, dict(live=33)),
    ("S not a multiple of the split", 2, 16, 1, 256, 1000, dict(live=990)),
    ("int8 kv_limit", 4, 24, 8, 128, 2048,
     dict(live=900, kv_limit=1024, int8=True)),
    ("G16 hd256 window", 16, 16, 1, 256, 2048, dict(live=2041, window=700)),
    ("wrapped ring window", 2, 8, 2, 64, 512, dict(wrap=3000, window=300))]


@pytest.mark.parametrize("case", DECODE_SPLIT_CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_split_kernel_matches_plain(cuda, case, dtype):
    _, B, Hq, Hkv, hd, S, extra = case
    args, kw = _decode_inputs(cuda, B, Hq, Hkv, hd, S, dtype=dtype, **extra)
    n = ops.decode_splits(B, Hkv, kw["kv_limit"] or S, hd, Hq // Hkv,
                          args[1].element_size())
    before = ops.LAUNCHES["decode_attention"]
    got = ops.decode_attention(*args, **kw)
    again = ops.decode_attention(*args, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == before + 2
    assert torch.equal(got, again)  # a fixed merge order: the same bits
    _assert_close(got, ref.decode_attention(*args, **kw), dtype)
    if case[0] == "B1 most splits":
        assert n == 32
    if case[0] == "G16 hd256 window":
        assert n > 1


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_decode_kernel_partials_match_plain(cuda, mode):
    """The split kernel's (m, l, acc) against ref.decode_attention_partials
    at 1, 2 and the most splits (some of them fully masked: the window
    leaves only the last 300 positions).  m and l are f32 sums of f32
    exponentials on both sides (1e-4); acc is held like an output of q's
    dtype."""
    dtype = torch.float32 if mode == "f32" else torch.bfloat16
    args, kw = _decode_inputs(cuda, 2, 24, 8, 128, 1024, live=1000,
                              window=300, dtype=dtype, int8=mode == "int8")
    for n in (1, 2, 16):
        got = ops.decode_attention_partials(*args, n_split=n, **kw)
        want = ref.decode_attention_partials(*args, n_split=n,
                                             tile=ops.DECODE_TILE, **kw)
        torch.cuda.synchronize()
        assert all(g.shape == w.shape for g, w in zip(got, want))
        torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-4)
        _assert_close(got[2], want[2], dtype)
        if n == 16:
            assert torch.all(want[0][..., :8] == ref.NEG_INF)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_decode_split_kernel_strided_row_views(cuda, mode):
    """Rows 1..4 of a 6-row pool and a 1024-slot ring prefix of its 2048:
    strided views, read in 8 splits, as the elastic decode passes them."""
    args, kw = _decode_inputs(cuda, 6, 24, 8, 128, 2048, live=1017,
                              int8=mode == "int8")
    q, k, v, sp, cur = args
    view = (q[1:5], k[1:5, :1024], v[1:5, :1024], sp[1:5, :1024], cur[1:5])
    vkw = {n: (t[1:5, :1024] if t is not None else None)
           for n, t in kw.items() if n in ("k_scale", "v_scale")}
    assert not view[1].is_contiguous()
    got = ops.decode_attention(*view, **vkw)
    dense = [t.contiguous() for t in view]
    want = ref.decode_attention(*dense, **{n: t.contiguous() for n, t in
                                           vkw.items()})
    _assert_close(got, want, torch.bfloat16)
    assert ops.decode_splits(4, 8, 1024, 128, 3, view[1].element_size()) > 1


def test_serving_attention_wrappers_do_not_sync(cuda):
    """Neither wrapper waits on the device: the split count comes from
    shapes, the partials from torch.empty."""
    args, kw = _decode_inputs(cuda, 4, 24, 8, 128, 2048, live=2000)
    q, k, v, sp, _ = args
    pq = torch.arange(1900, 1964, dtype=torch.int32, device=cuda)[None]
    pool = (q[:1, :, None].expand(1, 24, 64, 128).contiguous(),
            k[:1].transpose(1, 2), v[:1].transpose(1, 2), pq, sp[:1])
    ops.decode_attention(*args, **kw)
    ops.flash_attention_pool(*pool)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ops.decode_attention(*args, **kw)
        ops.flash_attention_pool(*pool)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


# -- the tensor-core pool kernel -------------------------------------------------
def _pool_inputs(cuda, C, G, Hkv, hd, *, S=700, end=650, wrap=None,
                 window=None, int8=False, rows=1, row=0, seed=0):
    """A C-token chunk at positions (end - C, end] against row ``row`` of a
    ``rows``-row bf16 pool (or int8 with scales), in the model's layout
    transposed to the kernel's, as ``transformer.py`` passes it."""
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            cuda)
    k, v = randn(rows, S, Hkv, hd), randn(rows, S, Hkv, hd)
    q = randn(1, C, G * Hkv, hd).bfloat16()
    sp = torch.full((rows, S), -1, dtype=torch.int32)
    if wrap is None:
        sp[:, :end + 1] = torch.arange(end + 1, dtype=torch.int32)
    else:
        pos = torch.arange(wrap - S + 1, wrap + 1, dtype=torch.int32)
        sp[:, pos.long() % S] = pos
        end = wrap
    pos_q = torch.arange(end - C + 1, end + 1, dtype=torch.int32,
                         device=cuda)[None]
    kw = dict(window=window)
    if int8:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        kw.update(k_scale=ks[row:row + 1].transpose(1, 2),
                  v_scale=vs[row:row + 1].transpose(1, 2))
    else:
        k, v = k.bfloat16(), v.bfloat16()
    return (q.transpose(1, 2), k[row:row + 1].transpose(1, 2),
            v[row:row + 1].transpose(1, 2), pos_q,
            sp[row:row + 1].to(cuda)), kw


@pytest.mark.parametrize("C", [2, 17, 512])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 3, 16])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_pool_tensor_core_kernel_matches_plain(cuda, mode, G, hd, C):
    """Packed (query, head-in-group) rows at G 1, 3 and 16: C G rows end
    mid-tile for C 2 and 17 (and for C 512 at G 3)."""
    args, kw = _pool_inputs(cuda, C, G, 2 if G < 16 else 1, hd,
                            int8=mode == "int8", seed=G * hd + C)
    before = ops.LAUNCHES["flash_attention_pool"]
    got = ops.flash_attention_pool(*args, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention_pool"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == args[0].shape
    _assert_close(got, ref.flash_attention_pool(*args, **kw), torch.bfloat16)


@pytest.mark.parametrize("case", ["window", "wrapped ring", "strided row",
                                  "int8 window wrapped", "int8 strided row"])
def test_pool_tensor_core_kernel_ring_cases(cuda, case):
    extra = {"window": dict(window=100),
             "wrapped ring": dict(wrap=3000),
             "strided row": dict(rows=4, row=2),
             "int8 window wrapped": dict(window=150, wrap=2500, int8=True),
             "int8 strided row": dict(rows=3, row=1, int8=True)}[case]
    args, kw = _pool_inputs(cuda, 96, 3, 8, 128, **extra)
    if "rows" in extra:
        assert not args[1].is_contiguous()
    got = ops.flash_attention_pool(*args, **kw)
    again = ops.flash_attention_pool(*args, **kw)
    assert ops.pool_splits(1, 8, 96, 700, 128, 3) > 1  # a merged split
    assert torch.equal(got, again)
    _assert_close(got, ref.flash_attention_pool(*args, **kw), torch.bfloat16)


@pytest.mark.parametrize("C", [1, 16, 42, 70])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gemm_kernel_matches_plain(cuda, C, dtype):
    """Ragged capacities (one row, a decode pool, a 512-token prefill
    bucket, two 64-row tiles) with d and f that divide no tile, on the
    strided capacity slice of a spill buffer as ``moe_ffn`` passes it."""
    rng = np.random.default_rng(C)
    E, d, f = 7, 200, 136
    x = torch.from_numpy(rng.standard_normal((E, C + 1, d), np.float32))
    w = torch.from_numpy(rng.standard_normal((E, d, f), np.float32) * 0.05)
    x, w = x.to(cuda, dtype)[:, :C], w.to(cuda, dtype)
    before = ops.LAUNCHES["moe_gemm"]
    got = ops.moe_gemm(x, w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["moe_gemm"] == before + 1
    assert got.shape == (E, C, f) and got.dtype == dtype
    _assert_close(got, ref.moe_gemm(x, w), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gemm_kernel_unaligned_rows(cuda, dtype):
    """Rows that do not start on 16-byte boundaries (d and f odd) take the
    element-by-element loads."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 5, 37), np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 37, 131), np.float32))
    x, w = x.to(cuda, dtype), w.to(cuda, dtype)
    _assert_close(ops.moe_gemm(x, w), ref.moe_gemm(x, w), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gemm_rows_do_not_depend_on_capacity(cuda, dtype):
    """Rows computed at C 1, 10, 16, 21 and 42 on the same inputs are
    bit-equal row for row (elastic decode changes C, and the served tokens'
    exactness must not depend on rounding): the kernel computes each output
    element as one ascending fused multiply-add chain over d, whatever C
    and the kernel and layout it takes (the ring, the 16-row tile at C
    9-15, four columns a lane at C 17-24)."""
    rng = np.random.default_rng(11)
    E, d, f = 5, 304, 200  # 16-byte rows (vector loads), ragged f tiles
    x = torch.from_numpy(rng.standard_normal((E, 43, d), np.float32))
    w = torch.from_numpy(rng.standard_normal((E, d, f), np.float32) * 0.05)
    x, w = x.to(cuda, dtype), w.to(cuda, dtype)
    full = ops.moe_gemm(x[:, :42], w)
    for C in (1, 10, 16, 21):
        assert torch.equal(ops.moe_gemm(x[:, :C], w), full[:, :C]), C
    _assert_close(full, ref.moe_gemm(x[:, :42], w), dtype)


@pytest.mark.parametrize("E,C", [(60, 16), (60, 42), (64, 16), (64, 60)])
@pytest.mark.parametrize("d,f", [(2048, 1408), (1408, 2048)])
def test_moe_gemm_kernel_at_the_serve_shapes(cuda, d, f, E, C):
    """qwen2-moe-a2.7b's (60 experts) and deepseek-v2-lite-16b's (64)
    expert GEMMs at full width (gate / up and down projections) in bf16, x
    on the capacity slice of the spill buffer: a 16-row decode pool and a
    512-token prefill bucket (capacity 42 at top-4, 60 at top-6)."""
    g = torch.Generator(device=cuda)
    g.manual_seed(C + d + E)
    x = torch.randn((E, C + 1, d), generator=g, device=cuda).bfloat16()
    w = (torch.randn((E, d, f), generator=g, device=cuda) * 0.02).bfloat16()
    got = ops.moe_gemm(x[:, :C], w)
    _assert_close(got, ref.moe_gemm(x[:, :C], w), torch.bfloat16)


def _fma_kernel():
    """The expert GEMM the shipped kernel replaced (tools/moe_gemm_fma.cu),
    built beside it: the yardstick of its rounding."""
    from pathlib import Path

    from repro_torch.kernels import build
    src = Path(__file__).resolve().parents[1] / "tools" / "moe_gemm_fma.cu"
    return build.load_variant(src, "moe_gemm_launch")


def _fma(x, w):
    out, rc = ops.moe_gemm_with(_fma_kernel(), x, w)
    assert rc == 0
    return out


def _served_rows(x, rng, pattern):
    """x with most rows zero, as a served call has them: per expert, the
    first 1-2 rows live and the rest zero ("suffix"), or 1-2 live rows at
    random places ("interleaved")."""
    E, C = x.shape[:2]
    keep = torch.zeros((E, C), dtype=torch.bool)
    for e in range(E):
        n = min(C, int(rng.integers(1, 3)))
        rows = np.arange(n) if pattern == "suffix" else \
            rng.choice(C, size=n, replace=False)
        keep[e, torch.from_numpy(np.asarray(rows))] = True
    return x.masked_fill_(~keep.to(x.device)[..., None], 0)


@pytest.mark.parametrize("rows", ["dense", "suffix", "interleaved"])
@pytest.mark.parametrize("C", [1, 2, 5, 8, 10, 16, 21, 42])
@pytest.mark.parametrize("d,f", [(2048, 1408), (1408, 2048)])
def test_moe_gemm_bit_equal_to_the_fma_kernel_at_the_serve_shapes(
        cuda, d, f, C, rows):
    """qwen2-moe-a2.7b's expert GEMMs at full width (60 experts, bf16, x on
    the capacity slice of the spill buffer) at the serve's capacities
    (decode pools of 1, 8 and 16 rows; prefill pieces at C 2, 5, 10, 21
    and 42), every row live or most rows zero (suffix: as moe_ffn fills its
    slots; interleaved): bitwise equal to the kernel it replaced, so the
    served tokens cannot move (the skip of zero rows included)."""
    g = torch.Generator(device=cuda)
    g.manual_seed(C + d)
    E = 60
    x = torch.randn((E, C + 1, d), generator=g, device=cuda).bfloat16()
    w = (torch.randn((E, d, f), generator=g, device=cuda) * 0.02).bfloat16()
    x = x[:, :C]
    if rows != "dense":
        x = _served_rows(x, np.random.default_rng(C), rows)
    got = ops.moe_gemm(x, w)
    assert torch.equal(got, _fma(x, w))
    if rows != "dense" and C > 2:
        assert (got.float().abs().sum(-1) == 0).any()  # dead rows stay 0


@pytest.mark.parametrize("C", [1, 2, 3, 5, 8, 9, 10, 15, 16, 17, 21, 24,
                               25, 42, 64, 70])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned", [True, False])
def test_moe_gemm_bit_equal_to_the_fma_kernel_ragged(cuda, C, dtype,
                                                      aligned):
    """Every kernel and layout the C table takes, each side of its cuts
    (the ring at 1, 2, 4 and 8 rows; the 16-row tile at C 9-15; the ring's
    2, 3 (four columns a lane), 4, 6 and 8 groups of 8 rows; two C tiles
    past 64) with d and f that divide no slice or tile, on aligned rows
    (16-byte copies) or unaligned ones (d and f odd: element loads), some
    rows zero: bitwise equal to the kernel it replaced, in both dtypes."""
    rng = np.random.default_rng(C + 7 * aligned)
    E, d, f = (5, 208, 136) if aligned else (3, 37, 131)
    x = rng.standard_normal((E, C + 1, d), np.float32)
    x[:, 1::3] = 0.0  # zero rows interleaved with live ones
    x = torch.from_numpy(x).to(cuda, dtype)[:, :C]
    w = torch.from_numpy(rng.standard_normal((E, d, f), np.float32)
                         * 0.05).to(cuda, dtype)
    assert bool(ops._aligned16(x) and ops._aligned16(w)) == aligned
    got = ops.moe_gemm(x, w)
    assert torch.equal(got, _fma(x, w))
    _assert_close(got, ref.moe_gemm(x, w), dtype)


def test_moe_gemm_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((2, 4, 8), device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.moe_gemm(x, torch.zeros((2, 8, 4), device=cuda).bfloat16())
    with pytest.raises(ValueError, match="shapes"):
        ops.moe_gemm(x, torch.zeros((2, 4, 8), device=cuda))
    with pytest.raises(ValueError, match="stride 1"):
        ops.moe_gemm(torch.zeros((2, 8, 4), device=cuda).transpose(1, 2),
                     torch.zeros((2, 8, 4), device=cuda))


def _wide(x, dtype, cuda):
    """``x`` on the card as a strided view: its last axis inside a wider
    buffer and its leading axis every other row."""
    t = torch.from_numpy(x).to(cuda, dtype)
    buf = torch.zeros((2 * t.shape[0],) + t.shape[1:-1]
                      + (t.shape[-1] + 8,), dtype=dtype, device=cuda)
    view = buf[::2, ..., 3:3 + t.shape[-1]]
    view.copy_(t)
    return view


@pytest.mark.parametrize("B,S,W", RGLRU_CASES + [(16, 1, 4096),
                                                 (1, 300, 520)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_kernel_matches_plain(cuda, B, S, W, dtype):
    """Ragged W and S, a decode step, a nonzero h0, strided views."""
    x, a, g, h0 = rglru_case(B, S, W)
    tx, tg = _wide(x, dtype, cuda), _wide(g, dtype, cuda)
    ta, th0 = _wide(a, torch.float32, cuda), _wide(h0, torch.float32, cuda)
    assert not tx.is_contiguous()
    before = ops.LAUNCHES["rglru_scan"]
    h, f = ops.rglru_scan(tx, ta, tg, th0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rglru_scan"] == before + 1
    assert h.dtype == dtype and f.dtype == torch.float32
    want_h, want_f = ref.rglru_scan(tx, ta, tg, th0)
    _assert_close(h, want_h, dtype)
    torch.testing.assert_close(f, want_f, rtol=1e-4, atol=1e-4)


def _rglru_on_card(B, S, W, dtype, cuda, seed=0, strided=True):
    """A ``rglru_case`` on the card, as strided views or dense tensors."""
    x, a, g, h0 = rglru_case(B, S, W, seed=seed)
    if not strided:
        return tuple(torch.from_numpy(t).to(cuda, d) for t, d in
                     ((x, dtype), (a, torch.float32), (g, dtype),
                      (h0, torch.float32)))
    return (_wide(x, dtype, cuda), _wide(a, torch.float32, cuda),
            _wide(g, dtype, cuda), _wide(h0, torch.float32, cuda))


RGLRU_L = ops.RGLRU_CHUNK  # L, tokens a chunk of the kernel


@pytest.mark.parametrize("S", [1, RGLRU_L - 1, RGLRU_L, RGLRU_L + 1,
                               2 * RGLRU_L + 1, 300, 512, 1024])
@pytest.mark.parametrize("B", [1, 2, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("strided", [True, False])
def test_rglru_scan_chunks_match_plain(cuda, S, B, dtype, strided):
    """The chunked kernel at the chunk boundaries (S 1, L - 1, L, L + 1,
    2 L + 1) and long prompts (300: a ragged last chunk; 512; 1024), one to
    16 rows, ragged W (520: a part tile), strided views or dense tensors
    and a nonzero h0: one launch, against the per-step plain version,
    h_final included."""
    args = _rglru_on_card(B, S, 520, dtype, cuda, seed=S + B,
                          strided=strided)
    before = ops.LAUNCHES["rglru_scan"]
    h, f = ops.rglru_scan(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rglru_scan"] == before + 1
    assert h.dtype == dtype and f.dtype == torch.float32
    want_h, want_f = ref.rglru_scan(*args)
    _assert_close(h, want_h, dtype)
    torch.testing.assert_close(f, want_f, rtol=1e-4, atol=1e-4)


def _rglru64(x, a_log, gate, h0):
    """Per-step RG-LRU in float64: (h, h_final)."""
    a = torch.exp(a_log.double())
    u = torch.sqrt(torch.clamp_min(1 - a * a, 0)) * (gate.double()
                                                     * x.double())
    h, hs = h0.double(), []
    for t in range(x.shape[1]):
        h = a[:, t] * h + u[:, t]
        hs.append(h)
    return torch.stack(hs, 1), h


@pytest.mark.parametrize("decay", ["strong", "weak"])
@pytest.mark.parametrize("S", [300, 1024])
def test_rglru_scan_chunks_at_extreme_decays(cuda, decay, S):
    """Log decays near -8 (a chunk's prod a_t underflows to 0) or near 0
    (h carried across every chunk, sqrt(1 - a^2) magnifying each rounding
    of a): out and h_final finite and, against float64 (max abs error),
    within 2x the plain f32 version's error (plus 1e-7 of the largest
    |value|, so an exact plain version does not make the limit 0)."""
    x, a, g, h0 = rglru_case(2, S, 520, seed=S)
    a = (a * 1e-3 - 8.0) if decay == "strong" else a * 1e-4
    args = [torch.from_numpy(t).to(cuda) for t in (x, a, g, h0)]
    got = ops.rglru_scan(*args)
    plain = ref.rglru_scan(*args)
    want = _rglru64(*args)
    for k, p, t in zip(got, plain, want):
        assert torch.isfinite(k).all()
        err = (k.double() - t).abs().max().item()
        plain_err = (p.double() - t).abs().max().item()
        assert err <= 2 * plain_err + 1e-7 * t.abs().max().item(), \
            (err, plain_err)


def test_scan_launches_in_a_row_reuse_the_buffers(cuda):
    """Forty launches of both scans on one stream with no sync between
    them (the RG-LRU kernel at S 1..700, one and many chunks, after a first
    launch that sizes its flags): each launch a new epoch on the same
    counter and flags, every result equal to the plain version's."""
    rng = np.random.default_rng(4)
    calls, first = [], None
    for i in range(40):
        S = 700 if i == 0 else int(rng.integers(1, 700))
        if i % 4 == 3:
            args = _rwkv6_on_card(rwkv6_case(4, S, 64, seed=i),
                                  torch.bfloat16, cuda, True)
            calls.append((ref.rwkv6_scan, args, ops.rwkv6_scan(*args)))
            continue
        args = _rglru_on_card(3, S, 300, torch.bfloat16, cuda, seed=i)
        calls.append((ref.rglru_scan, args, ops.rglru_scan(*args)))
        sync = ops._CHUNK_SYNC[ops._chunk_sync_key("rglru_scan",
                                                    args[0].device)]
        if first is None:
            first, epoch0, taken0 = sync, sync.epoch, sync.taken
    multi = sum(1 for fn, a, _ in calls[1:] if fn is ref.rglru_scan
                and a[0].shape[1] > RGLRU_L)
    assert sync is first and sync.taken > taken0
    assert epoch0 < sync.epoch <= epoch0 + multi
    torch.cuda.synchronize()
    for fn, args, got in calls:
        plain = fn(*args)
        _assert_close(got[0], plain[0], torch.bfloat16)
        torch.testing.assert_close(got[1], plain[1], rtol=1e-4, atol=1e-4)


def test_chunked_scans_refuse_graph_capture_on_card(cuda):
    """A multi-chunk launch of either scan inside a CUDA graph capture
    raises (a replay would reuse the host's epoch and tiles taken); the
    same launches run eagerly afterwards."""
    rg = _rglru_on_card(1, 64, 128, torch.bfloat16, cuda)
    wk = _rwkv6_on_card(rwkv6_case(2, 64, 64), torch.bfloat16, cuda, True)
    for scan, args in ((ops.rglru_scan, rg), (ops.rwkv6_scan, wk)):
        scan(*args)
        torch.cuda.synchronize()
        with pytest.raises(RuntimeError, match="CUDA graph"):
            with torch.cuda.graph(torch.cuda.CUDAGraph()):
                scan(*args)
    torch.cuda.synchronize()
    for scan, plain, args in ((ops.rglru_scan, ref.rglru_scan, rg),
                              (ops.rwkv6_scan, ref.rwkv6_scan, wk)):
        _assert_close(scan(*args)[0], plain(*args)[0], torch.bfloat16)


@pytest.mark.parametrize("BH,S,D", RWKV6_CASES + [(32, 300, 64),
                                                  (512, 1, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_scan_kernel_matches_plain(cuda, BH, S, D, dtype, with_state):
    """D 32 and 64, ragged S, a decode step, zero or nonzero state0, on
    strided views (the (BH, S, D) cases as B = 1)."""
    r, k, v, w, u, s0 = rwkv6_case(BH, S, D)
    tr, tk, tv = (_wide(t, dtype, cuda)[None] for t in (r, k, v))
    tw = _wide(w, torch.float32, cuda)[None]
    tu = _wide(u, torch.float32, cuda)[None]
    ts0 = _wide(s0, torch.float32, cuda)[None] if with_state else None
    before = ops.LAUNCHES["rwkv6_scan"]
    o, s = ops.rwkv6_scan(tr, tk, tv, tw, tu, ts0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rwkv6_scan"] == before + 1
    want_o, want_s = ref.rwkv6_scan(tr, tk, tv, tw, tu, ts0)
    _assert_close(o, want_o, dtype)
    # the state is f32 on both sides; bf16 inputs enter it exactly
    torch.testing.assert_close(s, want_s, rtol=1e-4, atol=1e-4)


def _rwkv6_on_card(case, dtype, cuda, with_state):
    """A ``rwkv6_case`` as strided (1, BH, S, D) views on the card."""
    r, k, v, w, u, s0 = case
    tr, tk, tv = (_wide(t, dtype, cuda)[None] for t in (r, k, v))
    tw, tu = (_wide(t, torch.float32, cuda)[None] for t in (w, u))
    ts0 = _wide(s0, torch.float32, cuda)[None] if with_state else None
    return tr, tk, tv, tw, tu, ts0


@pytest.mark.parametrize("S", [1, 31, 33, 100, 128, 512])
@pytest.mark.parametrize("BH", [1, 32, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_scan_chunks_match_plain(cuda, S, BH, dtype, with_state):
    """The chunked kernel at one chunk and less (S 1, 31), a ragged last
    chunk (33, 100), whole chunks (128, 512: the folds of up to 15 earlier
    chunks' states), one to 512 (row, head) pairs, zero or nonzero state0:
    one launch, against the per-timestep plain version."""
    args = _rwkv6_on_card(rwkv6_case(BH, S, 64, seed=S + BH), dtype, cuda,
                          with_state)
    before = ops.LAUNCHES["rwkv6_scan"]
    o, s = ops.rwkv6_scan(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rwkv6_scan"] == before + 1
    assert o.dtype == dtype and s.dtype == torch.float32
    want_o, want_s = ref.rwkv6_scan(*args)
    _assert_close(o, want_o, dtype)
    torch.testing.assert_close(s, want_s, rtol=1e-4, atol=1e-4)


def _wkv64(r, k, v, w, u, s0):
    """Per-timestep WKV6 in float64 on (BH, S, D) inputs: (out, state)."""
    r, k, v, w, u, st = (x.double() for x in (r, k, v, w, u, s0))
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, None] * v[:, t, None, :]
        outs.append(torch.einsum("bd,bde->be", r[:, t], st + u[:, 0, :, None]
                                 * kv))
        st = st * torch.exp(w[:, t])[..., None] + kv
    return torch.stack(outs, 1), st


@pytest.mark.parametrize("decay", ["strong", "weak"])
@pytest.mark.parametrize("D", [32, 64])
def test_rwkv6_scan_chunks_at_extreme_decays(cuda, decay, D):
    """Every third token's log decay at -20 (the state all but wiped: a
    factorisation through e^{-L} would overflow f32 within a chunk), or
    every log decay near -1e-3 (the state carried across all 16 chunks of
    S 512, its entries growing to tens): out and state finite; with strong
    decays, within _assert_close of the per-token plain version; and each
    as close to float64 (of the largest |value|) as the chunked plain form
    the model's plain path runs (the pairwise form in f32 that the kernel
    and the Pallas kernel compute), within 3x.  (With weak decays the f32
    sums of both forms part by more than 1e-4 from the per-token ones.)"""
    from repro_torch.models import ssm
    r, k, v, w, u, s0 = rwkv6_case(32, 512, D, seed=D)
    if decay == "strong":
        w[:, ::3] = -20.0
    else:
        w = w * 1e-3
    args = _rwkv6_on_card((r, k, v, w, u, s0), torch.float32, cuda, True)
    o, s = ops.rwkv6_scan(*args)
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    if decay == "strong":
        want_o, want_s = ref.rwkv6_scan(*args)
        _assert_close(o, want_o, torch.float32)
        torch.testing.assert_close(s, want_s, rtol=1e-4, atol=1e-4)
    tr, tk, tv, tw, tu, ts0 = args
    chunked = ssm.rwkv6_scan_chunked(tr, tk, tv, tw, tu[0, :, 0], ts0)
    want = _wkv64(*(x[0] for x in args))
    for got, plain, x in zip((o, s), chunked, want):
        err = (got[0].double() - x).abs().max().item()
        plain_err = (plain[0].double() - x).abs().max().item()
        assert err <= 3 * plain_err + 1e-7 * x.abs().max().item(), \
            (err, plain_err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_scan_kernel_takes_the_model_head_split(cuda, dtype):
    """(B, S, H, D) -> (B, H, S, D) transposed views and a per-head u of
    shape (H, 1, D), as ``ssm.rwkv6_block`` passes them."""
    B, S, H, D = 3, 40, 4, 64
    rng = np.random.default_rng(9)
    r, k, v = ((torch.from_numpy(rng.standard_normal((B, S, H * D),
                                                     dtype=np.float32))
                .to(cuda, dtype) * 0.5).reshape(B, S, H, D).transpose(1, 2)
               for _ in range(3))
    w = -torch.rand((B, S, H, D), device=cuda).transpose(1, 2)
    u = torch.randn((H, 1, D), device=cuda) * 0.3
    s0 = torch.randn((B, H, D, D), device=cuda) * 0.3
    o, s = ops.rwkv6_scan(r, k, v, w, u, s0)
    want_o, want_s = ref.rwkv6_scan(r, k, v, w, u, s0)
    _assert_close(o, want_o, dtype)
    torch.testing.assert_close(s, want_s, rtol=1e-4, atol=1e-4)
    assert o.transpose(1, 2).is_contiguous()  # reshapes back for free


def test_scan_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((1, 4, 8), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        ops.rglru_scan(x, x.bfloat16(), x, x[:, 0])
    with pytest.raises(ValueError, match="stride 1"):
        ops.rglru_scan(x.transpose(1, 2), x.transpose(1, 2),
                       x.transpose(1, 2), x[:, :, 0])
    r = torch.zeros((1, 2, 4, 48), device=cuda)  # head size 48
    with pytest.raises(ValueError, match="head size"):
        ops.rwkv6_scan(r, r, r, r, r[:, :, :1])
    r = torch.zeros((1, 2, 4, 32), device=cuda)
    with pytest.raises(ValueError, match="state0"):
        ops.rwkv6_scan(r, r, r, r, r[:, :, :1],
                       torch.zeros((1, 2, 32, 16), device=cuda))
    with pytest.raises(ValueError, match=r"\(B, H, S, D\)"):
        ops.rwkv6_scan(r[0], r[0], r[0], r[0], r[0, :, :1])


# kernels each tiny serve must launch with kernel_backend="cuda"
SERVE_KERNELS = {
    "llama3.2-3b": {"decode_attention", "flash_attention_pool"},
    "qwen2-moe-a2.7b": {"decode_attention", "flash_attention_pool",
                        "moe_gemm"},
    "recurrentgemma-9b": {"decode_attention", "flash_attention_pool",
                          "rglru_scan"},
    TAIL: {"decode_attention", "flash_attention_pool", "rglru_scan"},
    "rwkv6-1.6b": {"rwkv6_scan"},
    # MLA attention has no kernel: only the expert GEMM
    "deepseek-v2-lite-16b": {"moe_gemm"}}


@pytest.mark.parametrize("arch", sorted(SERVE_KERNELS))
def test_tiny_serve_through_kernels_matches_plain_path(cuda, arch):
    from repro_torch.configs import get_tiny_config
    from repro_torch.core import Priority, Request
    from repro_torch.core.engine import RealAgentXPUEngine
    from repro_torch.models import init_params
    cfg = tiny(get_tiny_config, arch)
    params = init_params(cfg, seed=0, dtype=torch.float32, device=cuda)
    rng = np.random.default_rng(0)
    toks = [rng.integers(0, cfg.vocab_size, (1, n)) for n in (9, 23, 14)]
    out = {}
    for backend in ("cuda", "plain"):
        eng = RealAgentXPUEngine(cfg, params, max_len=64,
                                 kernel_backend=backend)
        reqs = [Request(id=i, priority=Priority.REACTIVE if i == 1
                        else Priority.PROACTIVE, prompt_len=t.shape[1],
                        max_new_tokens=8, arrival_time=0.01 * i, tokens=t)
                for i, t in enumerate(toks)]
        before = dict(ops.LAUNCHES)
        m = eng.serve(reqs)
        assert len(m.completed) == 3
        launched = {k for k in before if ops.LAUNCHES[k] > before[k]}
        assert launched == (SERVE_KERNELS[arch] if backend == "cuda"
                            else set()), launched
        out[backend] = [eng.output_tokens(i) for i in range(3)]
    assert out["cuda"] == out["plain"]


# -- shared-prefix KV copies on CUDA pools ------------------------------------
def _random_pool(kv_dtype, device, seed=0):
    """A 3-row tiny llama3-405b pool (max_len 64) with every leaf drawn
    from numpy: bf16 K/V or int8 K/V with f32 scales, rows at positions
    40, 23 and 9."""
    from repro_torch.configs import get_tiny_config
    from repro_torch.models import init_cache, init_params
    cfg = get_tiny_config("llama3-405b")
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    pool = init_cache(cfg, params, 3, 64, torch.bfloat16, kv_dtype=kv_dtype,
                      device="cpu")
    rng = np.random.default_rng(seed)
    pool["pos"] = torch.tensor([40, 23, 9], dtype=torch.int32)
    for st in pool["blocks"].values():
        for name, x in st.items():
            if name == "slot_pos":
                ring = torch.arange(x.shape[-1], dtype=torch.int32)
                x.copy_(torch.where(ring < pool["pos"][None, :, None], ring,
                                    -1))
            elif x.dtype == torch.int8:
                x.copy_(torch.from_numpy(rng.integers(-127, 128, x.shape,
                                                      dtype=np.int8)))
            else:
                x.copy_(torch.from_numpy(rng.uniform(
                    0.01, 1.0, x.shape).astype(np.float32)))
    return {"pos": pool["pos"].to(device), "head": (), "tail": (),
            "blocks": {pi: {n: x.to(device) for n, x in st.items()}
                       for pi, st in pool["blocks"].items()}}


def _pool_leaves(pool):
    return [pool["pos"]] + [x for st in pool["blocks"].values()
                            for x in st.values()]


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["bf16", "int8"])
def test_prefix_helpers_on_cuda_pools_equal_cpu(cuda, kv_dtype):
    """copy_prefix_rows, snapshot_prefix and paste_prefix on a CUDA pool
    give the CPU pool's results bit for bit."""
    from repro_torch.models import (copy_prefix_rows, paste_prefix,
                                    snapshot_prefix)
    pools = {d: _random_pool(kv_dtype, d) for d in ("cpu", cuda)}
    entries = {}
    for d, pool in pools.items():
        copy_prefix_rows(pool, 0, 2, 11, 16, 64)
        entries[d] = snapshot_prefix(pool, 0, 32, 64)
        paste_prefix(pool, entries[d], 1, 27, 32, 32, 64)
    for a, b in zip(_pool_leaves(pools["cpu"]), _pool_leaves(pools[cuda])):
        assert torch.equal(a, b.cpu())
    assert pools["cpu"]["pos"].tolist() == [40, 27, 11]


def test_prefix_copy_and_paste_do_not_sync(cuda):
    """A row-to-row prefix copy and a store paste run on the device with
    no host sync (the backend launches them between decode segments)."""
    from repro_torch.models import (copy_prefix_rows, paste_prefix,
                                    snapshot_prefix)
    pool = _random_pool("int8", cuda)
    entry = snapshot_prefix(pool, 0, 32, 64)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        copy_prefix_rows(pool, 0, 2, 11, 16, 64)
        paste_prefix(pool, entry, 1, 27, 32, 32, 64)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_tiny_prefix_serve_through_kernels_matches_plain_path(cuda):
    """Three flows sharing a 24-token system prompt: the hit flows' tails
    run the pool kernel over copied rows, and every token equals the plain
    path's serve of the same trace."""
    from repro_torch.configs import get_tiny_config
    from repro_torch.core import Priority, Request
    from repro_torch.core.engine import RealAgentXPUEngine
    from repro_torch.models import init_params
    cfg = get_tiny_config("llama3-405b")
    params = init_params(cfg, seed=0, dtype=torch.float32, device=cuda)
    rng = np.random.default_rng(1)
    system = rng.integers(0, cfg.vocab_size, (1, 24))
    toks = [np.concatenate([system, rng.integers(0, cfg.vocab_size, (1, n))],
                           axis=1) for n in (9, 23, 14)]
    out = {}
    for backend in ("cuda", "plain"):
        eng = RealAgentXPUEngine(cfg, params, max_len=64,
                                 kernel_backend=backend)
        m = eng.serve([Request(id=i, priority=Priority.PROACTIVE,
                               prompt_len=t.shape[1], max_new_tokens=8,
                               arrival_time=0.01 * i, tokens=t)
                       for i, t in enumerate(toks)])
        assert len(m.completed) == 3
        st = eng.stats()
        assert st["prefix_hits"] == 2 and st["prefix_fallbacks"] == 0
        assert eng.backend.validate() == []
        out[backend] = [eng.output_tokens(i) for i in range(3)]
    assert out["cuda"] == out["plain"]



# -- the training flash attention and its backward ----------------------------
#   (B, Hq, Hkv, Sq, Skv, hd, window): G 1, 3 and 8, head_dim 32 to 256,
#   ragged S (not a multiple of the 32-row tiles), S 40, a window, Sq != Skv
#   (every query with a valid key: see ops.flash_attention)
FLASH_CUDA_CASES = [(2, 4, 4, 96, 96, 32, None), (2, 6, 2, 300, 300, 64, None),
                    (1, 24, 8, 200, 200, 128, None), (1, 8, 1, 40, 40, 32, None),
                    (2, 6, 2, 257, 257, 128, 64), (1, 4, 2, 130, 130, 256, 48),
                    (1, 6, 2, 40, 72, 64, None), (1, 6, 2, 72, 40, 64, 40)]


def _flash_case(case, dtype, device, seed=0):
    """q, K, V and d_out as the model passes them: (B, S, H, hd) tensors
    transposed to (B, H, S, hd) views."""
    B, Hq, Hkv, Sq, Skv, hd, _ = case
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    mk = lambda S, H: torch.randn((B, S, H, hd), generator=g,  # noqa: E731
                                  device=device).to(dtype).transpose(1, 2)
    return mk(Sq, Hq), mk(Skv, Hkv), mk(Skv, Hkv), mk(Sq, Hq)


@pytest.mark.parametrize("case", FLASH_CUDA_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_match_plain(cuda, case, dtype):
    """The forward (output and lse) and the backward (dq, dk, dv) kernels
    against their plain versions on the same inputs; the backward is
    bit-equal across two runs (no atomics)."""
    window = case[-1]
    q, k, v, d_out = _flash_case(case, dtype, cuda)
    before = dict(ops.LAUNCHES)
    out, lse = ops.flash_attention(q, k, v, window=window, return_lse=True)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    want, want_lse = ref.flash_attention_lse(q, k, v, window=window)
    assert out.dtype == dtype and out.stride() == q.stride()
    _assert_close(out, want, dtype)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
    # the backward on the plain forward's (out, lse), as the plain one
    grads = ops.flash_attention_bwd(q, k, v, want, want_lse, d_out,
                                    window=window)
    again = ops.flash_attention_bwd(q, k, v, want, want_lse, d_out,
                                    window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 2
    wants = ref.flash_attention_bwd(q, k, v, want, want_lse, d_out,
                                    window=window)
    for got, rep, w, x in zip(grads, again, wants, (q, k, v)):
        assert got.dtype == dtype and got.stride() == x.stride()
        assert torch.equal(got, rep)
        _assert_close(got, w, dtype)


@pytest.mark.parametrize("window", [None, 77])
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("S", [40, 100, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_ragged_tiles(cuda, dtype, S, hd, G, window):
    """The backward kernel at lengths that are no multiple of its 64-row
    block tiles (32 at head_dim 256) or its 32-row streamed tiles, one and
    three query heads a kv head, causal and windowed, every head_dim:
    against the plain version and bit-equal across two runs."""
    q, k, v, d_out = _flash_case((1, 2 * G, 2, S, S, hd, window), dtype,
                                 cuda, seed=S + hd + G)
    want, want_lse = ref.flash_attention_lse(q, k, v, window=window)
    args = (q, k, v, want, want_lse, d_out)
    grads = ops.flash_attention_bwd(*args, window=window)
    again = ops.flash_attention_bwd(*args, window=window)
    torch.cuda.synchronize()
    wants = ref.flash_attention_bwd(*args, window=window)
    for got, rep, w in zip(grads, again, wants):
        assert torch.equal(got, rep)
        _assert_close(got, w, dtype)


@pytest.mark.parametrize("window", [None, 77])
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("S", [40, 100, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_kernel_ragged_tiles(cuda, dtype, S, hd, G, window):
    """The forward kernel at lengths that are no multiple of its 64-row
    query tiles (32 at head_dim 256) or its 32-row key tiles, one and three
    query heads a kv head, causal and windowed, every head_dim: one launch,
    out and lse against the plain version."""
    q, k, v, _ = _flash_case((1, 2 * G, 2, S, S, hd, window), dtype, cuda,
                             seed=S + hd + G)
    before = ops.LAUNCHES["flash_attention"]
    out, lse = ops.flash_attention(q, k, v, window=window, return_lse=True)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want, want_lse = ref.flash_attention_lse(q, k, v, window=window)
    assert out.dtype == dtype and out.stride() == q.stride()
    _assert_close(out, want, dtype)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)


def test_flash_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 4, 8, 32), device=cuda)
    k = torch.zeros((1, 2, 8, 32), device=cuda)
    q48, k48 = q.new_zeros((1, 4, 8, 48)), k.new_zeros((1, 2, 8, 48))
    with pytest.raises(ValueError, match="head_dim 48"):
        ops.flash_attention(q48, k48, k48)
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q[:, :3], k, k)
    with pytest.raises(ValueError, match="share"):
        ops.flash_attention(q, k.bfloat16(), k)
    qt = q.new_zeros((1, 4, 32, 8)).transpose(2, 3)  # head_dim stride 8
    kt = k.new_zeros((1, 2, 32, 8)).transpose(2, 3)
    with pytest.raises(ValueError, match="stride 1"):
        ops.flash_attention(qt, kt, kt)
    with pytest.raises(ValueError, match="lse"):
        ops.flash_attention_bwd(q, k, k, q, torch.zeros((1, 4, 8),
                                                        device=cuda).half(),
                                q)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "starcoder2-7b",
                                  "qwen2-moe-a2.7b", "recurrentgemma-9b",
                                  TAIL, "rwkv6-1.6b",
                                  "deepseek-v2-lite-16b"])
def test_tiny_train_step_through_kernels_matches_plain_path(cuda, arch):
    """A tiny f32 model's loss and gradients with kernel_backend="cuda"
    (each GQA attention layer: one forward launch, one more in remat's
    recompute, one backward launch; MLA attention, the expert GEMM and the
    scans none, training runs them on the plain path) against the plain
    path on the same card."""
    from repro_torch.configs import get_tiny_config
    from repro_torch.models import init_params, layout
    from repro_torch.train.train_loop import loss_and_grads
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tiny(get_tiny_config, arch)
    head, pattern, repeats, tail = layout(cfg)
    n_attn = 0 if cfg.use_mla else \
        (head + pattern * repeats + tail).count("attn")
    params = init_params(cfg, seed=0, dtype=torch.float32, device=cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 81))).to(cuda)
    runs = {}
    for backend in ("cuda", "plain"):
        before = dict(ops.LAUNCHES)
        loss, _, grads = loss_and_grads(cfg, params, toks,
                                        kernel_backend=backend)
        n = {k: ops.LAUNCHES[k] - before[k] for k in before}
        want = {k: 0 for k in before}
        if backend == "cuda":
            want.update(flash_attention=2 * n_attn,
                        flash_attention_bwd=n_attn)
        assert n == want, n
        runs[backend] = (loss, {k: g.clone() for k, g in grads.items()})
    (lc, gc), (lp, gp) = runs["cuda"], runs["plain"]
    assert abs(float(lc) - float(lp)) <= 1e-5 * abs(float(lp))
    for name, g in gp.items():
        rel = (gc[name] - g).norm() / g.norm()
        assert rel <= 1e-4, (name, float(rel))


# -- stage-decoupled execution on the card (DESIGN.md §14) ----------------------
def test_chunked_scans_on_two_streams_at_once(cuda):
    """Multi-chunk launches of each scan in flight on two streams at once
    (both queued behind the same device spin, so they start together):
    each stream keeps its own chunk-order counter and flags
    (``ops._chunk_sync`` keys the stream), and every result equals the
    plain version's."""
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    main = torch.cuda.current_stream()
    calls = []
    for rep in range(3):
        inputs = [(_rglru_on_card(2, 700, 520, torch.bfloat16, cuda,
                                  seed=10 * rep + i),
                   _rwkv6_on_card(rwkv6_case(32, 300, 64, seed=10 * rep + i),
                                  torch.bfloat16, cuda, True))
                  for i in range(2)]
        for s in streams:
            s.wait_stream(main)
        for s in streams:
            with torch.cuda.stream(s):
                torch.cuda._sleep(2_000_000)
        for s, (rg, wk) in zip(streams, inputs):
            with torch.cuda.stream(s):
                calls.append((ref.rglru_scan, rg, ops.rglru_scan(*rg)))
                calls.append((ref.rwkv6_scan, wk, ops.rwkv6_scan(*wk)))
    keys = {ops._chunk_sync_key(n, cuda) for n in ("rglru_scan",
                                                   "rwkv6_scan")}
    for s in streams:
        with torch.cuda.stream(s):
            for n in ("rglru_scan", "rwkv6_scan"):
                key = ops._chunk_sync_key(n, cuda)
                assert key in ops._CHUNK_SYNC and key not in keys
    torch.cuda.synchronize()
    for fn, args, got in calls:
        plain = fn(*args)
        _assert_close(got[0], plain[0], torch.bfloat16)
        torch.testing.assert_close(got[1], plain[1], rtol=1e-4, atol=1e-4)


def _tiny_llama(cuda, arch="llama3-405b"):
    from repro_torch.configs import get_tiny_config
    from repro_torch.models import init_params
    cfg = get_tiny_config(arch)
    return cfg, init_params(cfg, seed=0, dtype=torch.float32, device=cuda)


def _staged_backend(cfg, params, cuda, **kw):
    """A ``DualDeviceBackend`` whose prefill lane is a second stream of the
    card (the prefill device named as the decode device)."""
    from repro_torch.core.backend import DualDeviceBackend
    be = DualDeviceBackend(cfg, params, pool_slots=2, max_len=256,
                           device=cuda, prefill_device=cuda, **kw)
    assert be.dual_device and be._pf_stream is not None
    assert be._pf_stream != torch.cuda.current_stream()
    return be


def _prompt_req(cfg, rid, n, seed):
    from repro_torch.core import Priority, Request
    return Request(id=rid, priority=Priority.PROACTIVE, prompt_len=n,
                   max_new_tokens=4, arrival_time=0.0,
                   tokens=np.random.default_rng(seed).integers(
                       0, cfg.vocab_size, (1, n)))


def _row_of(pool, slot, n):
    """Pool row ``slot``'s ``pos`` and its first ``n`` ring slots of every
    leaf (the rest of a reused row is stale payload under -1)."""
    out = [pool["pos"][slot].clone()]
    for st in pool["blocks"].values():
        for name, x in sorted(st.items()):
            out.append(x[:, slot, :n].clone())
    return out


def test_staged_handoff_race_equals_sequential_twin(cuda):
    """The handoff's install waits behind a spin queued on the decode
    stream while the next prefill is staged at once into the recycled
    staging cache (``prefill_inflight_max=1``): the recycled cache is reset
    only after the install read it, and the first token's one host fetch
    waits on the prefill lane only (the decode stream is still spinning
    when ``prefill_done`` returns).  Both installed rows equal a twin's
    that synchronises after every step."""
    cfg, params = _tiny_llama(cuda)
    reqs = [(_prompt_req(cfg, 1, 160, 1), 1), (_prompt_req(cfg, 2, 150, 2),
                                               0)]
    rows = {}
    for racing in (True, False):
        be = _staged_backend(cfg, params, cuda, prefill_inflight_max=1)
        for r, _ in reqs:
            be.register(r)
        a, b = reqs[0][0], reqs[1][0]
        be.prefill_chunk(a, 0, 128, 0.0)
        be.prefill_chunk(a, 128, 32, 0.0)
        if racing:
            torch.cuda._sleep(200_000_000)  # ~0.1 s on the decode stream
        else:
            torch.cuda.synchronize()
        be.prefill_done(a, 0.0)
        if racing:
            assert not torch.cuda.current_stream().query()
        else:
            torch.cuda.synchronize()
        be.prefill_chunk(b, 0, 128, 0.0)  # the recycled staging cache
        assert not be._staging_free and be.colocated_backpressure == 0
        be.prefill_chunk(b, 128, 22, 0.0)
        be.prefill_done(b, 0.0)
        torch.cuda.synchronize()
        assert be.handoff_device_calls == be.staged_prefills == 2
        rows[racing] = ([_row_of(be._pool, be._slot[r.id], 256)
                         for r, _ in reqs],
                        [be.output_tokens(r.id) for r, _ in reqs],
                        be._toks.clone())
        assert be.validate() == []
    for x, y in zip(rows[True][0], rows[False][0]):
        assert all(torch.equal(p, q) for p, q in zip(x, y))
    assert rows[True][1] == rows[False][1]
    assert torch.equal(rows[True][2], rows[False][2])


@pytest.mark.parametrize("arch", ["llama3-405b", "qwen2-moe-a2.7b",
                                  "recurrentgemma-9b", "rwkv6-1.6b",
                                  "deepseek-v2-lite-16b"])
def test_staged_prefill_chunks_issue_no_host_sync(cuda, arch):
    """A staged prefill's chunks (the prompt's pinned upload, the staging
    cache, every bucket's forward, the chunked scans among them, and the
    next-token scalar) issue no host sync until ``prefill_done``'s one
    fetch, in every served family."""
    cfg, params = _tiny_llama(cuda, arch)
    be = _staged_backend(cfg, params, cuda)
    warm, r = _prompt_req(cfg, 1, 100, 3), _prompt_req(cfg, 2, 100, 4)
    for q in (warm, r):
        be.register(q)
    be.prefill_chunk(warm, 0, 100, 0.0)  # first use of every shape
    be.prefill_done(warm, 0.0)
    torch.cuda.synchronize()
    syncs = be.host_syncs
    torch.cuda.set_sync_debug_mode("error")
    try:
        be.prefill_chunk(r, 0, 64, 0.0)
        be.prefill_chunk(r, 64, 36, 0.0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert be.host_syncs == syncs
    be.prefill_done(r, 0.0)
    assert be.host_syncs == syncs + 1
    assert be.prefill_host_syncs == 2


@pytest.mark.parametrize("lane", ["stream", "second_gpu"])
def test_tiny_dual_serve_on_card_equals_single_lane(cuda, lane):
    """A tiny f32 serve with prefill staged on a second stream (or on a
    second GPU, the weights copied there and the staged row moved across)
    streams the single-lane engine's tokens (both through the kernels),
    flow for flow, with every prefill handed off."""
    from repro_torch.core import Priority, Request
    from repro_torch.core.engine import RealAgentXPUEngine
    if lane == "second_gpu" and torch.cuda.device_count() < 2:
        pytest.skip("needs a second GPU")
    pf = torch.device("cuda", 0 if lane == "stream" else 1)
    cuda = torch.device("cuda", 0)
    cfg, params = _tiny_llama(cuda)
    rng = np.random.default_rng(5)
    toks = [rng.integers(0, cfg.vocab_size, (1, n)) for n in (150, 90, 40)]
    out = {}
    for dual in (True, False):
        eng = RealAgentXPUEngine(
            cfg, params, max_len=256, device=cuda, decode_segment_steps=4,
            dual_device=dual, prefill_device=pf if dual else None)
        m = eng.serve([Request(id=i, priority=Priority.REACTIVE if i == 2
                               else Priority.PROACTIVE,
                               prompt_len=t.shape[1], max_new_tokens=12,
                               arrival_time=0.002 * i, tokens=t)
                       for i, t in enumerate(toks)])
        assert len(m.completed) == 3
        st = eng.stats()
        if dual:
            assert st["dual_device"] and st["staged_prefills"] >= 1
            assert st["staged_prefills"] + st["colocated_affinity"] == 3
            assert st["handoff_device_calls"] == st["staged_prefills"]
        assert eng.backend.validate() == []
        out[dual] = [eng.output_tokens(i) for i in range(3)]
    assert out[True] == out[False]


@pytest.mark.parametrize("arch", ["llama3-405b", "qwen2-moe-a2.7b",
                                  "deepseek-v2-lite-16b",
                                  "recurrentgemma-9b", "rwkv6-1.6b"])
def test_masked_decode_run_issues_no_host_sync(cuda, arch):
    """A fused, masked decode run over a pool view bounded in rows and
    ``kv_limit`` (the engine's elastic decode dispatch) issues no host sync
    in every served family: the MoE dispatch and combine, MLA's RoPE at
    width 8 (64 at full width) and its latent casts among them."""
    from repro_torch.models import decode_run, extend, init_cache, \
        slice_rows, write_rows_prefix
    cfg, params = _tiny_llama(cuda, arch)
    pool = init_cache(cfg, params, 4, 64, torch.float32)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (4, 12))).to(cuda)
    extend(cfg, params, pool, toks)
    active = torch.tensor([True, False, True, True], device=cuda)
    last = toks[:, -1].to(torch.int32)
    for check in (False, True):  # a warm-up run first
        sub = slice_rows(pool, 4)
        if check:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            block, last, sub = decode_run(cfg, params, sub, last, active, 3,
                                          kv_limit=32, full_alloc=64)
            write_rows_prefix(pool, sub, 4, 32, 64)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert block.shape == (3, 4)
    assert pool["pos"].tolist() == [18, 12, 18, 18]


# -- the encoder-decoder and vision forms --------------------------------------
# (Hq, Hkv, hd): whisper-tiny's 6/6 heads of 64 (G 1) and llava-next-34b's
# 56/8 heads of 128 (G 7: the pool kernel's 64-row blocks of packed
# (query, head-in-group) rows straddle queries, and the decode kernel's
# 16-row tiles hold 7 live rows)
FRONTEND_HEADS = [(6, 6, 64), (56, 8, 128)]


def _heads_id(h):
    return f"{h[0]}/{h[1]}hd{h[2]}"


@pytest.mark.parametrize("heads", FRONTEND_HEADS, ids=_heads_id)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_at_frontend_heads(cuda, heads, dtype):
    """Four rows over a 128-slot ring (whisper's serve) and one row over a
    4096-slot ring with 3016 live (llava's): the fewest and the most
    splits."""
    Hq, Hkv, hd = heads
    for B, S, live in ((4, 128, 96), (1, 4096, 3016)):
        args, kw = _decode_inputs(cuda, B, Hq, Hkv, hd, S, live=live,
                                  dtype=dtype, seed=Hq + B)
        got = ops.decode_attention(*args, **kw)
        again = ops.decode_attention(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        _assert_close(got, ref.decode_attention(*args, **kw), dtype)


@pytest.mark.parametrize("heads", FRONTEND_HEADS, ids=_heads_id)
@pytest.mark.parametrize("C,S,end", [(3, 700, 650), (64, 700, 650),
                                     (300, 700, 650), (3008, 4096, 3007)])
def test_pool_kernel_at_frontend_heads(cuda, heads, C, S, end):
    """Chunks of 3, 64 and 300 queries after earlier positions, and
    llava's fresh 3008-token chunk (2880 patches and 128 prompt tokens)
    over a 4096-slot ring."""
    Hq, Hkv, hd = heads
    args, kw = _pool_inputs(cuda, C, Hq // Hkv, Hkv, hd, S=S, end=end,
                            seed=C + hd)
    got = ops.flash_attention_pool(*args, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == args[0].shape
    _assert_close(got, ref.flash_attention_pool(*args, **kw), torch.bfloat16)


@pytest.mark.parametrize("heads", FRONTEND_HEADS, ids=_heads_id)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_at_frontend_heads(cuda, heads, dtype):
    """The training forward (output and lse) and backward at the two
    decoders' heads, S 300 causal."""
    Hq, Hkv, hd = heads
    q, k, v, d_out = _flash_case((1, Hq, Hkv, 300, 300, hd, None), dtype,
                                 cuda, seed=Hq)
    out, lse = ops.flash_attention(q, k, v, return_lse=True)
    want, want_lse = ref.flash_attention_lse(q, k, v)
    _assert_close(out, want, dtype)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
    args = (q, k, v, want, want_lse, d_out)
    grads = ops.flash_attention_bwd(*args)
    torch.cuda.synchronize()
    for got, w in zip(grads, ref.flash_attention_bwd(*args)):
        _assert_close(got, w, dtype)


@pytest.mark.parametrize("arch", [WHISPER, LLAVA])
def test_tiny_frontend_forms_through_kernels_match_plain(cuda, arch):
    """Tiny whisper (frames through the encoder, cross attention) and
    llava (patches prepended): ``prefill`` and a masked 6-step
    ``decode_run`` with ``kernel_backend="cuda"`` launch one pool kernel an
    attention layer and one decode kernel an attention layer and step
    (the encoder and the cross attention none), and give the plain path's
    logits (f32, 1e-4) and tokens."""
    from repro_torch.configs import get_tiny_config
    from repro_torch.models import decode_run, init_params, layout, prefill
    cfg = frontend_tiny(get_tiny_config, arch)
    params = init_params(cfg, seed=0, dtype=torch.float32, device=cuda)
    toks = torch.from_numpy(tokens(cfg, (3, 20))).to(cuda)
    fe = torch.from_numpy(frames(cfg, 3)).to(cuda)
    active = torch.tensor([True, False, True], device=cuda)
    n_attn = layout(cfg)[1].count("attn") * layout(cfg)[2]
    out = {}
    for backend in ("cuda", "plain"):
        before = dict(ops.LAUNCHES)
        lg, cache = prefill(cfg, params, toks, frontend_emb=fe, max_len=64,
                            dtype=torch.float32, kernel_backend=backend)
        block, _, cache = decode_run(cfg, params, cache,
                                     lg.argmax(-1).to(torch.int32), active,
                                     6, kv_limit=64, full_alloc=64,
                                     kernel_backend=backend)
        torch.cuda.synchronize()
        launched = {k: ops.LAUNCHES[k] - before[k] for k in before
                    if ops.LAUNCHES[k] != before[k]}
        assert launched == ({"flash_attention_pool": n_attn,
                             "decode_attention": 6 * n_attn}
                            if backend == "cuda" else {}), launched
        out[backend] = (lg, block, cache["pos"])
    torch.testing.assert_close(out["cuda"][0], out["plain"][0], rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(out["cuda"][1], out["plain"][1])
    assert torch.equal(out["cuda"][2], out["plain"][2])
