"""PyTorch port: the attention kernels' plain versions against the JAX
reference (``repro.kernels.ref`` / the XLA attention and the Pallas kernels
in interpret mode), and the CUDA kernels against their plain versions on a
card (marked ``cuda``; they skip without one).

Inputs are made with numpy from a seed and handed to both frameworks.
Tolerance: 2e-5 in f32 — the reference's own kernel-vs-oracle tolerance
(tests/test_kernels.py); only the summation order differs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import attention as JA
from repro.models import dequantize_kv as j_dequantize_kv
from repro.models import quantize_kv as j_quantize_kv
from repro_torch.kernels import ops
from repro_torch.models import attention as TA
from torch_attention_cases import (DECODE_CASES, POOL_CASES, decode_case,
                                   pool_call, pool_case, ring, to_torch)

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
