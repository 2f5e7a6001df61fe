"""PyTorch port on the card: the CUDA kernels (attention and the MoE
grouped expert GEMM) against their plain versions, and the tiny serving
paths (dense and MoE) through the kernels against the plain path.  Every test here is marked ``cuda`` and skips without an NVIDIA GPU;
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


def test_moe_gemm_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((2, 4, 8), device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.moe_gemm(x, torch.zeros((2, 8, 4), device=cuda).bfloat16())
    with pytest.raises(ValueError, match="shapes"):
        ops.moe_gemm(x, torch.zeros((2, 4, 8), device=cuda))
    with pytest.raises(ValueError, match="stride 1"):
        ops.moe_gemm(torch.zeros((2, 8, 4), device=cuda).transpose(1, 2),
                     torch.zeros((2, 8, 4), device=cuda))


# kernels each tiny serve must launch with kernel_backend="cuda"
SERVE_KERNELS = {
    "llama3.2-3b": {"decode_attention", "flash_attention_pool"},
    "qwen2-moe-a2.7b": {"decode_attention", "flash_attention_pool",
                        "moe_gemm"}}


@pytest.mark.parametrize("arch", sorted(SERVE_KERNELS))
def test_tiny_serve_through_kernels_matches_plain_path(cuda, arch):
    from repro_torch.configs import get_tiny_config
    from repro_torch.core import Priority, Request
    from repro_torch.core.engine import RealAgentXPUEngine
    from repro_torch.models import init_params
    cfg = get_tiny_config(arch)
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
