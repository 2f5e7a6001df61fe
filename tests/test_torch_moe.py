"""PyTorch port: the MoE FFN and its grouped expert GEMM against the JAX
reference on the same inputs.

Inputs are made with numpy from a seed (weights: the reference's
``_init_moe`` carried across with ``from_jax_params``) and handed to both
frameworks.  Tolerances, in f32: 1e-4 for the GEMM, the reference's own
kernel-vs-oracle tolerance (tests/test_kernels.py); 1e-5 for the MoE layer,
whose routing, dispatch and combine are the same arithmetic in both
frameworks and differ only in summation order.  The MoE family's training
forward, loss and gradients with dropped assignments are held to the
reference at the limits of tests/torch_train_cases.py, and the tiny
deepseek-v2-lite-16b (MLA, a dense head layer, 4 experts top-2 and a
shared one) served through the port's engine is held to the reference's
engine (tests/torch_engine_cases.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_engine_cases as tec
import torch_train_cases as ttc

from repro.configs import get_tiny_config as j_tiny
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.moe import moe_ffn as j_moe_ffn
from repro.models.transformer import _init_moe as j_init_moe
from repro_torch.configs import get_tiny_config as t_tiny
from repro_torch.kernels import ops, ref
from repro_torch.models import from_jax_params, module_from_state_dict
from repro_torch.models.layers import mlp
from repro_torch.models.moe import _router, moe_ffn

ARCH = "qwen2-moe-a2.7b"


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape, np.float32)
            * scale)


@pytest.mark.parametrize("E,C,d,f", [(2, 64, 128, 64), (4, 128, 256, 128)])
def test_moe_gemm_plain_matches_pallas(E, C, d, f):
    """At the shapes tests/test_kernels.py gives the Pallas kernel
    (interpret mode on the CPU)."""
    x, w = _rand(6, (E, C, d), 0.1), _rand(7, (E, d, f), 0.1)
    want = jops.moe_gemm(jnp.asarray(x), jnp.asarray(w), block_c=64,
                         block_f=64, block_d=64)
    got = ops.moe_gemm(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("E,C,d,f", [(60, 1, 40, 24), (5, 42, 72, 200),
                                     (3, 16, 136, 88)])
def test_moe_gemm_plain_matches_reference_at_ragged_shapes(E, C, d, f):
    """The serving path's ragged capacities (1, 16, 42) with d and f that
    divide no tile: against the reference's oracle (the Pallas kernel
    asserts divisibility).  A strided capacity slice of a spill buffer, as
    ``moe_ffn`` passes it, gives what a contiguous copy gives."""
    x, w = _rand(8, (E, C + 1, d), 0.1), _rand(9, (E, d, f), 0.1)
    want = jref.moe_gemm_ref(jnp.asarray(x[:, :C]), jnp.asarray(w))
    tx = torch.from_numpy(x)[:, :C]
    assert not tx.is_contiguous()
    got = ops.moe_gemm(tx, torch.from_numpy(w))
    assert got.shape == (E, C, f) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(got, ops.moe_gemm(tx.contiguous(),
                                         torch.from_numpy(w)))


def test_moe_gemm_plain_keeps_bf16():
    x = torch.from_numpy(_rand(10, (2, 3, 16))).bfloat16()
    w = torch.from_numpy(_rand(11, (2, 16, 8))).bfloat16()
    got = ref.moe_gemm(x, w)
    assert got.dtype == torch.bfloat16
    want = torch.einsum("ecd,edf->ecf", x.float(), w.float()).bfloat16()
    assert torch.equal(got, want)


def _moe_params(cfg, seed=0):
    jp = j_init_moe(cfg, jax.random.PRNGKey(seed), jnp.float32)
    tp = module_from_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, jp)))
    return jp, tp


def _dropped(tp, cfg, x, capacity):
    """Assignments past capacity, counted from the routing alone."""
    probs = torch.softmax(_router(x, tp["router"]), -1)
    top_e = torch.topk(probs, cfg.moe_top_k, -1).indices.reshape(-1)
    load = torch.bincount(top_e, minlength=cfg.num_experts)
    return int((load - capacity).clamp_min(0).sum())


# (T, capacity_override, input scale): a dropless decode batch, and prefill
# sizes whose capacity int(T * K / E * 1.25) drops assignments
CASES = {"decode_dropless": (8, 8, 0.5),
         "prefill_drops": (24, 0, 2.0),
         "prefill_drops_odd": (13, 0, 2.0)}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_moe_ffn_matches_jax(case, backend):
    cfg, tcfg = j_tiny(ARCH), t_tiny(ARCH)
    T, cap, scale = CASES[case]
    jp, tp = _moe_params(cfg)
    x = _rand(T, (T, cfg.d_model), scale)
    jy, jaux = j_moe_ffn(jnp.asarray(x), jp, cfg, capacity_override=cap)
    ty, taux = moe_ffn(torch.from_numpy(x), tp, tcfg, capacity_override=cap,
                       kernel_backend=backend)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5,
                               atol=1e-5)
    capacity = cap or max(1, int(T * cfg.moe_top_k / cfg.num_experts * 1.25))
    n_drop = _dropped(tp, tcfg, torch.from_numpy(x), capacity)
    assert (n_drop > 0) == (cap == 0), n_drop


def test_moe_ffn_plain_and_kernel_backends_agree_in_bf16():
    """On the CPU both backends run plain code, but along different
    routes: the einsum in bf16 and ``ref.moe_gemm`` with f32 accumulation
    rounded to bf16 once; they agree to bf16 rounding."""
    tcfg = t_tiny(ARCH)
    _, tp = _moe_params(j_tiny(ARCH))
    tp = module_from_state_dict({k: (v if "router" in k else v.bfloat16())
                                 for k, v in tp.state_dict().items()})
    x = torch.from_numpy(_rand(3, (16, tcfg.d_model), 0.5)).bfloat16()
    yk, auxk = moe_ffn(x, tp, tcfg, kernel_backend="cuda")
    yp, auxp = moe_ffn(x, tp, tcfg, kernel_backend="plain")
    assert yk.dtype == yp.dtype == torch.bfloat16
    assert torch.equal(auxk, auxp)
    torch.testing.assert_close(yk.float(), yp.float(), rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("T,k", [(4, 2), (17, 3), (32, 4)])
def test_moe_dropless_matches_dense_mixture(T, k):
    """Mirror of tests/test_property.py: dropless capacity MoE == every
    token routed through its top-k experts directly, plus the shared MLP."""
    tcfg = t_tiny(ARCH).with_overrides(moe_top_k=k)
    _, tp = _moe_params(j_tiny(ARCH))
    x = torch.from_numpy(_rand(T, (T, tcfg.d_model), 0.5))
    y, aux = moe_ffn(x, tp, tcfg, capacity_override=T)
    probs = torch.softmax(x @ tp["router"], -1)
    tp_, te = torch.topk(probs, k, -1)
    tp_ = tp_ / tp_.sum(-1, keepdim=True)
    ex = tp["experts"]
    want = torch.zeros_like(x)
    for t in range(T):
        for j in range(k):
            e = int(te[t, j])
            g = torch.nn.functional.silu(x[t] @ ex["wg"][e])
            want[t] += tp_[t, j] * ((g * (x[t] @ ex["w1"][e])) @ ex["w2"][e])
    want = want + mlp(x, tp["shared"], tcfg.mlp_gated)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    assert float(aux) >= 0.0


# -- training ------------------------------------------------------------------
# The MoE family's training forward, aux loss, loss and gradients with routed
# assignments dropped, against the reference's forward and
# jax.value_and_grad (limits: tests/torch_train_cases.py), the expert
# products on the plain path under either backend.  At the default capacity
# factor (1.25, tests/test_torch_models.py's training cases) the tiny
# model's 96 tokens drop nothing; at 0.5 the capacity is 24 of the 48
# assignments an expert averages, so assignments are dropped, and the
# gradients reach the router through the renormalised top-k weights and the
# aux loss only.
TRAIN_S = 48
DROP_CF = 0.5


@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_moe_train_forward_with_dropped_assignments_matches_jax(backend):
    from repro_torch import models as T
    jcfg, jp, tcfg = ttc.train_weights(ARCH)
    jl, jaux = ttc.jax_forward(ARCH, TRAIN_S, DROP_CF)
    toks = torch.from_numpy(ttc.tokens(jcfg, (2, TRAIN_S)))
    tl, taux = T.forward(tcfg, ttc.port(jp), toks, capacity_factor=DROP_CF,
                         kernel_backend=backend)
    ttc.assert_close(tl.detach(), jl, ttc.LOGITS_TOL)
    ttc.assert_rel(float(taux), jaux, ttc.AUX_REL, "aux")
    # at capacity T (factor E / K) nothing can drop; at DROP_CF the dropped
    # assignments change the output
    full, _ = T.forward(tcfg, ttc.port(jp), toks,
                        capacity_factor=tcfg.num_experts / tcfg.moe_top_k,
                        kernel_backend=backend)
    assert (full - tl).abs().max().item() > 1e-2


@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_moe_grads_with_dropped_assignments_match_jax(backend):
    jcfg, jp, tcfg = ttc.train_weights(ARCH)
    jloss, jnll, want = ttc.jax_loss_and_grads(ARCH, TRAIN_S, DROP_CF)
    loss, nll, grads = ttc.port_loss_and_grads(
        tcfg, ttc.port(jp), ttc.tokens(jcfg, (2, TRAIN_S + 1)), DROP_CF,
        kernel_backend=backend)
    ttc.assert_rel(loss, jloss, ttc.LOSS_REL, "loss")
    ttc.assert_rel(nll, jnll, ttc.LOSS_REL, "nll")
    ttc.assert_grads_match(grads, want)


# -- deepseek-v2-lite-16b through the engine -------------------------------------
# The tiny MLA model (its dense head layer and one MoE layer) served by the
# port's engine and the reference's on the same weights and trace: equal
# token streams, traces and stats(), the prefix cache off without a shared
# system prompt and on (hits copying the latent c / kr rings) with one.
@pytest.mark.parametrize("kw,shared", [({}, 0), ({"max_fused_steps": 1}, 0),
                                       ({}, tec.SYSTEM)],
                         ids=["fused", "per_step", "prefix"])
def test_deepseek_engine_matches_reference(kw, shared):
    tec.engine_matches_reference("deepseek-v2-lite-16b", kw, shared)
