"""PyTorch port: model math against the JAX reference on the same weights.

Weights are the reference's ``init_params`` carried across with
``from_jax_params``; tokens come from numpy.  Tolerances are the
reference's own (tests/test_consistency.py): 3e-3 for prefill logits and
1e-2 for decode, in f32.  Exactness that the reference asserts within one
framework (fused == per-step, elastic == full pool, untouched inactive rows)
is asserted bit for bit here too."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as J
from repro.configs import get_tiny_config as j_tiny
from repro_torch import models as T
from repro_torch.configs import get_tiny_config as t_tiny

ARCHS = ["llama3-405b", "llama3.2-3b", "qwen2-moe-a2.7b"]


def _weights(arch, dtype=jnp.float32):
    jcfg, tcfg = j_tiny(arch), t_tiny(arch)
    jp = J.init_params(jcfg, jax.random.PRNGKey(0), dtype)
    tp = T.module_from_state_dict(
        T.from_jax_params(jax.tree_util.tree_map(np.asarray, jp)))
    return jcfg, jp, tcfg, tp


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape,
                                                dtype=np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_from_jax_params_round_trips(dtype, arch):
    """Every leaf bit for bit, under the reference's tree paths; the MoE
    tree keeps its f32 router beside bf16 experts."""
    jcfg, jp, _, tp = _weights(arch, dtype)
    sd = tp.state_dict()
    flat = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(jp)}
    assert set(sd) == set(flat)
    assert "blocks.0.attn.wq" in sd and sd["blocks.0.attn.wq"].shape[0] == \
        jcfg.num_layers
    if jcfg.is_moe:
        assert sd["blocks.0.moe.router"].dtype == torch.float32
        assert sd["blocks.0.moe.experts.w1"].shape == (
            jcfg.num_layers, jcfg.num_experts, jcfg.d_model, jcfg.moe_d_ff)
        assert "blocks.0.moe.shared.wg" in sd
        assert torch.equal(tp["blocks"]["0"]["moe"]["router"],
                           sd["blocks.0.moe.router"])
    for name, a in flat.items():
        t = sd[name]
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16)), name
        else:
            assert np.array_equal(t.numpy(), a), name
    again = T.module_from_state_dict(sd).state_dict()
    assert all(torch.equal(again[k], sd[k]) for k in sd)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_prefill_chunked_and_decode_logits_match_jax(arch, backend):
    jcfg, jp, tcfg, tp = _weights(arch)
    toks = _tokens(jcfg, (2, 16))
    jl, jc = J.prefill(jcfg, jp, jnp.asarray(toks), max_len=48,
                       dtype=jnp.float32)
    tc = T.init_cache(tcfg, tp, 2, 48, torch.float32)
    t = torch.from_numpy(toks)
    T.extend(tcfg, tp, tc, t[:, :8], kernel_backend=backend)
    tl, tc = T.extend(tcfg, tp, tc, t[:, 8:], kernel_backend=backend)
    _close(tl, jl, 3e-3)
    nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
    jl2, _ = J.extend(jcfg, jp, jc, jnp.asarray(nxt))
    tl2, tc = T.extend(tcfg, tp, tc, torch.from_numpy(nxt),
                       kernel_backend=backend)
    _close(tl2, jl2, 1e-2)
    assert tc["pos"].tolist() == [17, 17]


def _j_pool(jcfg, jp, lens, toks, max_len, kv_dtype=None, logits=None):
    pool = J.init_cache(jcfg, jp, len(lens), max_len, jnp.float32,
                        kv_dtype=kv_dtype)
    for slot, n in enumerate(lens):
        if n:
            lg, pool = J.extend_row(jcfg, jp, pool,
                                    jnp.asarray(toks[slot:slot + 1, :n]),
                                    slot, kv_limit=32, full_alloc=max_len)
            if logits is not None:
                logits.append(np.asarray(lg))
    return pool


def _t_pool(tcfg, tp, lens, toks, max_len, kv_dtype=None, logits=None):
    pool = T.init_cache(tcfg, tp, len(lens), max_len, torch.float32,
                        kv_dtype=kv_dtype)
    for slot, n in enumerate(lens):
        if n:
            lg, _ = T.extend_row(tcfg, tp, pool,
                                 torch.from_numpy(toks[slot:slot + 1, :n]),
                                 slot, kv_limit=32, full_alloc=max_len)
            if logits is not None:
                logits.append(lg.numpy())
    return pool


def _leaf(pool, name):
    return np.asarray(pool["blocks"]["0"][name])


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_extend_row_writes_the_pool_row_like_jax(kv_dtype):
    jcfg, jp, tcfg, tp = _weights("llama3-405b")
    lens, max_len = [0, 13, 0], 64
    toks = _tokens(jcfg, (3, 16))
    jl, tl = [], []
    jpool = _j_pool(jcfg, jp, lens, toks, max_len, kv_dtype, logits=jl)
    tpool = _t_pool(tcfg, tp, lens, toks, max_len, kv_dtype, logits=tl)
    _close(tl[0], jl[0], 3e-3)
    assert tpool["pos"].tolist() == np.asarray(jpool["pos"]).tolist()
    assert np.array_equal(tpool["blocks"]["0"]["slot_pos"].numpy(),
                          _leaf(jpool, "slot_pos"))
    if kv_dtype == "int8":
        # the payload's quantisation can flip where the two frameworks'
        # f32 K/V differ in the last bits right at a rounding boundary
        for n in ("k", "v"):
            diff = np.abs(tpool["blocks"]["0"][n].numpy().astype(int)
                          - _leaf(jpool, n).astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-2
        _close(tpool["blocks"]["0"]["k_scale"].numpy(),
               _leaf(jpool, "k_scale"), 1e-5)
    else:
        _close(tpool["blocks"]["0"]["k"].numpy(), _leaf(jpool, "k"), 1e-4)
        _close(tpool["blocks"]["0"]["v"].numpy(), _leaf(jpool, "v"), 1e-4)


def _clone(pool):
    return {"pos": pool["pos"].clone(), "head": (), "tail": (),
            "blocks": {pi: {n: x.clone() for n, x in st.items()}
                       for pi, st in pool["blocks"].items()}}


def _pool_equal(a, b):
    return torch.equal(a["pos"], b["pos"]) and all(
        torch.equal(a["blocks"][pi][n], b["blocks"][pi][n])
        for pi in a["blocks"] for n in a["blocks"][pi])


def _row(pool, slot):
    return [pool["pos"][slot].clone()] + [
        x[:, slot].clone() for st in pool["blocks"].values()
        for x in st.values()]


@pytest.mark.parametrize("arch", ["llama3-405b", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_decode_run_matches_jax_and_is_exact_in_torch(backend, arch):
    """Masked decode vs the reference's decode_step (logits) and
    decode_run (tokens, final positions); in torch, fused == per-step and
    elastic == full pool bit for bit, and the bound-but-inactive row 2
    (mid-prefill) and the empty row 3 are untouched."""
    jcfg, jp, tcfg, tp = _weights(arch)
    lens, max_len, n = [11, 14, 9, 0], 64, 5
    toks = _tokens(jcfg, (4, 16))
    jpool = _j_pool(jcfg, jp, lens, toks, max_len)
    tpool = _t_pool(tcfg, tp, lens, toks, max_len)
    last = toks[:, 0].copy()
    active = np.asarray([True, True, False, False])
    kw = dict(kv_limit=32, full_alloc=max_len)
    ta, tl = torch.from_numpy(active), torch.from_numpy(last)
    # one masked step: logits of the active rows match the reference's
    _, jlg, _ = J.decode_step(jcfg, jp, jpool, jnp.asarray(last),
                              jnp.asarray(active), **kw)
    _, tlg, _ = T.decode_step(tcfg, tp, _clone(tpool), tl, ta,
                              kernel_backend=backend, **kw)
    _close(tlg[:2], np.asarray(jlg)[:2], 1e-2)
    jblock, _, jpool = J.decode_run(jcfg, jp, jpool, jnp.asarray(last),
                                    jnp.asarray(active), n, **kw)
    # full pool, fused
    full = _clone(tpool)
    before = _row(full, 2)
    block, _, _ = T.decode_run(tcfg, tp, full, tl, ta, n,
                               kernel_backend=backend, **kw)
    assert np.array_equal(block.numpy()[:, :2], np.asarray(jblock)[:, :2])
    assert full["pos"].tolist() == np.asarray(jpool["pos"]).tolist()
    assert all(torch.equal(x, y) for x, y in zip(_row(full, 2), before))
    # per-step on a copy of the same pool
    step = _clone(tpool)
    t = tl.clone()
    for i in range(n):
        nxt, _, _ = T.decode_step(tcfg, tp, step, t, ta,
                                  kernel_backend=backend, **kw)
        assert torch.equal(nxt[:2], block[i, :2])
        t = torch.where(ta, nxt, t)
    assert _pool_equal(step, full)
    # elastic: only the two leading rows, bounded to kv_limit
    elastic = _clone(tpool)
    sub = T.slice_rows(elastic, 2)
    eblock, _, sub = T.decode_run(tcfg, tp, sub, tl[:2], ta[:2], n,
                                  kernel_backend=backend, **kw)
    T.write_rows_prefix(elastic, sub, 2, 32, max_len)
    assert torch.equal(eblock, block[:, :2])
    assert _pool_equal(elastic, full)


def test_write_backs_copy_a_detached_view_and_skip_a_live_one():
    """The pool write-back helpers are free for the views the model writes
    through, and still land a view that was copied out of the pool."""
    jcfg, jp, tcfg, tp = _weights("llama3-405b")
    lens, max_len = [9, 0, 12], 32
    toks = _tokens(jcfg, (3, 16))
    want = _t_pool(tcfg, tp, lens, toks, max_len)
    # prefill row 1 through a detached copy of its truncated row view
    got = _t_pool(tcfg, tp, [9, 0, 12], toks, max_len)
    got["pos"][1] = 0
    want_row = _t_pool(tcfg, tp, [9, 7, 12], toks, max_len)
    view = T.truncate_rings(T.read_row(got, 1), 16, max_len)
    detached = _clone(view)
    T.extend(tcfg, tp, detached, torch.from_numpy(toks[1:2, :7]))
    assert _pool_equal(got, want)  # nothing landed yet
    T.write_row_slice(got, detached, 1, 0, 7)
    assert _pool_equal(got, want_row)
    # untruncate / write_rows_prefix of detached copies
    sub = _clone(T.truncate_rings(T.slice_rows(want_row, 2), 16, max_len))
    sub["pos"] += 1
    T.write_rows_prefix(want_row, sub, 2, 16, max_len)
    assert want_row["pos"].tolist() == [10, 8, 12]
    full = _clone(want_row)
    view = _clone(T.truncate_rings(full, 16, max_len))
    view["blocks"]["0"]["k"][:, 0, 3] += 1.0
    T.untruncate_rings(full, view, 16, max_len)
    assert torch.equal(full["blocks"]["0"]["k"][:, 0, 3],
                       want_row["blocks"]["0"]["k"][:, 0, 3] + 1.0)


def test_masked_decode_equals_select_rows():
    """Writing only the active rows in place gives the reference's
    write-all-then-``select_rows`` result."""
    jcfg, jp, tcfg, tp = _weights("llama3-405b")
    lens, max_len = [7, 12, 10], 32
    toks = _tokens(jcfg, (3, 16))
    pool = _t_pool(tcfg, tp, lens, toks, max_len)
    tl = torch.from_numpy(toks[:, 0].copy())
    active = torch.tensor([True, False, True])
    all_rows, masked = _clone(pool), _clone(pool)
    T.decode_step(tcfg, tp, all_rows, tl, torch.ones(3, dtype=torch.bool))
    T.decode_step(tcfg, tp, masked, tl, active)
    want = T.select_rows(active, all_rows, pool)
    assert _pool_equal(masked, want)


def test_int8_payload_bytes_equal_and_scales_within_one_ulp():
    x = np.random.default_rng(5).standard_normal((3, 40, 2, 32),
                                                 dtype=np.float32)
    x[0, 0] = 0.0  # all-zero row: the eps floor
    jq, js = J.quantize_kv(jnp.asarray(x))
    tq, ts = T.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(js), maxulp=1)
    deq = T.dequantize_kv(tq, ts)
    assert torch.all((deq - torch.from_numpy(x)).abs()
                     <= ts[..., None] / 2 + 1e-7)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "deepseek-v2-lite-16b",
                                  "whisper-tiny", "recurrentgemma-9b"])
def test_unported_families_raise_naming_roadmap(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.init_params(t_tiny(arch), seed=0, dtype=torch.float32,
                      device="cpu")


def test_moe_with_dense_head_layers_raises_naming_roadmap():
    cfg = t_tiny("qwen2-moe-a2.7b").with_overrides(first_k_dense_layers=1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
