"""PyTorch port: model math against the JAX reference on the same weights.

Weights are the reference's ``init_params`` carried across with
``from_jax_params``; tokens come from numpy.  Tolerances are the
reference's own (tests/test_consistency.py): 3e-3 for prefill logits and
1e-2 for decode, in f32.  Exactness that the reference asserts within one
framework (fused == per-step, elastic == full pool, untouched inactive rows)
is asserted bit for bit here too.  The recurrent families run with a tiny
recurrentgemma variant that has an unrolled tail, which the reference's
tiny config lacks (``torch_recurrent_cases.TAIL``)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as J
from repro.configs import get_tiny_config as j_tiny
from repro.models import ssm as jssm
from repro_torch import models as T
from repro_torch.configs import get_tiny_config as t_tiny
from repro_torch.kernels import ops
from repro_torch.models import ssm as tssm
import torch_frontend_cases as tfc
import torch_train_cases as ttc
from torch_recurrent_cases import (DENSE_HEAD, RECURRENT_ARCHS, RGLRU_CASES,
                                   TAIL, rglru_case, rwkv6_case, tiny)

MLA = "deepseek-v2-lite-16b"
ARCHS = ["llama3-405b", "llama3.2-3b", "qwen2-moe-a2.7b", MLA,
         DENSE_HEAD] + RECURRENT_ARCHS


def _weights(arch, dtype=jnp.float32):
    jcfg, tcfg = tiny(j_tiny, arch), tiny(t_tiny, arch)
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


# a stacked leaf of each arch's first block and a leaf of its tail
_FIRST = {"llama3.2-3b": ("blocks.0.attn.wq", None),
          "qwen2-moe-a2.7b": ("blocks.0.attn.wq", None),
          "rwkv6-1.6b": ("blocks.0.tm.wr", None),
          "recurrentgemma-9b": ("blocks.0.rg.w_x", None),
          TAIL: ("blocks.0.rg.w_x", "tail.1.rg.w_x"),
          MLA: ("blocks.0.attn.w_uk", None),
          "whisper-tiny": ("blocks.0.attn.xq", None),
          "llava-next-34b": ("blocks.0.attn.wq", None)}


@pytest.mark.parametrize("arch", sorted(_FIRST))
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_from_jax_params_round_trips(dtype, arch):
    """Every leaf bit for bit, under the reference's tree paths; the MoE
    tree keeps its f32 router beside bf16 experts, RG-LRU its f32 ``lam``
    and RWKV6 its f32 ``w0``; tail layers land under ``tail.<i>``, dense
    head layers (deepseek-v2's MLA and ``dense_d_ff`` FFN) under
    ``head.<i>``."""
    jcfg, jp, tcfg, tp = _weights(arch, dtype)
    sd = tp.state_dict()
    flat = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(jp)}
    assert set(sd) == set(flat)
    first, tail = _FIRST[arch]
    head_kinds, pattern, repeats, tail_kinds = T.layout(tcfg)
    assert first in sd and sd[first].shape[0] == repeats
    assert (tail is not None) == bool(tail_kinds)
    if tail is not None:
        assert sd[tail].shape == (jcfg.d_model, jcfg.lru_width)
        assert tp["tail"]["1"]["rg"]["lam"].dtype == torch.float32
    assert len(head_kinds) == jcfg.first_k_dense_layers
    if head_kinds:
        assert sd["head.0.ffn.w1"].shape == (jcfg.d_model, jcfg.dense_d_ff)
        assert not any(k.startswith("head.0.moe") for k in sd)
        assert sd["head.0.attn.w_uv"].shape == (
            jcfg.kv_lora_rank, jcfg.num_heads, jcfg.v_head_dim)
    if "rglru" in pattern:
        assert sd["blocks.0.rg.lam"].dtype == torch.float32
    if "rwkv6" in pattern:
        assert sd["blocks.0.tm.w0"].dtype == torch.float32
    if jcfg.is_moe:
        assert sd["blocks.0.moe.router"].dtype == torch.float32
        assert sd["blocks.0.moe.experts.w1"].shape == (
            repeats, jcfg.num_experts, jcfg.d_model, jcfg.moe_d_ff)
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


@pytest.mark.parametrize("arch", ["starcoder2-7b"] + RECURRENT_ARCHS)
@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_chunked_prefill_matches_single_shot(arch, backend):
    """Prefill in chunks of 8, 1, 3 and 4 tokens (conv buffer, token shifts
    and WKV / RG-LRU state crossing every boundary; the 1-token chunk takes
    the decode form) == one shot (tests/test_consistency.py's test, in
    torch), logits and every state leaf."""
    _, _, tcfg, tp = _weights(arch)
    toks = torch.from_numpy(_tokens(tcfg, (2, 16)))
    one = T.init_cache(tcfg, tp, 2, 48, torch.float32)
    want, _ = T.extend(tcfg, tp, one, toks, kernel_backend=backend)
    many = T.init_cache(tcfg, tp, 2, 48, torch.float32)
    for a, b in ((0, 8), (8, 9), (9, 12), (12, 16)):
        got, _ = T.extend(tcfg, tp, many, toks[:, a:b],
                          kernel_backend=backend)
    _close(got, want, 3e-3)
    for x, y in zip(_flat(many), _flat(one)):
        _close(x, y, 1e-4)


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


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tuple(_tree_map(fn, v) for v in tree)


def _flat(tree):
    out = []
    _tree_map(out.append, tree)
    return out


def _clone(pool):
    return _tree_map(torch.clone, pool)


def _pool_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(_flat(a), _flat(b)))


def _row(pool, slot):
    """Clones of every leaf's row ``slot`` (batch axis 1 in ``blocks``)."""
    return ([pool["pos"][slot].clone()]
            + [x[slot].clone() for sec in ("head", "tail")
               for x in _flat(pool[sec])]
            + [x[:, slot].clone() for x in _flat(pool["blocks"])])


@pytest.mark.parametrize("arch", ["llama3-405b", "qwen2-moe-a2.7b", MLA]
                         + RECURRENT_ARCHS)
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


@pytest.mark.parametrize("arch", ["llama3-405b"] + RECURRENT_ARCHS)
def test_masked_decode_equals_select_rows(arch):
    """Writing only the active rows in place (K/V, slot positions and the
    recurrent states) gives the reference's write-all-then-``select_rows``
    result."""
    jcfg, jp, tcfg, tp = _weights(arch)
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


def _named_rows(pool, slot):
    """(leaf name, row ``slot`` of the leaf) over every layer state."""
    for sec in ("head", "tail"):
        for st in pool[sec]:
            yield from ((n, x[slot]) for n, x in st.items())
    for st in pool["blocks"].values():
        yield from ((n, x[:, slot]) for n, x in st.items())


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_reset_row_zeroes_recurrent_state(arch):
    """``reset_row`` zeroes the rebound row's recurrent states (h, conv,
    wkv, the shifts) and ``pos``, empties its slot positions, leaves its
    K/V payload stale, and touches no other row."""
    jcfg, _, tcfg, tp = _weights(arch)
    toks = _tokens(jcfg, (2, 16))
    pool = _t_pool(tcfg, tp, [9, 12], toks, 32)
    before = _clone(pool)
    T.reset_row(pool, 1)
    assert pool["pos"].tolist() == [9, 0]
    names = set()
    for (n, x), (_, old) in zip(_named_rows(pool, 1), _named_rows(before, 1)):
        names.add(n)
        if n in ("k", "v"):
            assert torch.equal(x, old)
        elif n == "slot_pos":
            assert (x == -1).all()
        else:
            assert old.abs().sum() > 0 and (x == 0).all(), n
    assert names >= ({"wkv", "shift_tm", "shift_cm"} if "rwkv6" in arch
                     else {"h", "conv", "k", "v", "slot_pos"})
    assert all(torch.equal(x, y) for (_, x), (_, y)
               in zip(_named_rows(pool, 0), _named_rows(before, 0)))


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


# -- shared-prefix KV copies (DESIGN.md §10) ----------------------------------
# A random pool (every leaf drawn with numpy, rows at assorted positions)
# built on both sides, then the prefix helpers applied to it; the results
# must be equal bit for bit.
PREFIX_MAX_LEN = 64


def _states(pool):
    """(section, key, batch axis, state) of every layer state: the unrolled
    head layers (batch axis 0), then the stacked blocks (batch axis 1)."""
    for i, st in enumerate(pool["head"]):
        yield "head", i, 0, st
    for pi, st in pool["blocks"].items():
        yield "blocks", pi, 1, st


def _random_pool_leaves(jcfg, jp, kv_dtype, rng):
    """{(section, key, name): numpy leaf} of a random 3-row pool, and its
    per-row positions."""
    shape = J.init_cache(jcfg, jp, 3, PREFIX_MAX_LEN, jnp.float32,
                         kv_dtype=kv_dtype)
    pos = np.array([40, 23, 9], np.int32)
    leaves = {("pos", None, None): pos}
    for sec, pi, axis, st in _states(shape):
        for name, x in st.items():
            if name == "slot_pos":
                ring = np.arange(x.shape[-1], dtype=np.int32)
                v = np.where(ring < pos.reshape((1,) * axis + (-1, 1)),
                             ring, -1)
                v = np.broadcast_to(v, x.shape).astype(np.int32)
            elif x.dtype == jnp.int8:
                v = rng.integers(-127, 128, x.shape, dtype=np.int8)
            elif name in ("k_scale", "v_scale"):
                v = rng.uniform(0.01, 1.0, x.shape).astype(np.float32)
            else:
                v = rng.standard_normal(x.shape, dtype=np.float32)
            leaves[(sec, pi, name)] = v
    return leaves


def _pools_from(leaves, dtype):
    """The same pool as the reference's (jax) and the port's (torch)."""
    jpool = {"pos": None, "head": {}, "tail": (), "blocks": {}}
    tpool = {"pos": None, "head": {}, "tail": (), "blocks": {}}
    tdt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype]
    for (sec, pi, name), v in leaves.items():
        jv, tv = jnp.asarray(v), torch.from_numpy(np.array(v))
        if v.dtype == np.float32 and name in ("k", "v", "c", "kr"):
            jv, tv = jv.astype(dtype), tv.to(tdt)
        if sec == "pos":
            jpool["pos"], tpool["pos"] = jv, tv
        else:
            jpool[sec].setdefault(pi, {})[name] = jv
            tpool[sec].setdefault(pi, {})[name] = tv
    for pool in (jpool, tpool):
        pool["head"] = tuple(pool["head"][i] for i in sorted(pool["head"]))
    return jpool, tpool


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def _assert_pool_bitwise(tpool, jpool):
    assert np.array_equal(tpool["pos"].numpy(), np.asarray(jpool["pos"]))
    assert len(tpool["head"]) == len(jpool["head"])
    for sec, pi, _, st in _states(jpool):
        assert set(tpool[sec][pi]) == set(st)
        for name, jv in st.items():
            tv = tpool[sec][pi][name]
            assert np.array_equal(_as_np(tv), _as_np(jv)), (sec, name)


@pytest.mark.parametrize("arch,dtype,kv_dtype", [
    ("llama3-405b", jnp.bfloat16, None), ("llama3-405b", jnp.bfloat16, "int8"),
    (MLA, jnp.bfloat16, None)], ids=["bf16", "int8", "mla"])
@pytest.mark.parametrize("hit,hit_cap", [(16, 16), (11, 16), (5, 32)],
                         ids=["pow2", "not_pow2", "cap_beyond"])
def test_prefix_copy_snapshot_paste_match_jax(hit, hit_cap, arch, dtype,
                                              kv_dtype):
    """``copy_prefix_rows``, then ``snapshot_prefix`` + ``paste_prefix``
    (after the donor row was overwritten) against the reference's on the
    same random pool: payload (MLA: the latent ``c`` and ``kr``, in the
    dense head layer and the blocks), scales, ``slot_pos`` and ``pos`` bit
    for bit, the donor row unchanged by the copy, the snapshot unchanged by
    the overwrite of its donor row."""
    jcfg, jp, _, _ = _cached_weights(arch)
    rng = np.random.default_rng(hit * 100 + hit_cap)
    leaves = _random_pool_leaves(jcfg, jp, kv_dtype, rng)
    jpool, tpool = _pools_from(leaves, dtype)
    full, src, dst = PREFIX_MAX_LEN, 0, 2
    donor = _row(tpool, src)
    jpool = J.copy_prefix_rows(jpool, jnp.int32(src), jnp.int32(dst),
                               jnp.int32(hit), hit_cap, full)
    assert T.copy_prefix_rows(tpool, src, dst, hit, hit_cap, full) is tpool
    _assert_pool_bitwise(tpool, jpool)
    assert all(torch.equal(x, y) for x, y in zip(_row(tpool, src), donor))
    assert tpool["pos"][dst] == hit
    assert (tpool["blocks"]["0"]["slot_pos"][:, dst, hit:] == -1).all()
    # snapshot the donor, overwrite its row, paste into row 1
    depth_cap = 32
    jentry = J.snapshot_prefix(jpool, jnp.int32(src), depth_cap, full)
    tentry = T.snapshot_prefix(tpool, src, depth_cap, full)
    kept = _clone(tentry)
    other = _random_pool_leaves(jcfg, jp, kv_dtype,
                                np.random.default_rng(hit + 1))
    jother, tother = _pools_from(other, dtype)
    jpool = J.copy_into_prefix(jpool, J.slice_rows(jother, 1), 1)
    tpool["pos"][:1] = tother["pos"][:1]
    for sec, pi, axis, st in _states(tother):
        for name, x in st.items():
            tpool[sec][pi][name].narrow(axis, 0, 1).copy_(
                x.narrow(axis, 0, 1))
    _assert_pool_bitwise(tpool, jpool)
    assert _pool_equal(tentry, kept)
    jpool = J.paste_prefix(jpool, jentry, jnp.int32(1), jnp.int32(hit),
                           min(hit_cap, depth_cap), depth_cap, full)
    T.paste_prefix(tpool, tentry, 1, hit, min(hit_cap, depth_cap),
                   depth_cap, full)
    _assert_pool_bitwise(tpool, jpool)
    assert _pool_equal(tentry, kept)  # the entry is read, never written
    assert tpool["pos"].tolist() == np.asarray(jpool["pos"]).tolist()


@pytest.mark.parametrize("arch", [tfc.WHISPER, tfc.LLAVA])
@pytest.mark.parametrize("backend_cls", ["TorchRealBackend",
                                         "DualDeviceBackend"])
def test_real_backends_refuse_frontend_forms(backend_cls, arch):
    """The model API takes both forms; the serving backends refuse them
    with the reference's messages, in its order (the encoder-decoder check
    first: whisper has a frontend too)."""
    from repro.core.backend import JaxRealBackend
    from repro_torch.core import backend as tb
    cfg = t_tiny(arch)
    T.check_supported(cfg)
    T.check_trainable(cfg)
    params = T.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    assert tb.TorchRealBackend._ENC_DEC_MSG.replace(
        "TorchRealBackend", "JaxRealBackend") == JaxRealBackend._ENC_DEC_MSG
    msg = "cannot serve encoder-decoder configs" if cfg.is_encoder_decoder \
        else "serves text-only decoders"
    with pytest.raises(NotImplementedError, match=msg):
        getattr(tb, backend_cls)(cfg, params, pool_slots=2, max_len=32,
                                 device="cpu")


# -- MLA (DeepSeek-V2) ---------------------------------------------------------
# The three MLA functions against repro.models.attention on the same numpy
# inputs (f32, 1e-5: the same f32 arithmetic in another summation order),
# with the tiny deepseek config's widths (4 heads, rank 32, dn 16, dr 8, dv
# 16): the expansion, the expanded prefill over a ring with empty and
# future slots (V padded from 16 to 24 and sliced back), and the absorbed
# decode over a ring with empty slots, with and without a window.
def _mla_inputs(seed):
    from repro.configs import get_tiny_config
    cfg = get_tiny_config(MLA)
    H, r = cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    rng = np.random.default_rng(seed)

    def randn(*shape, scale=1.0):
        return (rng.standard_normal(shape, dtype=np.float32) * scale)
    B, C, S = 2, 5, 24
    p = {"w_uk": randn(r, H, dn, scale=0.2), "w_uv": randn(r, H, dv,
                                                           scale=0.2)}
    slot_pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    slot_pos[0, 17:] = -1  # row 0: positions 0..16 written, the rest empty
    slot_pos[1, 3] = -1
    pos_q = np.stack([np.arange(12, 12 + C), np.arange(19, 19 + C)]
                     ).astype(np.int32)
    return dict(q_nope=randn(B, C, H, dn), q_rope=randn(B, C, H, dr),
                c=randn(B, S, r), kr=randn(B, S, dr), p=p, pos_q=pos_q,
                slot_pos=slot_pos)


@pytest.mark.parametrize("fn,window", [("expand", None), ("prefill", None),
                                       ("prefill", 6), ("decode", None),
                                       ("decode", 6)])
def test_mla_functions_match_jax(fn, window):
    from repro.models import attention as JA
    from repro_torch.models import attention as TA
    a = _mla_inputs(seed=11)
    j = {k: ({n: jnp.asarray(x) for n, x in v.items()} if k == "p"
             else jnp.asarray(v)) for k, v in a.items()}
    t = {k: ({n: torch.from_numpy(x) for n, x in v.items()} if k == "p"
             else torch.from_numpy(v)) for k, v in a.items()}
    if fn == "expand":
        for got, want in zip(TA.mla_expand_kv(t["c"], t["p"]),
                             JA.mla_expand_kv(j["c"], j["p"])):
            _close(got, want, 1e-5)
        return
    if fn == "prefill":
        got = TA.mla_prefill_attention(
            t["q_nope"], t["q_rope"], t["c"], t["kr"][:, :, None], t["p"],
            pos_q=t["pos_q"], pos_kv=t["slot_pos"], window=window,
            q_chunk=4, kv_chunk=8)
        want = JA.mla_prefill_attention(
            j["q_nope"], j["q_rope"], j["c"], j["kr"][:, :, None], j["p"],
            pos_q=j["pos_q"], pos_kv=j["slot_pos"], window=window,
            q_chunk=4, kv_chunk=8)
        assert got.shape[-1] == a["p"]["w_uv"].shape[-1]
    else:
        got = TA.mla_decode_attention(
            t["q_nope"][:, 0], t["q_rope"][:, 0], t["c"], t["kr"], t["p"],
            t["slot_pos"], t["pos_q"][:, 0], window=window)
        want = JA.mla_decode_attention(
            j["q_nope"][:, 0], j["q_rope"][:, 0], j["c"], j["kr"], j["p"],
            j["slot_pos"], j["pos_q"][:, 0], window=window)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_mla_int8_pool_raises_as_in_jax(backend):
    """An MLA cache has no per-head scale axis: an int8 pool raises in the
    cache, the real backend and the reference's, under either backend."""
    from repro.core.backend import JaxRealBackend
    from repro_torch.core.backend import TorchRealBackend
    jcfg, jp, tcfg, tp = _cached_weights(MLA)
    assert not T.kv_supports_int8(tcfg) and not J.kv_supports_int8(jcfg)
    assert T.kv_supports_int8(t_tiny("llama3-405b"))
    with pytest.raises(NotImplementedError, match="kv_supports_int8"):
        T.init_cache(tcfg, tp, 2, 32, torch.float32, kv_dtype="int8")
    with pytest.raises(NotImplementedError, match="MLA"):
        JaxRealBackend(jcfg, jp, pool_slots=2, max_len=32,
                       dtype=jnp.float32, kv_dtype="int8")
    with pytest.raises(NotImplementedError, match="MLA"):
        TorchRealBackend(tcfg, tp, pool_slots=2, max_len=32, device="cpu",
                         kv_dtype="int8", kernel_backend=backend)
    # the bf16 pool is served under either backend
    be = TorchRealBackend(tcfg, tp, pool_slots=2, max_len=32, device="cpu",
                          kernel_backend=backend)
    assert be.validate() == []


# -- the recurrent mixers -----------------------------------------------------
# The model-path scans (log-depth RG-LRU scan, chunked WKV6) against
# repro.models.ssm, and the RG-LRU and RWKV6 blocks, prefill and decode,
# against the reference's blocks at tiny widths in f32, with masked state
# writes.  Tolerance 1e-5 for the RG-LRU scans (the same f32 recurrence),
# 1e-4 for the WKV6 forms and the blocks (f32 matmuls of either framework
# feed the recurrence).
def _t(*xs):
    return [torch.from_numpy(np.array(x, copy=True)) for x in xs]


@pytest.mark.parametrize("B,S,W", RGLRU_CASES)
def test_rglru_model_scan_matches_associative_scan(B, S, W):
    """The log-depth scan of the plain model path and its folded initial
    state, against ``jax.lax.associative_scan`` in the reference."""
    x, a, g, h0 = rglru_case(B, S, W, seed=1)
    jh, ja = jssm.rglru_scan(jnp.asarray(x), jnp.asarray(a), jnp.asarray(g))
    th, ta = tssm.rglru_scan(*_t(x, a, g))
    _close(th, jh, 1e-5)
    _close(ta, ja, 1e-5)
    # with h0 folded in, the sequential recurrence
    want, _ = ops.rglru_scan(*_t(x, a, g, h0))
    _close(th + ta * torch.from_numpy(h0)[:, None], want, 1e-5)


@pytest.mark.parametrize("S", [1, 32, 45])
def test_rwkv6_model_scans_match_reference(S):
    """The plain model path (chunked pairwise form, ragged last chunk;
    single step at S == 1) from a nonzero state, against the reference's
    ``rwkv6_scan_chunked`` / ``rwkv6_step``, on (B, H, S, D) head splits;
    and the scan plain version on the same 4-D layout with a per-head u."""
    B, H, D = 2, 3, 32
    r, k, v, w, _, s0 = rwkv6_case(B * H, S, D, seed=2)
    r, k, v, w = (t.reshape(B, H, S, D) for t in (r, k, v, w))
    s0 = s0.reshape(B, H, D, D)
    u = np.random.default_rng(3).standard_normal((H, D), dtype=np.float32)
    jx = [jnp.asarray(t) for t in (r, k, v, w, u, s0)]
    tx = _t(r, k, v, w, u, s0)
    if S == 1:
        jo, js = jssm.rwkv6_step(*[t[:, :, 0] for t in jx[:4]], jx[4], jx[5])
        to, ts = tssm.rwkv6_step(*[t[:, :, 0] for t in tx[:4]], tx[4], tx[5])
        to = to[:, :, None]
        jo = jo[:, :, None]
    else:
        jo, js = jssm.rwkv6_scan_chunked(*jx, chunk=32)
        to, ts = tssm.rwkv6_scan_chunked(*tx, chunk=32)
    _close(to, jo, 1e-4)
    _close(ts, js, 1e-4)
    ko, ks = ops.rwkv6_scan(*tx[:4], tx[4][:, None], tx[5])
    _close(ko, to, 1e-4)
    _close(ks, ts, 1e-4)


def _layer(arch, name):
    """Tiny ``arch``'s first block (repeat 0) as JAX and port parameter
    trees, f32."""
    cfg = j_tiny(arch)
    jp = J.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    jl = jax.tree_util.tree_map(lambda x: x[0], jp["blocks"]["0"][name])
    tl = T.module_from_state_dict(T.from_jax_params(
        jax.tree_util.tree_map(np.asarray, jl)))
    return cfg, jl, tl


def _state(cfg, kind, B, seed):
    """A nonzero layer state in both frameworks (numpy from a seed)."""
    rng = np.random.default_rng(seed)
    if kind == "rglru":
        shapes = {"h": (B, cfg.lru_width),
                  "conv": (B, cfg.conv1d_width - 1, cfg.lru_width)}
    else:
        H, D = cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim
        shapes = {"wkv": (B, H, D, D), "shift_tm": (B, cfg.d_model),
                  "shift_cm": (B, cfg.d_model)}
    st = {n: rng.standard_normal(s, dtype=np.float32) * 0.3
          for n, s in shapes.items()}
    return st, {n: torch.from_numpy(x.copy()) for n, x in st.items()}


@pytest.mark.parametrize("S", [1, 2, 19])
@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_rglru_block_matches_reference(S, backend):
    """Prefill chunks (S > 1, the conv buffer crossing the call boundary)
    and a decode step (S == 1), from a nonzero state; only the active rows'
    state moves."""
    cfg, jl, tl = _layer("recurrentgemma-9b", "rg")
    B = 3
    x = np.random.default_rng(4).standard_normal(
        (B, S, cfg.d_model), dtype=np.float32)
    jst, tst = _state(cfg, "rglru", B, seed=5)
    mode = "decode" if S == 1 else "prefill"
    jx = jnp.asarray(x[:, 0] if S == 1 else x)
    jy, (jh, jc) = jssm.rglru_block(jx, jl, cfg, mode=mode,
                                    state=(jnp.asarray(jst["h"]),
                                           jnp.asarray(jst["conv"])))
    old = {n: t.clone() for n, t in tst.items()}
    active = torch.tensor([True, False, True])
    ctx = {"kernel_backend": backend, "active": active}
    ty = tssm.rglru_block(torch.from_numpy(x), tl, cfg, tst, ctx)
    _close(ty[:, 0] if S == 1 else ty, jy, 1e-4)
    for n, want in (("h", jh), ("conv", jc)):
        _close(tst[n][active], np.asarray(want)[active.numpy()], 1e-4)
        assert torch.equal(tst[n][~active], old[n][~active])


@pytest.mark.parametrize("S", [1, 2, 45])
@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_rwkv6_block_matches_reference(S, backend):
    """Time mix and channel mix, prefill (ragged last WKV chunk) and
    decode, from a nonzero state; only the active rows' state moves."""
    cfg, jl, tl = _layer("rwkv6-1.6b", "tm")
    B = 3
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    x2 = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    jst, tst = _state(cfg, "rwkv6", B, seed=7)
    mode = "decode" if S == 1 else "prefill"
    jx = jnp.asarray(x[:, 0] if S == 1 else x)
    jy, (j_shift, j_wkv) = jssm.rwkv6_block(
        jx, jl, cfg, mode=mode, shift_state=jnp.asarray(jst["shift_tm"]),
        wkv_state=jnp.asarray(jst["wkv"]))
    from repro.models.transformer import _rwkv6_channel_mix
    jy2, j_cm = _rwkv6_channel_mix(jnp.asarray(x2), jl["cm"],
                                   jnp.asarray(jst["shift_cm"]))
    old = {n: t.clone() for n, t in tst.items()}
    active = torch.tensor([False, True, True])
    ctx = {"kernel_backend": backend, "active": active, "ssm_chunk": 32}
    ty = tssm.rwkv6_block(torch.from_numpy(x), tl, cfg, tst, ctx)
    ty2 = tssm.rwkv6_channel_mix(torch.from_numpy(x2), tl["cm"], tst, ctx)
    _close(ty[:, 0] if S == 1 else ty, jy, 1e-4)
    _close(ty2, jy2, 1e-4)
    for n, want in (("wkv", j_wkv), ("shift_tm", j_shift),
                    ("shift_cm", j_cm)):
        _close(tst[n][active], np.asarray(want)[active.numpy()], 1e-4)
        assert torch.equal(tst[n][~active], old[n][~active])


# -- the training forward -----------------------------------------------------
# Every trained family's training forward, loss and gradients against the
# reference's forward and jax.value_and_grad of its lm_loss, on the same
# weights (f32), for both kernel backends ("cuda" on CPU tensors runs the
# autograd Function over the flash plain versions; the expert products and
# the scans run on the plain path under either).  The qkv biases, zero at
# init, are drawn at random so they count.  48 tokens: past the tiny
# windows (starcoder2's and recurrentgemma's 32) and one ragged 32-token
# WKV chunk; the recurrent families from zero state.  Limits
# (tests/torch_train_cases.py): logits 3e-3 (the consistency tolerance);
# the aux loss, the loss to 1e-5 relative and every gradient leaf to 1e-4
# relative L2 (f32 summation order only; measured ~1e-7 and ~5e-6).  The
# MoE family's capacity-drop cases are in tests/test_torch_moe.py.
TRAIN_ARCHS = ["llama3-405b", "starcoder2-7b", "qwen2.5-32b",
               "qwen2-moe-a2.7b", MLA, DENSE_HEAD] + RECURRENT_ARCHS
TRAIN_S = 48


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_train_forward_logits_match_jax(arch, backend):
    jcfg, jp, tcfg = ttc.train_weights(arch)
    jl, jaux = ttc.jax_forward(arch, TRAIN_S)
    toks = ttc.tokens(jcfg, (2, TRAIN_S))
    tl, taux = T.forward(tcfg, ttc.port(jp), torch.from_numpy(toks),
                         kernel_backend=backend)
    assert tl.shape == (2, TRAIN_S, jcfg.vocab_size)
    ttc.assert_close(tl.detach(), jl, ttc.LOGITS_TOL)
    ttc.assert_rel(float(taux), jaux, ttc.AUX_REL, "aux")
    assert (jaux > 0) == jcfg.is_moe  # 0.0 exactly without a router


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_lm_loss_and_grads_match_jax(arch, backend):
    from repro_torch.train.train_loop import loss_and_grads
    jcfg, jp, tcfg = ttc.train_weights(arch)
    jloss, jnll, want = ttc.jax_loss_and_grads(arch, TRAIN_S)
    toks = ttc.tokens(jcfg, (2, TRAIN_S + 1))
    loss, met, grads = loss_and_grads(tcfg, ttc.port(jp),
                                      torch.from_numpy(toks),
                                      kernel_backend=backend)
    ttc.assert_rel(float(loss), jloss, ttc.LOSS_REL, "loss")
    ttc.assert_rel(float(met["nll"]), jnll, ttc.LOSS_REL, "nll")
    ttc.assert_grads_match(grads, want)


@pytest.mark.parametrize("arch", ["starcoder2-7b", "qwen2.5-32b",
                                  "qwen2-moe-a2.7b", TAIL])
@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_remat_leaves_gradients_unchanged(arch, backend):
    """Checkpointing each layer recomputes its forward in the backward: on
    the CPU the recompute is bit-identical (the MoE routes the same tokens
    to the same slots; recurrentgemma's mixed pattern and tail), so the
    gradients are too."""
    from repro_torch.train.train_loop import loss_and_grads
    jcfg, jp, tcfg = ttc.train_weights(arch)
    toks = torch.from_numpy(ttc.tokens(jcfg, (2, 41)))
    runs = [loss_and_grads(tcfg, ttc.port(jp), toks, remat=remat,
                           kernel_backend=backend) for remat in (True, False)]
    assert torch.equal(runs[0][0], runs[1][0])
    for name, g in runs[0][2].items():
        assert torch.equal(g, runs[1][2][name]), name


# -- the encoder-decoder and vision-prefix forms --------------------------------
# whisper-tiny (an encoder over the frames, cross attention in every
# decoder layer) and llava-next-34b (patches prepended to the prompt),
# tiny, and variants with frontend_dim != d_model (frontend_proj: llava's
# for the prepend, whisper's for the encoder), against the reference on the same weights and frames
# (tests/torch_frontend_cases.py): logits at the consistency tolerances
# (3e-3 forward, prefill and a C > 1 extend, 1e-2 a decode step), greedy
# streams equal, the encoder, the cross K/V and full_attention to 1e-5
# (f32, summation order only), the loss, aux and every gradient leaf to
# tests/torch_train_cases.py's limits.
@pytest.mark.parametrize("arch", tfc.PARITY_ARCHS)
@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_frontend_forms_match_jax(arch, backend):
    jcfg, jp, tcfg = tfc.weights(arch)
    want = tfc.jax_serve(arch)
    tp = tfc.port(jp)
    toks = torch.from_numpy(tfc.tokens(jcfg, (2, tfc.PROMPT)))
    fe = torch.from_numpy(tfc.frames(jcfg, 2))
    logits, _ = T.forward(tcfg, tp, toks, fe, kernel_backend=backend)
    extra = 0 if jcfg.is_encoder_decoder else jcfg.frontend_tokens
    assert logits.shape == (2, tfc.PROMPT + extra, jcfg.vocab_size)
    _close(logits, want["forward"], 3e-3)
    lg, cache = T.prefill(tcfg, tp, toks, frontend_emb=fe,
                          max_len=tfc.MAX_LEN, dtype=torch.float32,
                          kernel_backend=backend)
    _close(lg, want["prefill"], 3e-3)
    for name, tol in (("chunk", 3e-3), ("step", 1e-2)):
        lg, cache = T.extend(tcfg, tp, cache, torch.from_numpy(want[name]),
                             kernel_backend=backend)
        _close(lg, want["extend" if name == "chunk" else "decode"], tol)
    block, _, cache = T.decode_run(tcfg, tp, cache,
                                   torch.from_numpy(want["last"]),
                                   torch.ones(2, dtype=torch.bool), 8,
                                   kernel_backend=backend)
    assert np.array_equal(block.numpy(), want["stream"])
    assert cache["pos"].tolist() == want["pos"].tolist()


@pytest.mark.parametrize("case", ["non-causal", "valid_kv",
                                  "causal window"])
def test_full_attention_matches_jax(case):
    """Non-causal GQA (G 2) over a key sequence longer than the queries,
    with a (B, Skv) ``valid_kv`` mask, and causal with a window at the
    queries' positions."""
    from repro.models.attention import full_attention as jfull
    from repro_torch.models.attention import full_attention as tfull
    rng = np.random.default_rng(5)
    B, Sq, Skv, Hq, Hkv, hd = 2, 5, 11, 4, 2, 16
    q, k, v = (rng.standard_normal(shape, dtype=np.float32)
               for shape in ((B, Sq, Hq, hd), (B, Skv, Hkv, hd),
                             (B, Skv, Hkv, hd)))
    kw = {}
    if case == "valid_kv":
        valid = rng.random((B, Skv)) > 0.4
        valid[:, 0] = True
        kw = dict(valid_kv=valid)
    elif case == "causal window":
        kw = dict(causal=True, window=4,
                  pos_q=np.arange(Skv - Sq, Skv, dtype=np.int32),
                  pos_kv=np.arange(Skv, dtype=np.int32))
    want = jfull(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 **{n: x if np.isscalar(x) else jnp.asarray(x)
                    for n, x in kw.items()})
    got = tfull(torch.from_numpy(q), torch.from_numpy(k),
                torch.from_numpy(v),
                **{n: x if np.isscalar(x) else torch.from_numpy(x)
                   for n, x in kw.items()})
    assert got.shape == (B, Sq, Hq, hd)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("arch", [tfc.WHISPER, tfc.WHISPER + tfc.PROJ])
def test_encoder_and_cross_kv_match_jax(arch):
    """``encode`` (through ``frontend_proj`` in the variant) and
    ``init_cache``'s ``enc_out`` and per-layer cross K/V; every cache leaf
    of the reference's shape; no frames, no encoder: the reference
    asserts, the port raises."""
    from repro.models import transformer as JT
    jcfg, jp, tcfg = tfc.weights(arch)
    tp = tfc.port(jp)
    fe = tfc.frames(jcfg, 2)
    _close(T.encode(tcfg, tp, torch.from_numpy(fe)),
           JT.encode(jcfg, jp, jnp.asarray(fe)), 1e-5)
    jc = J.init_cache(jcfg, jp, 2, 32, jnp.float32,
                      frontend_emb=jnp.asarray(fe))
    tc = T.init_cache(tcfg, tp, 2, 32, torch.float32,
                      frontend_emb=torch.from_numpy(fe))
    _close(tc["enc_out"], jc["enc_out"], 1e-5)
    for n in ("xk", "xv"):
        assert tc["blocks"]["0"][n].dtype == torch.float32
        _close(tc["blocks"]["0"][n], jc["blocks"]["0"][n], 1e-5)
    assert sorted(tuple(x.shape) for x in _flat(tc)) == sorted(
        tuple(x.shape) for x in jax.tree_util.tree_leaves(jc))
    with pytest.raises(AssertionError):
        J.init_cache(jcfg, jp, 2, 32, jnp.float32)
    with pytest.raises(ValueError, match="frontend_emb"):
        T.init_cache(tcfg, tp, 2, 32, torch.float32)
    with pytest.raises(ValueError, match="frontend_emb"):
        T.forward(tcfg, tp, torch.zeros((1, 4), dtype=torch.int64),
                  kernel_backend="plain")


@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_whisper_masked_decode_matches_jax(backend):
    """``decode_step`` then ``decode_run`` over a 4-row whisper cache with
    row 2 inactive, bounded to kv_limit 32 of 64: the active rows' tokens
    (and the step's logits, 1e-2) equal the reference's, and row 2's every
    leaf (its ring, its cross K/V, ``enc_out``) and position stay bit for
    bit."""
    jcfg, jp, tcfg = tfc.weights(tfc.WHISPER)
    tp = tfc.port(jp)
    toks, fe = tfc.tokens(jcfg, (4, 10)), tfc.frames(jcfg, 4)
    jl, jc = J.prefill(jcfg, jp, jnp.asarray(toks), max_len=64,
                       dtype=jnp.float32, frontend_emb=jnp.asarray(fe))
    _, tc = T.prefill(tcfg, tp, torch.from_numpy(toks), max_len=64,
                      dtype=torch.float32, frontend_emb=torch.from_numpy(fe),
                      kernel_backend=backend)
    last = np.array(jnp.argmax(jl, -1), np.int32)
    active = np.asarray([True, True, False, True])
    kw = dict(kv_limit=32, full_alloc=64)
    ta = torch.from_numpy(active)
    before = _row(tc, 2) + [tc["enc_out"][2].clone(), tc["pos"].clone()]
    jn, jlg, jc = J.decode_step(jcfg, jp, jc, jnp.asarray(last),
                                jnp.asarray(active), **kw)
    tn, tlg, tc = T.decode_step(tcfg, tp, tc, torch.from_numpy(last), ta,
                                kernel_backend=backend, **kw)
    assert np.array_equal(tn.numpy()[active], np.asarray(jn)[active])
    _close(tlg[ta], np.asarray(jlg)[active], 1e-2)
    nxt = np.where(active, np.asarray(jn), last).astype(np.int32)
    jblock, _, jc = J.decode_run(jcfg, jp, jc, jnp.asarray(nxt),
                                 jnp.asarray(active), 6, **kw)
    tblock, _, tc = T.decode_run(tcfg, tp, tc, torch.from_numpy(nxt), ta, 6,
                                 kernel_backend=backend, **kw)
    assert np.array_equal(tblock.numpy()[:, active],
                          np.asarray(jblock)[:, active])
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() \
        == [17, 17, 10, 17]
    after = _row(tc, 2) + [tc["enc_out"][2], before[-1]]
    assert all(torch.equal(x, y) for x, y in zip(after, before))


@pytest.mark.parametrize("arch", tfc.PARITY_ARCHS)
@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_frontend_lm_loss_and_grads_match_jax(arch, backend):
    """``lm_loss`` with the frames (whisper) or the prepended patches,
    whose positions the loss skips (llava), and every gradient leaf, the
    encoder's, the cross attention's and ``frontend_proj``'s among them."""
    from repro_torch.train.train_loop import loss_and_grads
    jcfg, jp, tcfg = tfc.weights(arch)
    jloss, jnll, jaux, want = tfc.jax_loss_and_grads(arch, TRAIN_S)
    toks = tfc.tokens(jcfg, (2, TRAIN_S + 1))
    loss, met, grads = loss_and_grads(
        tcfg, tfc.port(jp), torch.from_numpy(toks),
        torch.from_numpy(tfc.frames(jcfg, 2)), kernel_backend=backend)
    ttc.assert_rel(float(loss), jloss, ttc.LOSS_REL, "loss")
    ttc.assert_rel(float(met["nll"]), jnll, ttc.LOSS_REL, "nll")
    assert float(met["aux"]) == jaux == 0.0
    assert any(n.startswith("encoder.") for n in want) == \
        jcfg.is_encoder_decoder
    assert ("frontend_proj.w" in want) == arch.endswith(tfc.PROJ)
    ttc.assert_grads_match(grads, want)


@pytest.mark.parametrize("arch", [tfc.WHISPER, tfc.LLAVA])
@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_frontend_prefill_and_decode_match_forward(arch, backend):
    """tests/test_consistency.py's two checks within the port: the
    prefill's logits are the training forward's last position (3e-3), and
    a decode step's are the forward's on the longer sequence (1e-2)."""
    _, jp, cfg = tfc.weights(arch)
    params = tfc.port(jp)
    toks = torch.from_numpy(tfc.tokens(cfg, (2, 16)))
    fe = torch.from_numpy(tfc.frames(cfg, 2) * 0.2)
    full, _ = T.forward(cfg, params, toks, fe, kernel_backend=backend)
    lg, cache = T.prefill(cfg, params, toks, max_len=48, frontend_emb=fe,
                          dtype=torch.float32, kernel_backend=backend)
    _close(lg, full[:, -1].detach(), 3e-3)
    nxt = lg.argmax(-1)[:, None]
    lg2, _ = T.extend(cfg, params, cache, nxt, kernel_backend=backend)
    longer, _ = T.forward(cfg, params, torch.cat([toks, nxt], 1), fe,
                          kernel_backend=backend)
    _close(lg2, longer[:, -1].detach(), 1e-2)


@pytest.mark.parametrize("arch", tfc.FRONTEND_ARCHS)
def test_init_params_has_the_reference_tree(arch):
    """The port's own ``init_params`` draws every leaf of the reference's
    tree (the decoder's cross attention and ``norm_x``, the stacked
    ``encoder``, ``frontend_proj``) at its shape and dtype."""
    jcfg, _, tcfg = tfc.weights(arch)
    jp = J.init_params(jcfg, jax.random.PRNGKey(0), jnp.bfloat16)
    want = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): (leaf.shape, str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_leaves_with_path(jp)}
    sd = T.init_params(tcfg, seed=0, device="cpu").state_dict()
    got = {n: (tuple(x.shape), str(x.dtype).removeprefix("torch."))
           for n, x in sd.items()}
    assert got == want


# -- the stage-decoupled handoff and the scratch bind (DESIGN.md §14) ---------
HANDOFF_MAX_LEN = 64
_cached_weights = functools.lru_cache(maxsize=None)(_weights)


def _random_cache_pair(jcfg, jp, batch, pos, kv_dtype, dtype, rng):
    """The same random cache as the reference's (jax) and the port's
    (torch): every leaf of every section drawn with numpy, ``slot_pos``
    holding each row's last ``alloc`` positions below ``pos[row]`` at
    ``position % alloc`` (-1 elsewhere), as a prefill leaves them."""
    tdt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype]
    shape = J.init_cache(jcfg, jp, batch, HANDOFF_MAX_LEN, dtype,
                         kv_dtype=kv_dtype)
    pos = np.asarray(pos, np.int32)

    def leaf(name, x, axis):
        if name == "slot_pos":
            alloc = x.shape[-1]
            p = pos.reshape((1,) * axis + (-1, 1))
            ring = np.arange(alloc, dtype=np.int32)
            # the live position of each ring slot: the last one below pos
            live = ring + ((p - 1 - ring) // alloc) * alloc
            v = np.where((ring < p) & (live >= 0), live, -1)
            return (jnp.asarray(np.broadcast_to(v, x.shape).astype(np.int32)),
                    torch.from_numpy(np.broadcast_to(v, x.shape)
                                     .astype(np.int32).copy()))
        if x.dtype == jnp.int8:
            v = rng.integers(-127, 128, x.shape, dtype=np.int8)
            return jnp.asarray(v), torch.from_numpy(v)
        if name in ("k_scale", "v_scale"):
            v = rng.uniform(0.01, 1.0, x.shape).astype(np.float32)
        else:
            v = rng.standard_normal(x.shape, dtype=np.float32)
        t = torch.from_numpy(v)
        return (jnp.asarray(v).astype(x.dtype),
                t.to(tdt) if x.dtype == jnp.bfloat16 else t)

    def section(states, axis):
        pairs = [{n: leaf(n, x, axis) for n, x in st.items()}
                 for st in states]
        return ([{n: p[0] for n, p in d.items()} for d in pairs],
                [{n: p[1] for n, p in d.items()} for d in pairs])

    jc = {"pos": jnp.asarray(pos)}
    tc = {"pos": torch.from_numpy(pos.copy())}
    for sec in ("head", "tail"):
        js, ts = section(shape[sec], 0)
        jc[sec], tc[sec] = tuple(js), tuple(ts)
    keys = list(shape["blocks"])
    js, ts = section([shape["blocks"][k] for k in keys], 1)
    jc["blocks"] = dict(zip(keys, js))
    tc["blocks"] = {str(k): v for k, v in zip(keys, ts)}
    return jc, tc


def _assert_cache_bitwise(tc, jc):
    jleaves = jax.tree_util.tree_leaves(
        {"pos": jc["pos"], "head": jc["head"], "tail": jc["tail"],
         "blocks": {str(k): v for k, v in jc["blocks"].items()}})
    tleaves = jax.tree_util.tree_leaves(
        {"pos": tc["pos"], "head": tc["head"], "tail": tc["tail"],
         "blocks": tc["blocks"]})
    assert len(tleaves) == len(jleaves) > 1
    for t, j in zip(tleaves, jleaves):
        assert tuple(t.shape) == tuple(j.shape)
        assert np.array_equal(_as_np(t), _as_np(j))


@pytest.mark.parametrize("arch,dtype,kv_dtype,prompt_len", [
    ("llama3-405b", jnp.bfloat16, None, 21),
    ("llama3-405b", jnp.bfloat16, "int8", 40),
    ("qwen2-moe-a2.7b", jnp.bfloat16, None, 21),
    (TAIL, jnp.bfloat16, None, 40),
    ("rwkv6-1.6b", jnp.bfloat16, None, 21),
    (MLA, jnp.bfloat16, None, 21)],
    ids=["llama_bf16", "llama_int8", "moe", "rglru_tail", "rwkv6", "mla"])
def test_handoff_row_and_write_slot_match_jax(arch, dtype, kv_dtype,
                                              prompt_len):
    """``write_slot`` (the scratch baseline's bind) and ``handoff_row`` of
    a staging entry truncated to the prompt's pow-2 cap (a view here, a copy
    in the reference) against the reference's on the same random pool and
    staging cache: every leaf bit for bit (ring payload, int8 scales,
    ``slot_pos``, ``pos``, the RG-LRU ``h``/``conv`` of blocks and the
    unrolled tail, the RWKV6 WKV and shift states); the entry is read, never
    written.  At prompt 40 the 32-slot window of recurrentgemma has wrapped
    and its ring is carried whole; at 21 a full ring is cut to 32 slots."""
    jcfg, jp, _, _ = _cached_weights(arch)
    rng = np.random.default_rng(prompt_len)
    jpool, tpool = _random_cache_pair(jcfg, jp, 3, [9, 50, 30], kv_dtype,
                                      dtype, rng)
    jone, tone = _random_cache_pair(jcfg, jp, 1, [prompt_len], kv_dtype,
                                    dtype, rng)
    full = HANDOFF_MAX_LEN
    jpool = J.write_slot(jpool, jone, jnp.int32(0))
    assert T.write_slot(tpool, tone, 0) is tpool
    _assert_cache_bitwise(tpool, jpool)
    cap = 1 << (prompt_len - 1).bit_length()
    kept = _clone(tone)
    jentry = J.truncate_rings(jone, cap, full)
    tentry = T.truncate_rings(tone, cap, full)
    jpool = J.handoff_row(jpool, jentry, jnp.int32(2), cap, full)
    assert T.handoff_row(tpool, tentry, 2, cap, full) is tpool
    _assert_cache_bitwise(tpool, jpool)
    assert _pool_equal(tone, kept)
    assert tpool["pos"].tolist() == [prompt_len, 50, prompt_len]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_jax(arch):
    """``models.prefill`` (a fresh cache, one ``extend``: the reference's
    sequential oracle) against the reference's on the same prompt, with
    the cache sized to ``max_len`` or, by default, to the prompt."""
    jcfg, jp, tcfg, tp = _cached_weights(arch)
    toks = _tokens(jcfg, (2, 19))
    jl, jc = J.prefill(jcfg, jp, jnp.asarray(toks), max_len=48,
                       dtype=jnp.float32)
    tl, tc = T.prefill(tcfg, tp, torch.from_numpy(toks), max_len=48,
                       dtype=torch.float32)
    _close(tl, jl, 3e-3)
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [19, 19]
    _, short = T.prefill(tcfg, tp, torch.from_numpy(toks),
                         dtype=torch.float32)
    _, jshort = J.prefill(jcfg, jp, jnp.asarray(toks), dtype=jnp.float32)
    assert sorted(tuple(x.shape) for x in _flat(short)) == sorted(
        tuple(x.shape) for x in jax.tree_util.tree_leaves(jshort))
