"""PyTorch port: the real engine against the JAX reference engine on the same
weights and trace, with the shared-prefix KV cache off and on: identical
token streams, kernel-completion traces and ``stats()`` (every key; every
value but the two named in VALUE_EXEMPT), including a reactive flow
submitted mid-run from an ``on_token`` callback; mirrors of
tests/test_prefix_cache.py's real-backend tests held to the reference on the
same weights; for the recurrent families also the reference's
elastic-decode exactness on a windowed hybrid (elastic == full pool == the
unscheduled reference)."""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_tiny_config as j_tiny
from repro.core import Priority as JPriority
from repro.core import Request as JRequest
from repro.core.engine import RealAgentXPUEngine as JEngine
from repro.models import init_params as j_init_params
from repro_torch.configs import get_tiny_config as t_tiny
from repro_torch.core import Priority as TPriority
from repro_torch.core import Request as TRequest
from repro_torch.core.engine import RealAgentXPUEngine as TEngine
from repro_torch.kernels import ops
from repro_torch.models import (from_jax_params, init_params,
                                module_from_state_dict)
from torch_recurrent_cases import TAIL, tiny

ARCH = "llama3-405b"
# stats() values that differ by nature: the name of each side's kernel
# route ("xla" vs "cuda"), and a ratio of two wall-clock times
VALUE_EXEMPT = {"kernel_backend", "co_execution_decode_slowdown_measured"}


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The reference's tiny weights of ``arch`` and their port (the engines
    never write their params, so one pair serves every test)."""
    jcfg, tcfg = tiny(j_tiny, arch), tiny(t_tiny, arch)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = module_from_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, jp)))
    return jcfg, jp, tcfg, tp


def _assert_stats_equal(ts, js):
    assert set(ts) == set(js)
    assert {k: v for k, v in ts.items() if k not in VALUE_EXEMPT} \
        == {k: v for k, v in js.items() if k not in VALUE_EXEMPT}


def _flows(vocab, shared=0):
    """Three proactive flows and a reactive one submitted mid-run; with
    ``shared``, every prompt starts with the same ``shared`` tokens (a
    system prompt) before its own tail."""
    rng = np.random.default_rng(7)
    system = rng.integers(0, vocab, (1, shared))
    spec = [(0, 0.0, 20, False), (1, 0.0, 26, False), (2, 0.01, 14, False),
            (3, 0.0, 11, True)]  # id 3: reactive, submitted mid-run
    return [(i, t, np.concatenate([system, rng.integers(0, vocab, (1, p))],
                                  axis=1), late)
            for i, t, p, late in spec]


def _serve(engine, req_cls, prio, flows, out_tokens=10):
    """Submit the trace, with the late reactive flow submitted from an
    on_token callback once 12 tokens have streamed."""
    seen = {}
    late = []

    def on_token(req, tok):
        seen.setdefault(req.id, []).append(tok)
        if late and sum(map(len, seen.values())) >= 12:
            engine.submit(late.pop(), on_token)

    for i, t, toks, is_late in flows:
        req = req_cls(id=i, priority=prio.REACTIVE if is_late
                      else prio.PROACTIVE, prompt_len=toks.shape[1],
                      max_new_tokens=out_tokens, arrival_time=t,
                      tokens=toks)
        if is_late:
            late.append(req)
        else:
            engine.submit(req, on_token)
    metrics = engine.run()
    assert not late, "the mid-run submit never fired"
    return metrics, seen


# with the prefix cache on, a 24-token system prompt shared by every flow
SYSTEM = 24


@pytest.mark.parametrize("arch,kw,shared", [
    (ARCH, {}, 0),
    (ARCH, {"kv_dtype": "int8"}, 0),
    (ARCH, {"max_fused_steps": 1}, 0),
    ("qwen2-moe-a2.7b", {}, 0),
    ("qwen2-moe-a2.7b", {"max_fused_steps": 1}, 0),
    ("recurrentgemma-9b", {}, 0),
    ("recurrentgemma-9b", {"kv_dtype": "int8"}, 0),
    (TAIL, {}, 0),
    (TAIL, {"max_fused_steps": 1}, 0),
    ("rwkv6-1.6b", {}, 0),
    ("rwkv6-1.6b", {"max_fused_steps": 1}, 0),
    (ARCH, {}, SYSTEM),
    (ARCH, {"kv_dtype": "int8"}, SYSTEM),
    (ARCH, {"max_fused_steps": 1}, SYSTEM),
    ("qwen2-moe-a2.7b", {}, SYSTEM),
    ("recurrentgemma-9b", {}, SYSTEM),
    (ARCH, {"in_pool_prefill": False}, 0),
    (ARCH, {"device_resident": False}, 0),
    ("qwen2-moe-a2.7b", {"in_pool_prefill": False}, 0),
    ("qwen2-moe-a2.7b", {"device_resident": False}, 0),
    ("recurrentgemma-9b", {"in_pool_prefill": False}, 0),
    ("recurrentgemma-9b", {"device_resident": False}, 0),
    ("rwkv6-1.6b", {"in_pool_prefill": False}, 0),
    ("rwkv6-1.6b", {"device_resident": False}, 0),
], ids=["fused", "int8", "per_step", "moe_fused", "moe_per_step",
        "rglru_fused", "rglru_int8", "rglru_tail_fused",
        "rglru_tail_per_step", "rwkv6_fused", "rwkv6_per_step",
        "prefix_fused", "prefix_int8", "prefix_per_step", "prefix_moe",
        "prefix_rglru", "scratch", "legacy", "moe_scratch", "moe_legacy",
        "rglru_scratch", "rglru_legacy", "rwkv6_scratch", "rwkv6_legacy"])
def test_engine_matches_reference(arch, kw, shared):
    """Without a shared prefix the cache is off on both sides (random
    prompts over a tiny vocabulary can share a first token, which the
    reference, run without the cache, must not turn into hits); with one,
    both sides run their default, the cache on.  recurrentgemma fails
    ``prefix_reuse_supported`` and serves cold on both sides.  The
    scratch-cache (``in_pool_prefill=False``) and pre-donation
    (``device_resident=False``) baselines bind every prompt with one
    full-row scatter; the latter fuses no decode run."""
    jcfg, jp, tcfg, tp = _weights(arch)
    flows = _flows(jcfg.vocab_size, shared)
    cache = dict(prefix_cache=False) if not shared else {}
    jeng = JEngine(jcfg, jp, max_len=128, dual_device=False, **cache, **kw)
    teng = TEngine(tcfg, tp, max_len=128, device="cpu", **cache, **kw)
    jm, jseen = _serve(jeng, JRequest, JPriority, flows)
    before = dict(ops.LAUNCHES)
    tm, tseen = _serve(teng, TRequest, TPriority, flows)
    assert len(tm.completed) == len(jm.completed) == len(flows)
    for i, *_ in flows:
        assert teng.output_tokens(i) == jeng.output_tokens(i), f"flow {i}"
        assert len(teng.output_tokens(i)) == 10
    assert tseen == jseen
    assert teng.last_trace == jeng.last_trace
    ts = teng.stats()
    _assert_stats_equal(ts, jeng.stats())
    assert teng.backend.validate() == []
    if shared:
        gated = arch == "recurrentgemma-9b"
        assert (ts["prefix_hits"] == 0) == gated
        assert ts["prefix_fallbacks"] == 0
    # CPU tensors never reach a kernel
    assert ops.LAUNCHES == before
    baseline = kw.get("in_pool_prefill", True) is False \
        or kw.get("device_resident", True) is False
    if baseline:
        assert ts["bind_device_calls"] == len(flows)
        assert ts["kv_bytes_prefill"] > 0
    if kw.get("device_resident", True) is False:
        assert ts["fused_steps"] == 0
    elif "max_fused_steps" not in kw and not shared:
        assert ts["fused_steps"] > 0
        # the reference's scheduler aborts no fused run of this trace for
        # rwkv6 (no attention kernels: the reactive prefill rides beside
        # decode); every other arch's trace covers an abort
        assert ts["aborted_runs"] > 0 or arch == "rwkv6-1.6b"


def _reference_tokens(cfg, params, prompt, n_out, max_len):
    """Unscheduled batch-1 greedy tokens of the JAX reference
    (tests/test_elastic_decode.py's ``_reference_tokens``)."""
    from repro.models import extend, prefill
    lg, cache = prefill(cfg, params, jnp.asarray(prompt), max_len=max_len,
                        dtype=jnp.float32)
    out = [int(lg.argmax(-1)[0])]
    for _ in range(n_out - 1):
        lg, cache = extend(cfg, params, cache,
                           jnp.asarray([[out[-1]]], jnp.int32))
        out.append(int(lg.argmax(-1)[0]))
    return out


def test_sliding_window_hybrid_elastic_exact():
    """tests/test_elastic_decode.py's windowed-hybrid case on the port:
    tiny recurrentgemma-9b (RG-LRU + local attention, window 32 < max_len)
    with prompts long enough that the window slides.  Window-shrunk rings
    are never truncated and recurrent states ride the row bound only: the
    elastic serve equals the full-pool serve and the reference's
    unscheduled greedy tokens."""
    jcfg, jp, tcfg, tp = _weights("recurrentgemma-9b")
    assert tcfg.sliding_window == 32
    rng = np.random.default_rng(79)
    prompts = [rng.integers(0, tcfg.vocab_size, (1, n)) for n in (40, 36)]
    out = {}
    for elastic in (True, False):
        eng = TEngine(tcfg, tp, max_len=128, device="cpu", pool_slots=8,
                      b_max=8, elastic_decode=elastic)
        reqs = [TRequest(id=i, priority=TPriority.PROACTIVE,
                         prompt_len=p.shape[1], max_new_tokens=10,
                         arrival_time=0.0, tokens=p)
                for i, p in enumerate(prompts)]
        eng.serve(reqs)
        if elastic:
            assert 0 < eng.stats()["decode_rows"] <= 2  # row bound engaged
        out[elastic] = [eng.output_tokens(i) for i in range(len(prompts))]
    assert out[True] == out[False]
    for i, p in enumerate(prompts):
        assert out[True][i] == _reference_tokens(jcfg, jp, p, 10, 128)


def test_engine_needs_a_gpu_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid here")
    cfg = t_tiny(ARCH)
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="no GPU"):
        TEngine(cfg, params)


def test_init_params_needs_a_gpu_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="no GPU"):
        init_params(t_tiny(ARCH), seed=0, dtype=torch.float32)


def test_cancel_mid_run_frees_the_slot():
    cfg = t_tiny(ARCH)
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    eng = TEngine(cfg, params, max_len=64, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [TRequest(id=i, priority=TPriority.PROACTIVE, prompt_len=10,
                     max_new_tokens=12, arrival_time=0.0,
                     tokens=rng.integers(0, cfg.vocab_size, (1, 10)))
            for i in range(3)]

    def on_token(req, tok):
        if req.id == 0 and len(eng.output_tokens(0)) == 3:
            assert eng.cancel(reqs[1])

    for r in reqs:
        eng.submit(r, on_token)
    m = eng.run()
    assert {r.id: r.terminal_status for r in m.completed} == {
        0: "completed", 1: "cancelled", 2: "completed"}
    assert eng.stats()["free_slots"] == eng.stats()["pool_slots"]
    assert eng.backend.validate() == []


# -- mirrors of tests/test_prefix_cache.py's real-backend tests ----------------
def _engines(**kw):
    """The reference's and the port's engine on tiny llama3-405b, the same
    weights and knobs (the prefix cache on unless ``kw`` says otherwise)."""
    jcfg, jp, tcfg, tp = _weights(ARCH)
    return (JEngine(jcfg, jp, max_len=128, dual_device=False, **kw),
            TEngine(tcfg, tp, max_len=128, device="cpu", **kw))


def _shared_prefix_reqs(req_cls, prio, n=4, sys_len=40, tail=8, out=4):
    """tests/test_prefix_cache.py's trace, as ``req_cls`` requests."""
    vocab = _weights(ARCH)[0].vocab_size
    rng = np.random.default_rng(11)
    sys_toks = rng.integers(0, vocab, (1, sys_len))
    reqs = []
    for i in range(n):
        toks = np.concatenate(
            [sys_toks, rng.integers(0, vocab, (1, tail))], axis=1)
        reqs.append(req_cls(id=i, priority=prio.PROACTIVE,
                            prompt_len=sys_len + tail, max_new_tokens=out,
                            arrival_time=0.01 * i, tokens=toks))
    return reqs


def _serve_both(jeng, teng, waves=1, **kw):
    """Serve the shared-prefix trace on both engines (in ``waves`` equal
    runs); the port's tokens, trace and stats must equal the reference's.
    Returns the port's stats and tokens by flow."""
    jreqs = _shared_prefix_reqs(JRequest, JPriority, **kw)
    treqs = _shared_prefix_reqs(TRequest, TPriority, **kw)
    step = len(treqs) // waves
    for i in range(0, len(treqs), step):
        jeng.serve(copy.deepcopy(jreqs[i:i + step]))
        teng.serve(copy.deepcopy(treqs[i:i + step]))
        assert teng.last_trace == jeng.last_trace
    toks = {r.id: teng.output_tokens(r.id) for r in treqs}
    assert toks == {r.id: jeng.output_tokens(r.id) for r in jreqs}
    ts = teng.stats()
    _assert_stats_equal(ts, jeng.stats())
    assert teng.backend.validate() == []
    return ts, toks


def _port_serve(teng, **kw):
    treqs = _shared_prefix_reqs(TRequest, TPriority, **kw)
    teng.serve(copy.deepcopy(treqs))
    return teng.stats(), {r.id: teng.output_tokens(r.id) for r in treqs}


def test_prefix_hits_are_token_exact_and_skip_forwards():
    hot, hot_toks = _serve_both(*_engines())
    _, cold_eng = _engines(prefix_cache=False)
    cold, cold_toks = _port_serve(cold_eng)
    assert hot_toks == cold_toks
    assert cold["prefix_hits"] == 0 and cold["prefill_forward_tokens"] == \
        4 * 48
    # flows 1..3 each hit the 40-token shared prefix of flow 0's donor row
    assert hot["prefix_hits"] == 3 and hot["prefix_hit_tokens"] == 120
    assert hot["prefix_fallbacks"] == 0
    assert hot["kv_bytes_prefix_copied"] > 0
    # no forward pass over a matched token
    assert hot["prefill_forward_tokens"] == \
        cold["prefill_forward_tokens"] - hot["prefix_hit_tokens"]


def test_hit_request_matches_unscheduled_reference():
    jcfg, jp, *_ = _weights(ARCH)
    _, teng = _engines()
    st, toks = _port_serve(teng, n=3, out=5)
    assert st["prefix_hits"] == 2
    for r in _shared_prefix_reqs(TRequest, TPriority, n=3, out=5):
        assert toks[r.id] == _reference_tokens(jcfg, jp, r.tokens, 5, 128)


def test_store_promotion_outlives_donor_slot():
    """Waves of 2 through a 2-slot pool rebind both slots every wave: the
    prefix is promoted to the store at rebind and later hits paste from
    it; tokens and counters equal the reference's, and the cold serve's."""
    st, toks = _serve_both(*_engines(pool_slots=2), waves=3, n=6, out=2)
    assert st["prefix_hits"] == 5 and st["prefix_fallbacks"] == 0
    assert st["prefix_promotions"] > 0 and st["prefix_store_entries"] > 0
    _, cold = _engines(pool_slots=2, prefix_cache=False)
    treqs = _shared_prefix_reqs(TRequest, TPriority, n=6, out=2)
    for i in range(0, 6, 2):
        cold.serve(copy.deepcopy(treqs[i:i + 2]))
    assert toks == {r.id: cold.output_tokens(r.id) for r in treqs}


def test_eviction_spares_an_inflight_consumer():
    st, _ = _serve_both(*_engines(prefix_cache_tokens=64), n=5, out=2)
    assert st["prefix_evictions"] > 0  # capacity 64 << 5 distinct tails
    assert st["prefix_fallbacks"] == 0


@pytest.mark.parametrize("prefix_cache", [True, False], ids=["on", "off"])
def test_sim_and_real_traces_equal(prefix_cache):
    from repro_torch.core import AgentXPUEngine as TSim
    from repro_torch.core.backend import SimBackend as TSimBackend
    _, teng = _engines(prefix_cache=prefix_cache)
    treqs = _shared_prefix_reqs(TRequest, TPriority)
    sim = TSim(_weights(ARCH)[2])
    sim.backend = TSimBackend(prefix_cache=prefix_cache, max_len=128)
    m_sim = sim.run_trace(copy.deepcopy(treqs))
    m_real = teng.serve(copy.deepcopy(treqs))
    assert sim.last_trace == teng.last_trace
    assert m_sim.sim_time == m_real.sim_time
    assert m_sim.summary()["prefix_hit_tokens"] == \
        m_real.summary()["prefix_hit_tokens"] == (120 if prefix_cache else 0)


def test_unsupported_config_disables_cache_not_backend():
    from repro.core.backend import JaxRealBackend
    from repro_torch.core.backend import TorchRealBackend
    from repro_torch.core.prefixcache import prefix_reuse_supported
    jcfg, jp, tcfg, tp = _weights("starcoder2-7b")  # window < max_len
    assert not prefix_reuse_supported(tcfg, 128)
    jbe = JaxRealBackend(jcfg, jp, pool_slots=2, max_len=128,
                         dtype=jnp.float32)
    tbe = TorchRealBackend(tcfg, tp, pool_slots=2, max_len=128,
                           device="cpu")
    assert tbe._prefix is None and jbe._prefix is None  # silently cold
    r = TRequest(id=0, priority=TPriority.PROACTIVE, prompt_len=6,
                 max_new_tokens=2, arrival_time=0.0,
                 tokens=np.random.default_rng(0).integers(
                     0, tcfg.vocab_size, (1, 6)))
    assert tbe.prefix_hit(r) == 0
    _assert_stats_equal(tbe.stats(), jbe.stats())


def test_wrap_gate_skips_indexing():
    """A donor whose row can wrap past max_len is never indexed."""
    jeng, teng = _engines()
    vocab = _weights(ARCH)[0].vocab_size
    toks = np.random.default_rng(3).integers(0, vocab, (1, 100))
    for eng, req_cls, prio in ((jeng, JRequest, JPriority),
                               (teng, TRequest, TPriority)):
        eng.serve([req_cls(id=i, priority=prio.PROACTIVE, prompt_len=100,
                           max_new_tokens=40, arrival_time=0.01 * i,
                           tokens=toks.copy())  # 100 + 40 > max_len 128
                   for i in range(2)])
    st = teng.stats()
    assert st["prefix_inserts"] == 0 and st["prefix_hits"] == 0
    _assert_stats_equal(st, jeng.stats())
    assert [teng.output_tokens(i) for i in range(2)] == \
        [jeng.output_tokens(i) for i in range(2)]


@pytest.mark.parametrize("kw", [{"prefix_cache_tokens": 64},
                                {"prefix_block": 4}])
def test_prefix_cache_size_knobs_match_reference(kw):
    """The backend's size knobs build the reference's index: the same
    capacity and block, and so the same hits on a shared-prefix trace
    (``prefix_block`` rounds each hit down to a multiple of the block)."""
    from repro.core.backend import JaxRealBackend
    from repro_torch.core.backend import TorchRealBackend
    jcfg, jp, tcfg, tp = _weights(ARCH)
    jbe = JaxRealBackend(jcfg, jp, pool_slots=2, max_len=128,
                         dtype=jnp.float32, **kw)
    tbe = TorchRealBackend(tcfg, tp, pool_slots=2, max_len=128,
                           device="cpu", **kw)
    assert (tbe._prefix.capacity_tokens, tbe._prefix.block) == \
        (jbe._prefix.capacity_tokens, jbe._prefix.block)
    for be, req_cls, prio in ((jbe, JRequest, JPriority),
                              (tbe, TRequest, TPriority)):
        reqs = _shared_prefix_reqs(req_cls, prio, n=2, sys_len=42)
        be.prefix_hit(reqs[0])
        be._prefix.insert(tuple(int(t) for t in reqs[0].tokens[0]))
        assert be.prefix_hit(reqs[1]) == (40 if "prefix_block" in kw
                                          else 42)
    _assert_stats_equal(tbe.stats(), jbe.stats())
