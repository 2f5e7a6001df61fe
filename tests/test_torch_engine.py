"""PyTorch port: the real engine against the JAX reference engine on the same
weights and trace, with the shared-prefix KV cache off and on: identical
token streams, kernel-completion traces and ``stats()`` (every key; every
value but the two named in ``torch_engine_cases.VALUE_EXEMPT``), including a reactive flow
submitted mid-run from an ``on_token`` callback; mirrors of
tests/test_prefix_cache.py's real-backend tests held to the reference on the
same weights; for the recurrent families also the reference's
elastic-decode exactness on a windowed hybrid (elastic == full pool == the
unscheduled reference).  Last, the port's in-program tracer
(``repro_torch.core.tracing``) and the benchmark's readings of it
(``portbench/spans.py``): off it records nothing and a traced twin serves
the same tokens and ``stats()``; a flow's three spans to its first token
touch and add up to its first token's wall; spans nest in their parents;
the idle split of synthetic intervals; the clock anchor against
``torch.profiler``."""
import copy
import os
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Priority as JPriority
from repro.core import Request as JRequest
from repro.core.engine import RealAgentXPUEngine as JEngine
from repro_torch.configs import get_tiny_config as t_tiny
from repro_torch.core import Priority as TPriority
from repro_torch.core import Request as TRequest
from repro_torch.core.engine import RealAgentXPUEngine as TEngine
from repro_torch.core.tracing import FLOW, Span, Tracer
from repro_torch.models import init_params
import torch_engine_cases as tec
from torch_recurrent_cases import TAIL

ARCH = "llama3-405b"
_weights, _flows, _serve = tec.weights, tec.flows, tec.serve
_assert_stats_equal, SYSTEM = tec.assert_stats_equal, tec.SYSTEM


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
    """``torch_engine_cases.engine_matches_reference``: the cache off
    without a shared prefix and on with one, the baselines binding every
    prompt with one full-row scatter."""
    tec.engine_matches_reference(arch, kw, shared)


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


# -- the in-program tracer (core.tracing) ----------------------------------
def _spans():
    """``portbench/spans.py``, the benchmark's reader of the spans."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from portbench import spans
    return spans


@pytest.fixture(scope="module")
def tiny():
    cfg = t_tiny(ARCH)
    return cfg, init_params(cfg, 0, torch.float32, "cpu")


def _engine(tiny):
    cfg, params = tiny
    return TEngine(cfg, params, max_len=128, device="cpu",
                   max_fused_steps=8, decode_segment_steps=2,
                   strict_invariants=True)


def _traced_flows(cfg, n=6):
    """Proactive and reactive requests, all submitted before the run."""
    rng = np.random.default_rng(3)
    out = []
    for i in range(n):
        plen = int(rng.integers(8, 40))
        out.append(TRequest(
            id=i, priority=TPriority.REACTIVE if i % 3 == 2
            else TPriority.PROACTIVE, prompt_len=plen,
            max_new_tokens=int(rng.integers(3, 9)), arrival_time=0.0,
            tokens=rng.integers(0, cfg.vocab_size, (1, plen))))
    return out


def test_off_records_nothing_and_on_changes_no_token(tiny):
    cfg, _ = tiny
    off, on = _engine(tiny), _engine(tiny)
    on.tracer.enable()
    m_off = off.serve(_traced_flows(cfg))
    m_on = on.serve(_traced_flows(cfg))
    assert off.tracer.records() == []
    assert on.tracer.records()
    for r in m_off.completed:
        assert off.output_tokens(r.id) == on.output_tokens(r.id)
    assert off.last_trace == on.last_trace
    s_off, s_on = off.stats(), on.stats()
    assert s_off.keys() == s_on.keys()
    # the one wall-clock reading of stats() (segment walls' ratio)
    wall = "co_execution_decode_slowdown_measured"
    assert (s_off[wall] is None) == (s_on[wall] is None)
    assert {k: v for k, v in s_off.items() if k != wall} \
        == {k: v for k, v in s_on.items() if k != wall}


def test_reactive_flow_spans_touch_and_make_its_first_token(tiny):
    from repro_torch.launch.frontend import ServingFrontend
    cfg, _ = tiny
    eng = _engine(tiny)
    eng.tracer.enable()
    rng = np.random.default_rng(1)
    with ServingFrontend(eng) as fe:
        hs = [fe.submit(rng.integers(0, cfg.vocab_size, (1, 24)),
                        max_new_tokens=6) for _ in range(3)]
        time.sleep(0.02)
        hs += [fe.submit(rng.integers(0, cfg.vocab_size, (1, 30)),
                         priority=TPriority.REACTIVE, max_new_tokens=4)
               for _ in range(2)]
        for h in hs:
            assert h.result(timeout=60)["status"] == "completed"
    recs = eng.tracer.records()
    for h in hs:
        mine = sorted((s for s in recs if s.rid == h.flow_id
                       and s.name in FLOW), key=lambda s: s.start)
        assert [s.name for s in mine] == list(FLOW)
        assert all(a.end == b.start for a, b in zip(mine, mine[1:]))
        assert all(s.tid is None and s.dur >= 0 for s in mine)
        reactive = h.req.priority == TPriority.REACTIVE
        assert all(s.attrs == {"reactive": int(reactive)} for s in mine)
        # the same clock: the spans run from the submit instant to the
        # first token's emit, which its handle stamps a moment later
        assert mine[0].start == round(h.submit_wall * 1e9)
        gap = h.token_walls[0] - sum(s.dur for s in mine) / 1e9 \
            - h.submit_wall
        assert 0 <= gap < 5e-3
    S = _spans()
    parts, rids = S.ttft_parts(recs, 0, time.perf_counter_ns())
    reactive = [h for h in hs if h.req.priority == TPriority.REACTIVE]
    assert rids == sorted(h.flow_id for h in reactive)
    mean = np.mean([h.token_walls[0] - h.submit_wall for h in reactive])
    assert sum(parts.values()) == pytest.approx(mean, abs=5e-3)


def test_spans_nest_in_their_parents_and_self_time_is_the_rest(tiny):
    cfg, _ = tiny
    eng = _engine(tiny)
    eng.tracer.enable()
    eng.serve(_traced_flows(cfg, 4))
    recs = eng.tracer.records()
    by_id = {s.id: s for s in recs}
    stacked = [s for s in recs if s.tid is not None]
    names = {s.name for s in stacked}
    assert {"engine.turn", "sched.arrival", "sched.complete",
            "sched.dispatch", "backend.launch", "backend.sync",
            "backend.emit", "backend.chunk", "backend.prefill_finish",
            "backend.decode_step", "backend.segment"} <= names
    for s in stacked:
        if s.name == "engine.turn":
            assert s.parent is None
            continue
        p = by_id[s.parent]
        assert p.start <= s.start <= s.end <= p.end
    own = {}
    for a, b, sp in _spans().innermost(stacked):
        own[sp.id] = own.get(sp.id, 0) + b - a
    kids = {}
    for s in stacked:
        if s.parent is not None:
            kids[s.parent] = kids.get(s.parent, 0) + s.dur
    for s in stacked:
        assert own.get(s.id, 0) == s.dur - kids.get(s.id, 0)
    for s in recs:
        if s.name in ("backend.segment", "backend.decode_step"):
            assert s.attrs["live"] >= 1 and s.attrs["rows"] >= 1
    # by hand: a tracer's own stack
    tr = Tracer()
    tr.enable()
    with tr.span("outer") as o:
        with tr.span("inner", 7, rows=2) as i:
            pass
        tr.record("waited", o.start, i.end, rid=7)
    recs = tr.records()
    assert [s.name for s in recs] == ["inner", "waited", "outer"]
    assert i.parent == o.id and o.parent is None and recs[1].parent == o.id
    assert i.rid == 7 and i.attrs == {"rows": 2} and recs[1].tid is None
    tr.disable()
    assert len(tr.records()) == 3  # readable once off
    tr.enable()
    assert tr.records() == [] and tr.anchor is not None


def _span(i, name, start, end, parent=None):
    return Span(i, parent, 1, name, None, start, end, None)


def test_idle_split_sums_to_the_idle_time_with_a_residual():
    S = _spans()
    # turn [0, 100) holds launch [10, 40) and sync [50, 60); a second turn
    # [120, 150); nothing open over [100, 120) and [150, 160)
    spans = [_span(1, "engine.turn", 0, 100), _span(2, "backend.launch",
                                                    10, 40, 1),
             _span(3, "backend.sync", 50, 60, 1),
             _span(4, "engine.turn", 120, 150)]
    busy = [(20, 30), (55, 58), (58, 70), (140, 200)]
    by, residual = S.idle_by_span(spans, busy, 0, 160)
    assert by == {"engine.turn": 10 + 10 + 30 + 20, "backend.launch": 20,
                  "backend.sync": 5}
    assert residual == 20
    idle = sum(b - a for a, b in S.idle_intervals(busy, 0, 160))
    assert sum(by.values()) + residual == idle == 160 - 10 - 15 - 20
    sh = S.idle_shares(by, residual, 160)
    assert sh["launch"] == pytest.approx(100 * 20 / 160)
    assert sh["host_loop"] == pytest.approx(100 * 70 / 160)
    assert sum(sh.values()) == pytest.approx(100 * idle / 160)
    # a gap across three spans is split three ways
    by, residual = S.idle_by_span(spans, [], 5, 55)
    assert by == {"engine.turn": 15, "backend.launch": 30,
                  "backend.sync": 5} and residual == 0


def test_anchor_maps_spans_onto_the_profiler_clock():
    from torch.profiler import ProfilerActivity, profile, record_function
    S = _spans()
    tr = Tracer()
    with record_function("warm"):  # the first range pays its set-up
        torch.ones(3).sum()
    tr.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        time.sleep(0.005)
        with tr.span("mine") as sp:
            with record_function("mine"):
                torch.ones(8).sum()
        time.sleep(0.005)
    off = S.profiler_offset_ns(S.trace_start_ns(prof), tr.anchor)
    ev = [e for e in prof.events() if e.name == "mine"]
    assert len(ev) == 1
    assert abs(off + ev[0].time_range.start * 1000 - sp.start) < 1e6


def test_self_time_shares_and_queue_beside_a_reactive_prefill():
    S = _spans()
    spans = [_span(1, "engine.turn", 0, 100), _span(2, "backend.launch",
                                                    10, 40, 1),
             _span(3, "backend.sync", 50, 60, 1),
             _span(4, "engine.turn", 120, 150)]
    sh = S.self_shares(spans, 0, 160)
    assert sh == pytest.approx({"launch": 100 * 30 / 160,
                                "sync": 100 * 10 / 160,
                                "host_loop": 100 * 90 / 160,
                                "residual": 100 * 30 / 160})
    assert S.self_shares(spans, 20, 60)["launch"] == pytest.approx(50)
    # flow 2 queues over [5, 30) while flow 1 prefills over [10, 30)
    flows = [Span(i, None, None, n, rid, a, b, {"reactive": 1})
             for i, (n, rid, a, b) in enumerate(
                 [(FLOW[1], 1, 0, 10), (FLOW[2], 1, 10, 30),
                  (FLOW[1], 2, 5, 30), (FLOW[2], 2, 30, 40)])]
    assert S.queue_overlap(flows, [2]) == pytest.approx(20 / 25)
    assert S.queue_overlap(flows, [1, 2]) == pytest.approx(20 / 35)
