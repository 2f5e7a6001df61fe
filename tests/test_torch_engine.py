"""PyTorch port: the real engine against the JAX reference engine on the same
weights and trace (prefix cache off on both sides, since the port has none
yet): identical token streams, kernel-completion traces and device-call /
host-sync counters, including a reactive flow submitted mid-run from an
``on_token`` callback; for the recurrent families also the reference's
elastic-decode exactness on a windowed hybrid (elastic == full pool == the
unscheduled reference)."""
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
COUNTERS = ("decode_device_calls", "host_syncs", "fused_steps",
            "fused_runs", "decode_segments", "aborted_runs", "aborted_steps",
            "prefill_device_calls", "prefill_host_syncs", "jit_compilations",
            "kv_bytes_prefill", "kv_bytes_decode", "decode_rows",
            "decode_kv_limit", "pool_slots", "free_slots",
            "quant_scale_bytes")


def _flows(vocab):
    rng = np.random.default_rng(7)
    spec = [(0, 0.0, 20, False), (1, 0.0, 26, False), (2, 0.01, 14, False),
            (3, 0.0, 11, True)]  # id 3: reactive, submitted mid-run
    return [(i, t, rng.integers(0, vocab, (1, p)), late)
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


@pytest.mark.parametrize("arch,kw", [
    (ARCH, {}),
    (ARCH, {"kv_dtype": "int8"}),
    (ARCH, {"max_fused_steps": 1}),
    ("qwen2-moe-a2.7b", {}),
    ("qwen2-moe-a2.7b", {"max_fused_steps": 1}),
    ("recurrentgemma-9b", {}),
    ("recurrentgemma-9b", {"kv_dtype": "int8"}),
    (TAIL, {}),
    (TAIL, {"max_fused_steps": 1}),
    ("rwkv6-1.6b", {}),
    ("rwkv6-1.6b", {"max_fused_steps": 1}),
], ids=["fused", "int8", "per_step", "moe_fused", "moe_per_step",
        "rglru_fused", "rglru_int8", "rglru_tail_fused",
        "rglru_tail_per_step", "rwkv6_fused", "rwkv6_per_step"])
def test_engine_matches_reference(arch, kw):
    jcfg, tcfg = tiny(j_tiny, arch), tiny(t_tiny, arch)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = module_from_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, jp)))
    flows = _flows(jcfg.vocab_size)
    jeng = JEngine(jcfg, jp, max_len=128, prefix_cache=False,
                   dual_device=False, **kw)
    teng = TEngine(tcfg, tp, max_len=128, device="cpu", **kw)
    jm, jseen = _serve(jeng, JRequest, JPriority, flows)
    before = dict(ops.LAUNCHES)
    tm, tseen = _serve(teng, TRequest, TPriority, flows)
    assert len(tm.completed) == len(jm.completed) == len(flows)
    for i, *_ in flows:
        assert teng.output_tokens(i) == jeng.output_tokens(i), f"flow {i}"
        assert len(teng.output_tokens(i)) == 10
    assert tseen == jseen
    assert teng.last_trace == jeng.last_trace
    js, ts = jeng.stats(), teng.stats()
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    assert set(js) - set(ts) <= {"prefix_nodes", "prefix_tokens",
                                 "prefix_capacity_tokens",
                                 "prefix_evictions", "prefix_inserts",
                                 "prefix_pinned_nodes"}
    assert teng.backend.validate() == []
    # CPU tensors never reach a kernel
    assert ops.LAUNCHES == before
    if "max_fused_steps" not in kw:
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
    arch = "recurrentgemma-9b"
    jcfg, tcfg = j_tiny(arch), t_tiny(arch)
    assert tcfg.sliding_window == 32
    jp = j_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = module_from_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, jp)))
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


@pytest.mark.parametrize("kw", [{"prefix_cache_tokens": 64},
                                {"prefix_block": 4}])
def test_prefix_cache_size_knobs_are_not_accepted(kw):
    """The prefix cache is not ported, so its size knobs do not exist: the
    backend refuses them instead of ignoring them."""
    from repro_torch.core.backend import TorchRealBackend
    cfg = t_tiny(ARCH)
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    with pytest.raises(TypeError, match=next(iter(kw))):
        TorchRealBackend(cfg, params, pool_slots=2, device="cpu", **kw)


@pytest.mark.parametrize("kw", [{"prefix_cache": True},
                                {"faults": object()},
                                {"dual_device": True},
                                {"device_resident": False},
                                {"in_pool_prefill": False}])
def test_unported_knobs_raise_naming_roadmap(kw):
    cfg = t_tiny(ARCH)
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TEngine(cfg, params, device="cpu", **kw)


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
