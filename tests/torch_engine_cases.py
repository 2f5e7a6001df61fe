"""The engine-level parity case shared by tests/test_torch_engine.py and
tests/test_torch_moe.py: the reference's tiny weights carried across, a
four-flow trace with a reactive flow submitted mid-run from an
``on_token`` callback, and the port's real engine held to the reference's
on it (token streams, kernel-completion trace, every ``stats()`` key and
every value but VALUE_EXEMPT)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np

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
from repro_torch.models import from_jax_params, module_from_state_dict
from torch_recurrent_cases import tiny

# stats() values that differ by nature: the name of each side's kernel
# route ("xla" vs "cuda"), and a ratio of two wall-clock times
VALUE_EXEMPT = {"kernel_backend", "co_execution_decode_slowdown_measured"}


@functools.lru_cache(maxsize=None)
def weights(arch):
    """The reference's tiny weights of ``arch`` and their port (the engines
    never write their params, so one pair serves every test)."""
    jcfg, tcfg = tiny(j_tiny, arch), tiny(t_tiny, arch)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = module_from_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, jp)))
    return jcfg, jp, tcfg, tp


def assert_stats_equal(ts, js):
    assert set(ts) == set(js)
    assert {k: v for k, v in ts.items() if k not in VALUE_EXEMPT} \
        == {k: v for k, v in js.items() if k not in VALUE_EXEMPT}


def flows(vocab, shared=0):
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


def serve(engine, req_cls, prio, flows, out_tokens=10):
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


def engine_matches_reference(arch, kw, shared):
    """Without a shared prefix the cache is off on both sides (random
    prompts over a tiny vocabulary can share a first token, which the
    reference, run without the cache, must not turn into hits); with one,
    both sides run their default, the cache on.  recurrentgemma fails
    ``prefix_reuse_supported`` and serves cold on both sides.  The
    scratch-cache (``in_pool_prefill=False``) and pre-donation
    (``device_resident=False``) baselines bind every prompt with one
    full-row scatter; the latter fuses no decode run."""
    jcfg, jp, tcfg, tp = weights(arch)
    trace = flows(jcfg.vocab_size, shared)
    cache = dict(prefix_cache=False) if not shared else {}
    jeng = JEngine(jcfg, jp, max_len=128, dual_device=False, **cache, **kw)
    teng = TEngine(tcfg, tp, max_len=128, device="cpu", **cache, **kw)
    jm, jseen = serve(jeng, JRequest, JPriority, trace)
    before = dict(ops.LAUNCHES)
    tm, tseen = serve(teng, TRequest, TPriority, trace)
    assert len(tm.completed) == len(jm.completed) == len(trace)
    for i, *_ in trace:
        assert teng.output_tokens(i) == jeng.output_tokens(i), f"flow {i}"
        assert len(teng.output_tokens(i)) == 10
    assert tseen == jseen
    assert teng.last_trace == jeng.last_trace
    ts = teng.stats()
    assert_stats_equal(ts, jeng.stats())
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
        assert ts["bind_device_calls"] == len(trace)
        assert ts["kv_bytes_prefill"] > 0
    if kw.get("device_resident", True) is False:
        assert ts["fused_steps"] == 0
    elif "max_fused_steps" not in kw and not shared:
        assert ts["fused_steps"] > 0
        # the reference's scheduler aborts no fused run of this trace for
        # rwkv6 (no attention kernels: the reactive prefill rides beside
        # decode); every other arch's trace covers an abort
        assert ts["aborted_runs"] > 0 or arch == "rwkv6-1.6b"
