"""PyTorch port: the copied scheduling layer makes the reference's decisions,
the training substrate (data pipeline, schedule, AdamW, checkpoints, the
loop and its launcher) matches the reference's, the port stands alone
(no ``jax``, no ``repro`` import), and the serving layer on top of the real
engine behaves as the reference's: mirrors of tests/test_faults.py's
real-backend tests and of tests/test_frontend.py, and the serving
launcher's summaries."""
import copy
import functools
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import AgentXPUEngine, WorkloadConfig, generate_workload
from repro.core.backend import _pow2_buckets
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import AgentXPUEngine as TAgentXPUEngine
from repro_torch.core import WorkloadConfig as TWorkloadConfig
from repro_torch.core import generate_workload as t_generate_workload
from repro_torch.core.backend import _pow2_buckets as t_pow2_buckets


@pytest.mark.parametrize("scheduler", ["agent.xpu", "continuous_batching"])
def test_sim_trace_and_summary_match_reference(scheduler):
    wl = dict(proactive_rate=1.0, horizon=30.0, seed=0)
    ref = AgentXPUEngine(get_config("llama3.2-3b"), scheduler=scheduler)
    port = TAgentXPUEngine(t_get_config("llama3.2-3b"), scheduler=scheduler)
    m_ref = ref.run_trace(generate_workload(WorkloadConfig(**wl)))
    m_port = port.run_trace(t_generate_workload(TWorkloadConfig(**wl)))
    assert len(m_port.completed) == len(m_ref.completed) > 0
    assert port.last_trace == ref.last_trace
    assert m_port.summary() == m_ref.summary()


def test_pow2_buckets_match_reference():
    for n in (0, 1, 3, 96, 100, 1023):
        assert t_pow2_buckets(n) == _pow2_buckets(n)


def test_port_imports_neither_jax_nor_repro():
    """Every repro_torch module imports (``models/moe.py``,
    ``models/ssm.py``, the trainer, the data pipeline and the train
    launcher among them), the four ``examples/*_torch.py`` files load, CPU
    serves of a dense, an MoE, an RG-LRU hybrid
    and an RWKV6 model run, and a tiny train step runs, with ``jax`` and
    ``repro`` blocked in ``sys.meta_path``."""
    script = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "repro"):
            raise ImportError(f"{name} import blocked in the port")
        return None
sys.meta_path.insert(0, Block())

import importlib, pkgutil
import numpy as np
import torch
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
assert {"repro_torch.models.moe", "repro_torch.models.ssm",
        "repro_torch.train.train_loop", "repro_torch.train.optimizer",
        "repro_torch.train.checkpoint", "repro_torch.data.pipeline",
        "repro_torch.launch.train", "repro_torch.launch.serve",
        "repro_torch.launch.frontend"} <= set(sys.modules)
import importlib.util
for name in EXAMPLES:
    spec = importlib.util.spec_from_file_location(
        name, f"examples/{name}.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))

from repro_torch.configs import get_tiny_config
from repro_torch.core import Priority, Request
from repro_torch.core.engine import RealAgentXPUEngine
from repro_torch.models import init_params

for arch in ("llama3.2-3b", "qwen2-moe-a2.7b", "recurrentgemma-9b",
             "rwkv6-1.6b"):
    cfg = get_tiny_config(arch)
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    eng = RealAgentXPUEngine(cfg, params, max_len=64, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(id=i, priority=Priority.PROACTIVE, prompt_len=9 + i,
                    max_new_tokens=4, arrival_time=0.0,
                    tokens=rng.integers(0, cfg.vocab_size, (1, 9 + i)))
            for i in range(2)]
    m = eng.serve(reqs)
    assert len(m.completed) == 2, arch
    assert all(len(eng.output_tokens(r.id)) == 4 for r in reqs), arch

from repro_torch.data.pipeline import PipelineConfig, batches
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_loop import make_train_step
cfg = get_tiny_config("llama3.2-3b")
params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
step = make_train_step(cfg, AdamWConfig(warmup_steps=1, total_steps=2))
batch = next(batches(PipelineConfig(batch_size=2, seq_len=16)))
params, opt, met = step(params, init_opt_state(params), batch)
assert int(opt.step) == 1 and bool(torch.isfinite(met["loss"]))
assert not any(k.split(".")[0] in ("jax", "repro") for k in sys.modules)
print("OK")
"""
    env = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"}
    env.update({k: os.environ[k] for k in ("HOME", "TMPDIR")
                if k in os.environ})
    script = f"EXAMPLES = {EXAMPLES!r}\n" + script
    out = subprocess.run([sys.executable, "-c", script],
                         capture_output=True, text=True, env=env,
                         cwd=__file__.rsplit("/", 2)[0], timeout=300)
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout


# -- the examples over the port ----------------------------------------------
# Each runs as a user runs it, in a subprocess with ``--device cpu`` at tiny
# size (their defaults where they are small); the serving examples' reports
# are read back.  With no GPU visible, ``--device cuda`` (the default)
# raises.
EXAMPLES = ("quickstart_torch", "serve_agentic_torch",
            "mixed_workload_demo_torch", "train_tiny_torch")


def _example(name, *args, gpus=None):
    # two intra-op threads: beside the suite's other workers an example's
    # torch would otherwise start one thread a core and spend its time in
    # their contention (164 s for a 6 s run)
    env = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "2"}
    env.update({k: os.environ[k] for k in ("HOME", "TMPDIR")
                if k in os.environ})
    if gpus is not None:
        env["CUDA_VISIBLE_DEVICES"] = gpus
    return subprocess.run([sys.executable, f"examples/{name}.py", *args],
                          capture_output=True, text=True, env=env,
                          cwd=__file__.rsplit("/", 2)[0], timeout=300)


def _report(out, label):
    """The integers of the report line that starts with ``label``."""
    line = next(ln for ln in out.splitlines() if ln.startswith(label))
    return [int(x) for x in re.findall(r"(?<![\d.])\d+(?![\d.])", line)]


def test_quickstart_example_trains_then_serves_on_cpu():
    out = _example("quickstart_torch", "--device", "cpu", "--steps", "20",
                   "--batch", "4", "--seq", "48")
    assert out.returncode == 0, out.stderr
    first, last = (float(x) for x in next(
        ln for ln in out.stdout.splitlines() if ln.startswith("loss:")
    )[len("loss:"):].split("->"))
    assert last < first
    assert "[PROACTIVE] 'the scheduler '" in out.stdout
    assert "[REACTIVE] 'agent 7 schedules a '" in out.stdout


@pytest.mark.parametrize("args", [(), ("--inject-mid-stream", "--stream",
                                       "--kernel-backend", "plain")],
                         ids=["fused", "inject_plain"])
def test_serve_agentic_example_report_on_cpu(args):
    """Tiny qwen2-moe-a2.7b: every flow completes; in the fused default the
    decode device calls and host syncs stay below the decode tokens, and
    every slot is free at exit."""
    out = _example("serve_agentic_torch", "--device", "cpu", *args)
    assert out.returncode == 0, out.stderr
    assert "serving tiny qwen2-moe-a2.7b" in out.stdout
    n = _report(out.stdout, "retired")
    assert n[0] == n[1] == 7
    calls, tokens, slots = _report(out.stdout, "decode device calls")
    syncs = _report(out.stdout, "host syncs")[0]
    assert 0 < calls < tokens and 0 < syncs < tokens
    assert _report(out.stdout, "prefix reuse")[0] > 0
    assert "kernel backend " + ("plain" if args else "cuda") in out.stdout
    assert f"{slots}/{slots} slots free at exit" in out.stdout
    if "--stream" in args:
        assert "[stream] req 6 [reactive ] token" in out.stdout


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "recurrentgemma-9b",
                                  "rwkv6-1.6b"])
def test_train_tiny_example_trains_each_family_on_cpu(arch, tmp_path):
    out = _example("train_tiny_torch", "--arch", arch, "--device", "cpu",
                   "--steps", "3", "--log-every", "1", "--batch", "2",
                   "--seq", "40", "--ckpt-dir", str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert f"arch={arch}-tiny" in out.stdout and "[train] done" in out.stdout
    assert os.path.exists(tmp_path / "step_00000003.npz")


def test_mixed_workload_demo_example_on_cpu_and_refuses_missing_gpu():
    out = _example("mixed_workload_demo_torch", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    rows = [ln.split() for ln in out.stdout.splitlines()[1:] if ln.strip()]
    assert [r[0] for r in rows] == [
        "agent.xpu", "fcfs", "naive_preempt", "timeshare",
        "continuous_batching"] * 3
    refused = _example("mixed_workload_demo_torch", gpus="")
    assert refused.returncode != 0
    assert "no GPU is visible" in refused.stderr



# -- the training substrate ---------------------------------------------------
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_pipeline_batches_match_reference(seed):
    from repro.data.pipeline import PipelineConfig, batches
    from repro_torch.data.pipeline import PipelineConfig as TPipelineConfig
    from repro_torch.data.pipeline import batches as t_batches
    kw = dict(batch_size=3, seq_len=40, seed=seed, vocab_size=200)
    ref, port = batches(PipelineConfig(**kw)), t_batches(TPipelineConfig(**kw))
    for _ in range(3):
        a, b = next(ref)["tokens"], next(port)["tokens"]
        assert a.dtype == b.dtype and a.shape == (3, 41)
        np.testing.assert_array_equal(a, b)


def test_lr_schedule_matches_reference():
    from repro.train.optimizer import AdamWConfig, lr_at
    from repro_torch.train.optimizer import AdamWConfig as TAdamWConfig
    from repro_torch.train.optimizer import lr_at as t_lr_at
    kw = dict(lr=1e-3, warmup_steps=10, total_steps=100)
    steps = [0, 1, 5, 9, 10, 11, 40, 50, 99, 100, 150]
    want = [float(lr_at(AdamWConfig(**kw), jnp.asarray(s))) for s in steps]
    got = [float(t_lr_at(TAdamWConfig(**kw), torch.tensor(s)))
           for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] < got[3] <= got[4] and got[4] >= got[7] >= got[8]


def _tiny_train_weights(dtype=jnp.float32):
    from repro import models as J
    from repro.configs import get_tiny_config
    from repro_torch.configs import get_tiny_config as t_tiny
    cfg = get_tiny_config("qwen2.5-32b").with_overrides(vocab_size=259)
    jp = jax.tree_util.tree_map(
        np.asarray, J.init_params(cfg, jax.random.PRNGKey(0), dtype))
    return cfg, t_tiny("qwen2.5-32b").with_overrides(vocab_size=259), jp


def _flat(tree):
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_leaves_with_path(tree)}


def test_adamw_update_matches_reference():
    """Two AdamW steps from the same f32 parameters with the same
    (JAX-computed) gradients: parameters and moments within 1e-6, the
    step, lr and clipped global norm alike.  The second step's gradients
    are large enough to be clipped."""
    from repro.train.optimizer import AdamWConfig, adamw_update, \
        init_opt_state
    from repro.train.train_loop import lm_loss
    from repro_torch.models import module_from_state_dict, from_jax_params
    from repro_torch.train import optimizer as O
    cfg, _, jp = _tiny_train_weights()
    toks = jnp.asarray(np.random.default_rng(0).integers(
        0, 259, (2, 17), dtype=np.int32))
    oc = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    jstate, tp = init_opt_state(jp), module_from_state_dict(
        from_jax_params(jp))
    tstate = O.init_opt_state(tp)
    grad = jax.jit(jax.grad(lambda p: lm_loss(cfg, p, toks)[0]))
    for mult in (1.0, 40.0):
        jg = grad(jp)
        jg = jax.tree_util.tree_map(lambda g: g * mult, jg)
        tg = {k: torch.from_numpy(np.array(v)) for k, v in _flat(jg).items()}
        jp, jstate, jmet = adamw_update(AdamWConfig(**oc), jp, jg, jstate)
        tp, tstate, tmet = O.adamw_update(O.AdamWConfig(**oc), tp, tg,
                                          tstate)
        assert int(tstate.step) == int(jstate.step)
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-6)
        want = _flat(jp)
        for name, p in tp.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[name], rtol=1e-6,
                                       atol=1e-6, err_msg=name)
        for part in ("m", "v"):
            want = _flat(getattr(jstate, part))
            for name, t in getattr(tstate, part).items():
                np.testing.assert_allclose(t.numpy(), want[name], rtol=1e-6,
                                           atol=1e-9, err_msg=name)
    assert float(jmet["grad_norm"]) > 1.0  # the clipping ran


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_checkpoints_restore_across_frameworks(tmp_path, dtype):
    """A JAX checkpoint restores in the port and a port checkpoint in JAX,
    every leaf bit for bit (bf16 through its uint16 view), with the
    optimizer's step and moments."""
    from repro.train import checkpoint as JC
    from repro.train.optimizer import init_opt_state
    from repro_torch.models import module_from_state_dict, from_jax_params
    from repro_torch.train import checkpoint as TC
    from repro_torch.train import optimizer as O
    _, tcfg, jp = _tiny_train_weights(dtype)
    rng = np.random.default_rng(1)
    jopt = init_opt_state(jp)
    jopt = jopt._replace(
        step=jnp.asarray(7, jnp.int32),
        m=jax.tree_util.tree_map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32),
            jopt.m))

    def bits(x):
        x = np.asarray(x)
        return x.view(np.uint16) if x.dtype.itemsize == 2 else x

    # JAX -> port
    JC.save_checkpoint(str(tmp_path / "j"), 3, jp, jopt)
    tp = module_from_state_dict(from_jax_params(jp))
    with torch.no_grad():
        for p in tp.parameters():
            p.zero_()
    topt = O.init_opt_state(tp)
    tp, topt, step = TC.restore_checkpoint(
        TC.latest_checkpoint(str(tmp_path / "j")), tp, topt)
    assert step == 3 and int(topt.step) == 7
    want = _flat(jp)
    for name, p in tp.state_dict().items():
        got = p.view(torch.int16).numpy() if p.dtype == torch.bfloat16 \
            else p.numpy()
        np.testing.assert_array_equal(bits(got), bits(want[name]))
    m = _flat(jopt.m)
    assert all(np.array_equal(t.numpy(), m[n]) for n, t in topt.m.items())
    # port -> JAX
    TC.save_checkpoint(str(tmp_path / "t"), 5, tp, topt)
    path = JC.latest_checkpoint(str(tmp_path / "t"))
    assert path.endswith("step_00000005.npz")
    p2, o2, step = JC.restore_checkpoint(path, jp, jopt)
    assert step == 5 and int(o2.step) == 7
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(p2)):
        np.testing.assert_array_equal(bits(a), bits(b))
    for a, b in zip(jax.tree_util.tree_leaves(jopt.m),
                    jax.tree_util.tree_leaves(o2.m)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_tiny_train_loss_decreases(backend):
    """The reference's test_loss_decreases on the port: tiny starcoder2
    (window, qkv bias, GELU MLP), 12 AdamW steps on the synthetic corpus."""
    from repro_torch.configs import get_tiny_config
    from repro_torch.data.pipeline import PipelineConfig, batches
    from repro_torch.models import init_params
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import train
    cfg = get_tiny_config("starcoder2-7b").with_overrides(vocab_size=259)
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    _, _, hist = train(cfg, params, batches(PipelineConfig(batch_size=4,
                                                           seq_len=48)),
                       AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=30),
                       12, log_every=4, log_fn=lambda *_: None,
                       kernel_backend=backend)
    assert len(hist) == 4
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_train_launcher_checkpoints_and_resumes(tmp_path):
    """``python -m repro_torch.launch.train --tiny --device cpu`` trains,
    writes its checkpoint, and a second run resumes from it."""
    ck = str(tmp_path / "ck")
    env = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"}
    env.update({k: os.environ[k] for k in ("HOME", "TMPDIR")
                if k in os.environ})

    def run(*extra):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "llama3.2-3b", "--tiny", "--device", "cpu", "--batch", "2",
             "--seq", "16", "--log-every", "1", "--ckpt-dir", ck, *extra],
            capture_output=True, text=True, env=env,
            cwd=__file__.rsplit("/", 2)[0], timeout=300)
        assert out.returncode == 0, out.stderr
        return out.stdout

    first = run("--steps", "2")
    assert "step     1" in first and "[train] done" in first
    assert os.path.exists(os.path.join(ck, "step_00000002.npz"))
    second = run("--steps", "3", "--resume")
    assert "(step 2)" in second and "step     2" in second
    assert "step     1" not in second
    assert os.path.exists(os.path.join(ck, "step_00000003.npz"))


# -- mirrors of tests/test_faults.py's real-backend tests ----------------------
# The same faults injected into the reference's engine and the port's, on
# the same weights and requests: terminal statuses, fault strings, tokens
# (partial outputs included) and every stats() value must be equal.
@functools.lru_cache(maxsize=None)
def _llama():
    """Tiny llama3-405b weights of the reference and their port."""
    from repro.configs import get_tiny_config
    from repro.models import init_params
    from repro_torch.models import from_jax_params, module_from_state_dict
    cfg = get_tiny_config("llama3-405b")
    jp = init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    tp = module_from_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, jp)))
    return cfg, jp, tp


def _fault_engines(faults=None, **kw):
    """(reference engine, port engine) as tests/test_faults.py builds them
    (max_len 128, strict invariants on), each with its own injector from
    the ``faults`` list of ``Fault`` keyword dicts."""
    from repro.core.engine import RealAgentXPUEngine as JEngine
    from repro.core.faults import Fault as JFault
    from repro.core.faults import FaultInjector as JInjector
    from repro_torch.configs import get_tiny_config
    from repro_torch.core.engine import RealAgentXPUEngine as TEngine
    from repro_torch.core.faults import Fault as TFault
    from repro_torch.core.faults import FaultInjector as TInjector
    cfg, jp, tp = _llama()
    kw.setdefault("strict_invariants", True)
    jf = tf = None
    if faults is not None:
        jf = JInjector([JFault(**f) for f in faults])
        tf = TInjector([TFault(**f) for f in faults])
    return (JEngine(cfg, jp, max_len=128, dual_device=False, faults=jf,
                    **kw),
            TEngine(get_tiny_config("llama3-405b"), tp, max_len=128,
                    device="cpu", faults=tf, **kw))


def _fault_reqs(rng_seed, arrivals, prompt_lens, out_tokens, reactive=(),
                shared=0):
    """test_faults.py's ``_mk_requests`` (or, with ``shared``, its shared
    prefix trace) for both packages: (reference requests, port requests)."""
    from repro.core import Priority as JP
    from repro.core import Request as JR
    from repro_torch.core import Priority as TP
    from repro_torch.core import Request as TR
    vocab = _llama()[0].vocab_size
    rng = np.random.default_rng(rng_seed)
    system = rng.integers(0, vocab, (1, shared))
    toks = [np.concatenate([system, rng.integers(0, vocab, (1, p))], axis=1)
            for p in prompt_lens]
    return [[R(id=i, priority=P.REACTIVE if i in reactive else P.PROACTIVE,
               prompt_len=t.shape[1], max_new_tokens=out_tokens,
               arrival_time=a, tokens=t.copy())
             for i, (a, t) in enumerate(zip(arrivals, toks))]
            for R, P in ((JR, JP), (TR, TP))]


@pytest.mark.parametrize("cap", [2, 3])
def test_store_rows_count_toward_the_pool_cap_as_in_reference(cap):
    """Four flows sharing a 32-token system prompt, one after another
    (each after the one before completes, on the scheduler's clock)
    through a pool capped at ``cap``: each binds the slot its donor held,
    so the donor is promoted to the snapshot store and the hit pasted from
    it.  The store's rows count toward the cap when a flow arrives, in the
    reference and the port alike, which ``SimBackend`` does not model: at
    a cap of 2 the fourth arrival evicts the unpinned prefixes and misses
    the hit the simulation predicts; at 3 all three agree."""
    from repro_torch.configs import get_tiny_config
    from repro_torch.core import AgentXPUEngine as TEngine
    from repro_torch.core.backend import SimBackend
    tcfg = get_tiny_config("llama3-405b")

    def sim(reqs, hot):
        eng = TEngine(tcfg, pool_slots_max=cap)
        eng.backend = SimBackend(prefix_cache=hot, max_len=128)
        return eng, eng.run_trace(copy.deepcopy(reqs))
    arrivals = [0.0]
    for k in range(1, 4):
        reqs = _fault_reqs(5, arrivals, [20, 11, 17, 9][:k], 4, shared=32)[1]
        _, m = sim(reqs, hot=False)
        arrivals.append(max(r.finish_t for r in m.completed) + 0.01)
    reqs = _fault_reqs(5, arrivals, [20, 11, 17, 9], 4, shared=32)
    predicted = sim(reqs[1], hot=True)[0].backend.stats()["prefix_hits"]
    jeng, teng = _fault_engines(pool_slots_max=cap)
    _serve_faulty(jeng, teng, reqs)
    st = teng.stats()
    assert predicted == 3 and st["prefix_promotions"] >= 1
    assert st["prefix_hits"] == (2 if cap == 2 else 3)


def _serve_faulty(jeng, teng, reqs, hook=None):
    """Serve each side's requests (with ``hook`` as every flow's on_token)
    and hold the port to the reference.  Returns the port's metrics."""
    out = []
    for eng, rs in zip((jeng, teng), reqs):
        for r in rs:
            eng.submit(r, on_token=hook)
        out.append(eng.run())
    jm, tm = out
    by = [{r.id: (r.terminal_status, r.fault) for r in m.completed}
          for m in out]
    assert by[1] == by[0]
    ids = [r.id for r in reqs[1]]
    assert [teng.output_tokens(i) for i in ids] == \
        [jeng.output_tokens(i) for i in ids]
    ts, js = teng.stats(), jeng.stats()
    assert set(ts) == set(js)
    exempt = {"kernel_backend", "co_execution_decode_slowdown_measured"}
    assert {k: v for k, v in ts.items() if k not in exempt} == \
        {k: v for k, v in js.items() if k not in exempt}
    for k in ("deadline_aborts", "fault_quarantines"):
        assert getattr(teng.last_sched, k) == getattr(jeng.last_sched, k)
    _assert_no_leaks(teng.backend)
    return tm


def _assert_no_leaks(backend):
    assert backend.validate() == []
    assert not backend._slot
    assert len(backend._free) == backend.pool_slots


def _raise_at(victim, after, msg):
    def boom(req, tok):
        if req.id == victim and req.decoded >= after:
            raise RuntimeError(msg)
    return boom


def test_hook_exception_quarantines_one_flow():
    jeng, teng = _fault_engines(decode_segment_steps=2)
    m = _serve_faulty(jeng, teng,
                      _fault_reqs(71, [0.0] * 3, [12, 14, 16], 10),
                      _raise_at(1, 3, "user callback exploded"))
    by_id = {r.id: r for r in m.completed}
    assert by_id[1].terminal_status == "failed"
    assert "hook" in by_id[1].fault and "exploded" in by_id[1].fault
    assert 1 <= len(teng.output_tokens(1)) < 10
    assert teng.stats()["quarantined_flows"] == 1


def test_transient_device_fault_replays_segment():
    jeng, teng = _fault_engines(
        [dict(site="device", stage="decode", nth=2),
         dict(site="device", stage="prefill", nth=1)],
        decode_segment_steps=2)
    m = _serve_faulty(jeng, teng, _fault_reqs(73, [0.0, 0.0], [12, 14], 8))
    st = teng.stats()
    assert st["device_fault_retries"] == 2 and st["quarantined_flows"] == 0
    assert all(r.terminal_status == "completed" for r in m.completed)


@pytest.mark.parametrize("stage,nth", [("prefill", 1), ("prefix_copy", 1)])
def test_permanent_device_fault_quarantines_only_victim(stage, nth):
    """A permanent device fault pinned to flow 1, mid-prefill-chunk or at
    its prefix-cache copy (the flows share a 16-token prefix)."""
    jeng, teng = _fault_engines([dict(site="device", stage=stage, nth=nth,
                                      req_id=1, transient=False)])
    m = _serve_faulty(jeng, teng,
                      _fault_reqs(79, [0.0, 0.002, 0.004], [12, 10, 14], 6,
                                  shared=16))
    by_id = {r.id: r for r in m.completed}
    assert by_id[1].terminal_status == "failed"
    assert "prefill" in by_id[1].fault
    assert by_id[0].terminal_status == by_id[2].terminal_status == \
        "completed"
    if stage == "prefix_copy":
        assert teng.stats()["prefix_hits"] >= 1


def test_fault_mid_fused_segment_keeps_survivor_rows():
    jeng, teng = _fault_engines(decode_segment_steps=2, max_fused_steps=32)
    m = _serve_faulty(jeng, teng,
                      _fault_reqs(83, [0.0] * 3, [12, 14, 16], 16),
                      _raise_at(0, 5, "mid-fused hook fault"))
    assert teng.stats()["fused_runs"] > 0
    assert {r.id: r.terminal_status for r in m.completed} == {
        0: "failed", 1: "completed", 2: "completed"}


def test_fault_at_finish_forces_cleanup_through():
    jeng, teng = _fault_engines([dict(site="device", stage="finish", nth=1,
                                      transient=False)])
    m = _serve_faulty(jeng, teng, _fault_reqs(89, [0.0], [12], 4))
    assert m.completed[0].terminal_status == "completed"
    assert teng.stats()["flow_faults"] == 1  # counted, not raised


def test_alloc_fault_is_flow_attributable():
    jeng, teng = _fault_engines([dict(site="alloc", req_id=1)])
    m = _serve_faulty(jeng, teng, _fault_reqs(97, [0.0, 0.0], [12, 14], 5))
    assert {r.id: r.terminal_status for r in m.completed} == {
        0: "completed", 1: "failed"}


def test_grow_pool_capped_raises_allocation_fault():
    from repro_torch.core.faults import AllocationFault
    jeng, teng = _fault_engines(pool_slots=1, pool_slots_max=1)
    with pytest.raises(AllocationFault, match="pool_slots_max") as got:
        teng.backend._grow_pool()
    with pytest.raises(Exception) as want:
        jeng.backend._grow_pool()
    assert str(got.value) == str(want.value)
    _, free = _fault_engines(pool_slots=1)
    free.backend._grow_pool()  # uncapped growth still doubles
    assert free.backend.pool_slots == 2 and free.backend.validate() == []


def test_deadline_abort_at_segment_boundary():
    """The victim's deadline lies two-thirds of the way through its
    fault-free decode (sim time is deterministic), so the abort lands
    mid-decode on both sides."""
    _, eng0 = _fault_engines(decode_segment_steps=2)
    reqs = _fault_reqs(101, [0.0, 0.0], [12, 14], 12)
    m0 = eng0.serve(copy.deepcopy(reqs[1]))
    v0 = {r.id: r for r in m0.completed}[1]
    deadline = v0.ttft + (v0.e2e_latency - v0.ttft) * 2 / 3
    for side in reqs:
        side[1].deadline = deadline
    jeng, teng = _fault_engines(decode_segment_steps=2)
    m = _serve_faulty(jeng, teng, reqs)
    assert {r.id: r.terminal_status for r in m.completed} == {
        0: "completed", 1: "timed_out"}
    assert 1 <= len(teng.output_tokens(1)) < 12
    assert teng.last_sched.deadline_aborts == 1


def test_legacy_raise_out_mode():
    jeng, teng = _fault_engines(isolate_flow_faults=False,
                                strict_invariants=False)
    reqs = _fault_reqs(103, [0.0], [12], 6)

    def boom(req, tok):
        raise RuntimeError("legacy raise-out")

    for eng, rs in zip((jeng, teng), reqs):
        eng.submit(rs[0], on_token=boom)
        with pytest.raises(RuntimeError, match="legacy raise-out"):
            eng.run()
    assert teng.output_tokens(0) == jeng.output_tokens(0)
    _assert_no_leaks(teng.backend)


def test_validate_catches_corruption():
    from repro_torch.core.faults import InvariantViolation
    jeng, teng = _fault_engines()
    for be in (teng.backend, jeng.backend):
        assert be.validate() == []
        be._free.append(0)  # a duplicate free slot
    assert teng.backend.validate() == jeng.backend.validate() != []
    with pytest.raises(InvariantViolation):
        teng.backend.validate(strict=True)
    teng.backend._free.remove(0)
    assert teng.backend.validate() == []


def test_standard_chaos_scenario():
    """Pool at cap, one hook fault, one transient device fault and one
    deadline expiry in one run."""
    jeng, teng = _fault_engines(
        [dict(site="device", stage="decode", nth=3),
         dict(site="deadline", req_id=4, nth=8, period=1)],
        decode_segment_steps=2, pool_slots=2, pool_slots_max=4,
        admission_queue_len=4)
    m = _serve_faulty(jeng, teng,
                      _fault_reqs(107, [0.002 * i for i in range(6)],
                                  [12, 14, 16, 12, 14, 16], 10,
                                  reactive=(5,)),
                      _raise_at(2, 2, "chaos hook fault"))
    st = teng.stats()
    assert {r.id: r.terminal_status for r in m.completed} == {
        0: "completed", 1: "completed", 2: "failed", 3: "completed",
        4: "timed_out", 5: "completed"}
    assert st["device_fault_retries"] >= 1 and st["pool_slots"] <= 4


# -- mirrors of tests/test_frontend.py on the port's engine --------------------
# Strict invariants on: the backend audits slot and pin accounting after
# every event-loop turn, so a cancel path that leaked fails here.
@pytest.fixture(scope="module")
def fe_engine():
    from repro_torch.configs import get_tiny_config
    from repro_torch.core.engine import RealAgentXPUEngine
    cfg = get_tiny_config("llama3-405b")
    eng = RealAgentXPUEngine(cfg, _llama()[2], max_len=128, device="cpu",
                             strict_invariants=True, max_fused_steps=8,
                             decode_segment_steps=2)
    return cfg, eng


def _prompt(cfg, seed=0, plen=12):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, plen))


def test_frontend_stream_and_result(fe_engine):
    from repro_torch.core.requests import Priority
    from repro_torch.launch.frontend import ServingFrontend
    cfg, eng = fe_engine
    with ServingFrontend(eng) as fe:
        h1 = fe.submit(_prompt(cfg, 1), priority=Priority.REACTIVE,
                       max_new_tokens=6)
        h2 = fe.submit(_prompt(cfg, 2), max_new_tokens=4)
        toks = list(h1.tokens(timeout=120))
        assert len(toks) == 6
        r1, r2 = h1.result(timeout=120), h2.result(timeout=120)
        assert r1["status"] == "completed" and r1["tokens"] == toks
        assert r2["status"] == "completed" and r2["n_tokens"] == 4
        assert len(r1["token_walls"]) == 6
        assert r1["token_walls"] == sorted(r1["token_walls"])
    _assert_no_leaks(eng.backend)


def test_frontend_streams_match_direct_serve(fe_engine):
    from repro_torch.core.requests import Priority, Request
    from repro_torch.launch.frontend import ServingFrontend
    cfg, eng = fe_engine
    p = _prompt(cfg, 3, plen=16)
    with ServingFrontend(eng) as fe:
        streamed = fe.submit(p, max_new_tokens=8).result(timeout=120)
    m = eng.serve([Request(id=777, priority=Priority.PROACTIVE,
                           prompt_len=16, max_new_tokens=8,
                           arrival_time=0.0, tokens=p.copy())])
    assert [r.id for r in m.completed] == [777]
    assert streamed["tokens"] == eng.output_tokens(777)
    _assert_no_leaks(eng.backend)


def test_frontend_cancel_mid_stream_releases_slot(fe_engine):
    from repro_torch.launch.frontend import ServingFrontend
    cfg, eng = fe_engine
    with ServingFrontend(eng) as fe:
        victim = fe.submit(_prompt(cfg, 4), max_new_tokens=96)
        assert victim.next_token(timeout=120) is not None
        victim.cancel()
        r = victim.result(timeout=120)
        assert r["status"] == "cancelled"
        assert 1 <= r["n_tokens"] < 96  # aborted at a segment boundary
        after = fe.submit(_prompt(cfg, 5), max_new_tokens=4)
        assert after.result(timeout=120)["status"] == "completed"
        assert fe.stats()["cancelled_flows"] >= 1
    _assert_no_leaks(eng.backend)


def test_frontend_cancel_before_dispatch(fe_engine):
    from repro_torch.launch.frontend import ServingFrontend
    cfg, eng = fe_engine
    fe = ServingFrontend(eng)  # NOT started: the inbox can only grow
    h = fe.submit(_prompt(cfg, 6), max_new_tokens=4)
    h.cancel()
    fe.start()
    assert h.result(timeout=120)["status"] == "cancelled"
    fe.close(timeout=120)
    _assert_no_leaks(eng.backend)


def test_frontend_backpressure_disconnects_slow_consumer(fe_engine):
    from repro_torch.launch.frontend import ServingFrontend
    cfg, eng = fe_engine
    with ServingFrontend(eng, max_buffered_tokens=4) as fe:
        slow = fe.submit(_prompt(cfg, 7), max_new_tokens=96)
        healthy = fe.submit(_prompt(cfg, 8), max_new_tokens=6)
        assert len(list(healthy.tokens(timeout=120))) == 6
        r = slow.result(timeout=120)
        assert r["status"] == "cancelled" and r["overflowed"]
        assert fe.stats()["backpressure_disconnects"] >= 1
        assert healthy.result(timeout=120)["status"] == "completed"
    _assert_no_leaks(eng.backend)


def test_frontend_graceful_drain_retires_everything(fe_engine):
    from repro_torch.core.requests import Priority
    from repro_torch.launch.frontend import FrontendClosed, ServingFrontend
    cfg, eng = fe_engine
    fe = ServingFrontend(eng).start()
    handles = [fe.submit(_prompt(cfg, 10 + i), max_new_tokens=4,
                         priority=Priority.REACTIVE if i % 3 == 0
                         else Priority.PROACTIVE)
               for i in range(7)]
    fe.drain(timeout=120)
    assert all(h.status == "completed" for h in handles)
    with pytest.raises(FrontendClosed):
        fe.submit(_prompt(cfg, 99), max_new_tokens=2)
    st = fe.stats()
    assert st["flows_submitted"] == st["flows_retired"] == 7
    assert st["flows_in_flight"] == 0
    fe.close(timeout=120)
    _assert_no_leaks(eng.backend)


def test_frontend_asyncio_consumption(fe_engine):
    import asyncio
    from repro_torch.launch.frontend import ServingFrontend
    cfg, eng = fe_engine

    async def one_flow(fe, seed, n):
        h = await fe.asubmit(_prompt(cfg, seed), max_new_tokens=n)
        got = []
        async for tok in h:
            got.append(tok)
        return h, got

    async def main(fe):
        return await asyncio.gather(*[one_flow(fe, 20 + i, 3 + i)
                                      for i in range(4)])

    with ServingFrontend(eng) as fe:
        results = asyncio.run(main(fe))
    for i, (h, got) in enumerate(results):
        assert h.status == "completed" and len(got) == 3 + i
    _assert_no_leaks(eng.backend)


def test_frontend_concurrent_submitters(fe_engine):
    import threading
    from repro_torch.launch.frontend import ServingFrontend
    cfg, eng = fe_engine
    out = {}
    with ServingFrontend(eng) as fe:
        def client(k):
            h = fe.submit(_prompt(cfg, 40 + k), max_new_tokens=3)
            out[k] = h.result(timeout=120)
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    assert sorted(out) == list(range(6))
    assert all(r["status"] == "completed" and r["n_tokens"] == 3
               for r in out.values())
    _assert_no_leaks(eng.backend)


def test_frontend_streams_match_reference_frontend():
    """The port's front end over the port's engine streams what the
    reference's front end streams over the reference's engine, flow for
    flow, on the same weights (three flows sharing a system prompt, one
    reactive)."""
    from repro.core.requests import Priority as JPriority
    from repro.launch.frontend import ServingFrontend as JFrontend
    from repro_torch.core.requests import Priority as TPriority
    from repro_torch.launch.frontend import ServingFrontend as TFrontend
    jeng, teng = _fault_engines(max_fused_steps=8, decode_segment_steps=2)
    cfg = _llama()[0]
    system = _prompt(cfg, 50, plen=20)
    prompts = [np.concatenate([system, _prompt(cfg, 51 + i, plen=6 + i)],
                              axis=1) for i in range(3)]
    streams = []
    for eng, fe_cls, prio in ((jeng, JFrontend, JPriority),
                              (teng, TFrontend, TPriority)):
        with fe_cls(eng) as fe:
            hs = [fe.submit(p, max_new_tokens=6,
                            priority=prio.REACTIVE if i == 2
                            else prio.PROACTIVE)
                  for i, p in enumerate(prompts)]
            streams.append([h.result(timeout=120)["tokens"] for h in hs])
    assert streams[1] == streams[0]
    assert all(len(s) == 6 for s in streams[1])
    _assert_no_leaks(teng.backend)


# -- the serving launcher -------------------------------------------------------
def _launcher_json(main, argv, capsys):
    main(argv + ["--json"])
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("scheduler", ["agent.xpu", "continuous_batching"])
def test_serve_launcher_sim_summary_matches_reference(scheduler, capsys):
    from repro.launch.serve import main as j_main
    from repro_torch.launch.serve import main as t_main
    argv = ["--scheduler", scheduler, "--rate", "1.0", "--horizon", "60"]
    want = _launcher_json(j_main, argv, capsys)
    assert want["n_completed"] > 0
    assert _launcher_json(t_main, argv, capsys) == want


def test_serve_launcher_real_cpu_summary_matches_reference(capsys):
    """``--real --device cpu`` against the reference's ``--real`` at a
    short horizon: the summary is on the scheduler's clock, and equal
    (its weights differ, the port's drawn from its own seeded generator,
    but no summary key depends on a token's value)."""
    from repro.launch.serve import main as j_main
    from repro_torch.launch.serve import main as t_main
    argv = ["--real", "--horizon", "10"]
    want = _launcher_json(j_main, argv, capsys)
    got = _launcher_json(t_main, argv + ["--device", "cpu"], capsys)
    assert got == want
    assert got["n_completed"] > 0 and got["prefix_hit_tokens"] > 0


def test_serve_launcher_real_needs_a_gpu_unless_asked_for_cpu():
    from repro_torch.launch.serve import main
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="no GPU"):
        main(["--real", "--horizon", "5"])


def test_serve_launcher_staged_prefill_on_cpu_lane(capsys):
    """``--real --device cpu --prefill-device 0``: prefill staged on the
    CPU lane (the staged code in order), the ``[real] dual device`` line
    printed, and the same summary as the reference's launcher given the
    same flags (on one JAX device, where it co-locates: staging is
    backend-local, so the scheduler's clock does not move)."""
    from repro.launch.serve import main as j_main
    from repro_torch.launch.serve import main as t_main
    argv = ["--real", "--horizon", "3", "--prefill-device", "0"]
    want = _launcher_json(j_main, argv, capsys)
    got = _launcher_json(t_main, argv + ["--device", "cpu"], capsys)
    assert got == want and got["n_completed"] > 0
    t_main(argv + ["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    dual = [ln for ln in lines if ln.startswith("[real] dual device:")]
    assert len(dual) == 1
    assert "prefill on cpu (in-order lane), decode on cpu" in dual[0]
    staged = int(dual[0].split(", ")[2].split()[0])
    assert staged > 0
    assert any("16 slots free at exit" in ln for ln in lines)


@pytest.mark.parametrize("flag", ["--no-device-resident",
                                  "--no-in-pool-prefill"])
def test_serve_launcher_baselines_on_cpu(flag, capsys):
    """The launcher's baseline flags run, and each prefill is bound with one
    full-row scatter, as the reference's."""
    from repro_torch.launch.serve import main as t_main
    t_main(["--real", "--horizon", "3", "--device", "cpu", flag])
    lines = capsys.readouterr().out.splitlines()
    prefill = next(ln for ln in lines if ln.startswith("[real] prefill:"))
    calls, syncs = (int(prefill.split(", ")[i].split()[0]) for i in (1, 2))
    assert calls == syncs > 0  # one bind scatter, one host sync a prompt
    fused = next(ln for ln in lines if "fused decode steps" in ln)
    assert (" 0 fused decode steps" in fused) == (flag ==
                                                   "--no-device-resident")


def test_serve_launcher_sim_mode_imports_no_torch():
    """Sim mode imports no torch, as the reference's imports no JAX."""
    script = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("torch", "jax", "repro"):
            raise ImportError(f"{name} import blocked in sim mode")
        return None
sys.meta_path.insert(0, Block())
from repro_torch.launch.serve import main
main(["--horizon", "30", "--json"])
print("OK")
"""
    env = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"}
    env.update({k: os.environ[k] for k in ("HOME", "TMPDIR")
                if k in os.environ})
    out = subprocess.run([sys.executable, "-c", script],
                         capture_output=True, text=True, env=env,
                         cwd=__file__.rsplit("/", 2)[0], timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.rstrip().endswith("OK")


# -- mirrors of tests/test_dual_device.py: stage-decoupled execution -----------
# The port's staged path runs on the CPU lane: an explicit prefill_device
# equal to the decode device runs the staged code in order, every line of
# it (staging cache, truncation, handoff_row, recycling, the sticky
# decisions and their fallbacks), where the reference needs two devices.
def _dual_engine(dual=True, **kw):
    """The port's engine on tiny llama3-405b (the reference's weights):
    staged prefill on the CPU lane, or (``dual=False``) one lane."""
    from repro_torch.configs import get_tiny_config
    from repro_torch.core.engine import RealAgentXPUEngine as TEngine
    lane = dict(dual_device=True, prefill_device="cpu") if dual \
        else dict(dual_device=False)
    return TEngine(get_tiny_config("llama3-405b"), _llama()[2],
                   device="cpu", **lane, **kw)


def _dual_backend(**kw):
    from repro_torch.configs import get_tiny_config
    from repro_torch.core.backend import DualDeviceBackend
    return DualDeviceBackend(get_tiny_config("llama3-405b"), _llama()[2],
                             device="cpu", prefill_device="cpu", **kw)


def _j_reference_tokens(prompt, n_out, max_len):
    """The reference's unscheduled batch-1 greedy tokens (its
    ``_reference_tokens``: ``models.prefill`` then one ``extend`` a
    token)."""
    from repro.models import extend, prefill
    cfg, jp, _ = _llama()
    lg, cache = prefill(cfg, jp, jnp.asarray(prompt), max_len=max_len,
                        dtype=jnp.float32)
    out = [int(lg.argmax(-1)[0])]
    for _ in range(n_out - 1):
        lg, cache = extend(cfg, jp, cache, jnp.asarray([[out[-1]]],
                                                       jnp.int32))
        out.append(int(lg.argmax(-1)[0]))
    return out


def _mixed_trace(plen=160, out=6):
    """tests/test_dual_device.py's trace: multi-chunk proactive prefills,
    a flow repeating flow 0's prompt (its prefix hit comes off the decode
    pool), reactives arriving mid-prefill and mid-decode."""
    from repro_torch.core import Priority, Request
    vocab = _llama()[0].vocab_size

    def pro(i, arrival=0.0, seed=None):
        return Request(id=i, priority=Priority.PROACTIVE, prompt_len=plen,
                       max_new_tokens=out, arrival_time=arrival,
                       tokens=np.random.default_rng(
                           i if seed is None else seed).integers(
                               0, vocab, (1, plen)))

    reqs = [pro(0), pro(1), pro(8, arrival=0.003, seed=0)]
    for k, t in ((0, 0.0008), (1, 0.004)):
        reqs.append(Request(
            id=20 + k, priority=Priority.REACTIVE, prompt_len=16,
            max_new_tokens=4, arrival_time=t,
            tokens=np.random.default_rng(100 + k).integers(0, vocab,
                                                           (1, 16))))
    return reqs


# -- mirrors of tests/test_backend.py's baseline tests --------------------------
def _backend_reqs(rng, arrivals, prompt_lens, out):
    """tests/test_backend.py's trace: flow 1 reactive, the rest proactive."""
    from repro_torch.core import Priority, Request
    vocab = _llama()[0].vocab_size
    return [Request(id=i, priority=Priority.REACTIVE if i == 1
                    else Priority.PROACTIVE, prompt_len=n, max_new_tokens=out,
                    arrival_time=t, tokens=rng.integers(0, vocab, (1, n)))
            for i, (t, n) in enumerate(zip(arrivals, prompt_lens))]


def test_legacy_mode_is_token_exact():
    """``device_resident=False`` (the pre-donation baseline): the reference's
    tokens, no fused run."""
    eng = _dual_engine(False, max_len=128, device_resident=False)
    reqs = _backend_reqs(np.random.default_rng(19), [0.0, 0.01], [14, 12], 4)
    eng.serve(copy.deepcopy(reqs))
    st = eng.stats()
    assert st["fused_steps"] == 0
    assert not eng.backend.elastic_decode and not eng.backend.in_pool_prefill
    for r in reqs:
        assert eng.output_tokens(r.id) == _j_reference_tokens(
            r.tokens, 4, 128), f"req {r.id}"


def test_scratch_bind_baseline_token_exact():
    """``in_pool_prefill=False`` (the scratch-cache baseline) stays exact
    with its double KV write in the counters; the in-pool default binds
    nothing and writes fewer KV bytes."""
    eng = _dual_engine(False, max_len=128, pool_slots=2,
                       in_pool_prefill=False)
    # two waves, so freed slots are rebound through the bind scatter
    reqs = _backend_reqs(np.random.default_rng(21), [0.0, 0.01, 5.0, 5.01],
                         [16, 12, 18, 14], 5)
    eng.serve(copy.deepcopy(reqs))
    st = eng.stats()
    assert st["bind_device_calls"] == len(reqs)
    assert st["prefill_host_syncs"] == len(reqs)
    for r in reqs:
        assert eng.output_tokens(r.id) == _j_reference_tokens(
            r.tokens, 5, 128), f"req {r.id}"
    pool = _dual_engine(False, max_len=128, pool_slots=2)
    pool.serve(copy.deepcopy(reqs))
    stp = pool.stats()
    assert stp["bind_device_calls"] == 0
    assert stp["prefill_host_syncs"] == len(reqs)
    assert 0 < stp["kv_bytes_prefill"] < st["kv_bytes_prefill"]
    for r in reqs:
        assert pool.output_tokens(r.id) == eng.output_tokens(r.id)


# -- tests/test_dual_device.py's own tests, the staged path on the CPU lane ---
def test_cpu_lane_is_a_second_lane():
    """The CPU lane is a lane of its own (the reference's two-device leg):
    staging is on and the stats name two lanes; without an explicit lane
    the CPU has none, and every prefill co-locates, as the reference does
    on one device."""
    be = _dual_backend(pool_slots=2, max_len=256)
    st = be.stats()
    assert be.dual_device and st["dual_device"]
    assert st["prefill_device"] != st["decode_device"] == "cpu"
    assert be._pf_stream is None  # in order on the CPU
    from repro_torch.configs import get_tiny_config
    from repro_torch.core.engine import RealAgentXPUEngine as TEngine
    colo = TEngine(get_tiny_config("llama3-405b"), _llama()[2], device="cpu",
                   dual_device=True, max_len=256)
    cst = colo.stats()
    assert not cst["dual_device"]
    assert cst["prefill_device"] == cst["decode_device"] == "cpu"


def test_dual_mesh_raises_typed_without_a_gpu():
    """The port's stage lanes (the production mesh stays unported) fail
    typed on a host without a GPU: requested and available lanes, an
    actionable message, a RuntimeError for old callers."""
    from repro_torch.launch.mesh import MeshDeviceError, dual_stage_devices
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: it has two lanes")
    with pytest.raises(MeshDeviceError) as ei:
        dual_stage_devices()
    assert (ei.value.requested, ei.value.available) == (2, 1)
    assert "GPU" in str(ei.value)
    assert isinstance(ei.value, RuntimeError)
    with pytest.raises(MeshDeviceError):
        dual_stage_devices("cpu")


def test_dual_device_mesh_and_stage_order():
    """Decode keeps its device and stream; prefill takes the next GPU, or
    a stream of its own on one GPU; without a GPU, (2, 1) typed."""
    from repro_torch.launch.mesh import (MeshDeviceError, dual_stage_devices,
                                         make_dual_device_mesh)
    if not torch.cuda.is_available():
        with pytest.raises(MeshDeviceError) as ei:
            make_dual_device_mesh()
        assert (ei.value.requested, ei.value.available) == (2, 1)
        return
    mesh = make_dual_device_mesh()
    assert mesh.axis_names == ("stage",) and len(mesh.lanes) == 2
    dec, pf = dual_stage_devices()
    assert dec.device == torch.device("cuda", torch.cuda.current_device())
    assert dec.stream == torch.cuda.current_stream()
    if torch.cuda.device_count() >= 2:
        assert pf.device != dec.device
    else:
        assert pf.device == dec.device and pf.stream != dec.stream


def test_dual_engine_token_exact_mixed_trace():
    """Every flow of the mixed preemption / prefix-hit trace streams the
    same tokens from the staged engine and the single-lane one, the
    kernel-completion traces are equal, and flows 0 and 20 equal the
    reference's unscheduled tokens."""
    kw = dict(max_len=256, pool_slots=6, decode_segment_steps=4)
    dual, single = _dual_engine(True, **kw), _dual_engine(False, **kw)
    reqs = _mixed_trace()
    dual.serve(copy.deepcopy(reqs))
    single.serve(copy.deepcopy(reqs))
    for r in reqs:
        assert dual.output_tokens(r.id) == single.output_tokens(r.id), \
            f"req {r.id}"
    assert dual.last_trace == single.last_trace
    assert dual.output_tokens(0) == _j_reference_tokens(reqs[0].tokens, 6,
                                                        256)
    assert dual.output_tokens(20) == _j_reference_tokens(reqs[3].tokens, 4,
                                                         256)
    assert dual.backend.validate() == []
    st = dual.stats()
    assert "contention_pressure_peak" in st
    assert st["co_execution_decode_slowdown_model"] >= 1.0
    assert st["dual_device"]
    assert st["staged_prefills"] > 0  # cold prompts really staged
    assert st["handoff_device_calls"] == st["staged_prefills"]
    assert st["kv_bytes_handoff"] > 0
    assert st["colocated_hits"] >= 1  # the duplicate-prompt flow
    assert st["prefill_device"] != st["decode_device"]
    assert not dual.backend._staged and not dual.backend._scratch


def test_sim_and_real_dual_traces_identical_with_aborts():
    """Staging is backend-local: a sim run and a staged real run give the
    same kernel-completion trace when a reactive abort fires mid-plan."""
    from repro_torch.core import Priority, Request
    eng_real = _dual_engine(True, max_len=128, pool_slots=8,
                            decode_segment_steps=2)
    cfg = eng_real.cfg
    rng = np.random.default_rng(43)
    pro = [Request(id=i, priority=Priority.PROACTIVE, prompt_len=plen,
                   max_new_tokens=16, arrival_time=0.0,
                   tokens=rng.integers(0, cfg.vocab_size, (1, plen)))
           for i, plen in enumerate([14, 12])]
    probe = TAgentXPUEngine(cfg, decode_segment_steps=2)
    probe.run_trace(copy.deepcopy(pro))
    steps = [t for kind, _, t in probe.last_trace if kind == "decode_step"]
    reqs = pro + [Request(
        id=9, priority=Priority.REACTIVE, prompt_len=10, max_new_tokens=4,
        arrival_time=steps[int(len(steps) * 0.4)],
        tokens=rng.integers(0, cfg.vocab_size, (1, 10)))]
    eng_sim = TAgentXPUEngine(cfg, decode_segment_steps=2)
    m_sim = eng_sim.run_trace(copy.deepcopy(reqs))
    m_real = eng_real.serve(copy.deepcopy(reqs))
    st = eng_real.stats()
    assert st["aborted_runs"] > 0 and st["staged_prefills"] > 0
    assert eng_sim.last_trace == eng_real.last_trace
    assert m_sim.sim_time == m_real.sim_time


def _staged_req(rid, vocab, rng):
    from repro_torch.core import Priority, Request
    return Request(id=rid, priority=Priority.PROACTIVE, prompt_len=160,
                   max_new_tokens=4, arrival_time=0.0,
                   tokens=rng.integers(0, vocab, (1, 160)))


def test_staged_release_mid_prefill_and_handoff_cancel():
    """A staged flow released mid-prefill leaves no slot, staging or
    prompt residue; a flow cancelled right after its handoff frees its
    row; the next flow through the recycled staging cache and the freed
    row gets its exact first token (no stale KV)."""
    be = _dual_backend(pool_slots=2, max_len=256)
    assert be.dual_device
    vocab, rng = _llama()[0].vocab_size, np.random.default_rng(7)
    r1 = _staged_req(1, vocab, rng)
    be.register(r1)
    be.prefill_chunk(r1, 0, 128, 0.0)
    assert 1 in be._staged and 1 in be._scratch
    be.release([r1], 0.0)
    assert not be._staged and 1 not in be._scratch
    assert not be._stage_decision and 1 not in be._tok_dev_pf
    assert len(be._free) == 2  # a staged prefill binds no slot before
    assert be.validate() == []

    r2 = _staged_req(2, vocab, rng)
    be.register(r2)
    be.prefill_chunk(r2, 0, 128, 0.0)
    be.prefill_chunk(r2, 128, 32, 0.0)
    be.prefill_done(r2, 0.0)
    assert be.handoff_device_calls == 1 and len(be._staging_free) == 1
    assert be.output_tokens(2) == _j_reference_tokens(r2.tokens, 1, 256)
    be.finish(r2, 0.0)
    assert len(be._free) == 2
    assert be.validate() == []

    r3 = _staged_req(3, vocab, rng)
    be.register(r3)
    be.prefill_chunk(r3, 0, 128, 0.0)  # takes the recycled staging cache
    # one reset and one bucket: r1 ran one, r2 two
    assert not be._staging_free and be.prefill_device_calls == 1 + 2 + 2
    be.prefill_chunk(r3, 128, 32, 0.0)
    be.prefill_done(r3, 0.0)
    assert be.output_tokens(3) == _j_reference_tokens(r3.tokens, 1, 256)
    be.release([r3], 0.0)
    assert be.validate() == []


def test_backpressure_colocates_second_prefill():
    """With one staged prefill in flight at most, a second concurrent one
    binds to the decode lane (the in-pool path), stickily."""
    be = _dual_backend(pool_slots=3, max_len=256, prefill_inflight_max=1)
    vocab, rng = _llama()[0].vocab_size, np.random.default_rng(11)
    reqs = [_staged_req(i, vocab, rng) for i in (1, 2)]
    for r in reqs:
        be.register(r)
    be.prefill_chunk(reqs[0], 0, 128, 0.0)
    be.prefill_chunk(reqs[1], 0, 128, 0.0)
    assert be._stage_decision == {1: True, 2: False}
    assert be.colocated_backpressure == 1
    assert len(be._free) == 2  # the co-located flow bound its slot already
    be.prefill_chunk(reqs[0], 128, 32, 0.0)
    be.prefill_done(reqs[0], 0.0)
    be.prefill_chunk(reqs[1], 128, 32, 0.0)
    assert be._stage_decision[2] is False
    be.prefill_done(reqs[1], 0.0)
    for r in reqs:
        assert be.output_tokens(r.id) == _j_reference_tokens(r.tokens, 1,
                                                             256), r.id
    be.release(reqs, 0.0)
    assert be.validate() == []


def test_co_execution_rates_and_estimator():
    """The port's contention model equals the reference's (no JAX there)."""
    from repro.core.contention import MemoryPressureEstimator as JEst
    from repro.core.contention import co_execution_rates as j_rates
    from repro_torch.core.contention import (MemoryPressureEstimator,
                                             co_execution_rates)
    assert co_execution_rates([0.3, 0.4]) == [1.0, 1.0]  # uncontended
    rp, rd = co_execution_rates([0.35, 0.85])
    assert rd < rp < 1.0  # the memory-bound decode kernel suffers more
    for utils in ([0.35, 0.85], [0.9, 0.9, 0.2], [0.5]):
        assert co_execution_rates(utils) == j_rates(utils)
    est, jest = MemoryPressureEstimator(), JEst()
    for e in (est, jest):
        e.add("prefill", 0.35)
        e.add("decode", 0.85)
    assert est.pressure == pytest.approx(1.20) == jest.pressure
    assert est.active == {"prefill": 0.35, "decode": 0.85}
    assert est.rates() == co_execution_rates([0.35, 0.85])
    est.remove("prefill")
    assert est.pressure == pytest.approx(0.85)
    assert est.rates() == [1.0]


def test_calibration_sources():
    from repro.core.contention import CoExecutionCalibration as JCal
    from repro_torch.core.contention import CoExecutionCalibration as Cal
    neutral = Cal.neutral()
    assert (neutral.prefill_slowdown, neutral.decode_slowdown) == (1.0, 1.0)
    model = Cal.from_rates(0.35, 0.85)
    j = JCal.from_rates(0.35, 0.85)
    assert (model.prefill_slowdown, model.decode_slowdown) == \
        (j.prefill_slowdown, j.decode_slowdown)
    assert model.prefill_slowdown > 1.0 and model.decode_slowdown > 1.0
    cal = Cal.from_backend_stats(
        {"co_execution_decode_slowdown_measured": 1.3,
         "prefill_bw_util": 0.35, "decode_bw_util": 0.85})
    assert cal.decode_slowdown == pytest.approx(1.3)
    assert cal.prefill_slowdown == pytest.approx(model.prefill_slowdown)
    cal = Cal.from_backend_stats(
        {"co_execution_decode_slowdown_measured": None,
         "prefill_bw_util": 0.35, "decode_bw_util": 0.85})
    assert cal == model
    assert Cal.from_backend_stats({}, default=neutral) == neutral


def test_calibration_threads_into_scheduler_neutrally():
    """The neutral calibration keeps the sim trace bit-identical (and equal
    to the reference's); a pessimistic decode slowdown only shrinks fused
    plans."""
    from repro.core.contention import CoExecutionCalibration as JCal
    from repro_torch.core import Priority, Request
    from repro_torch.core.contention import CoExecutionCalibration as Cal
    cfg = t_get_config("llama3-405b")
    rng = np.random.default_rng(47)
    reqs = [Request(id=i, priority=Priority.PROACTIVE, prompt_len=plen,
                    max_new_tokens=24, arrival_time=0.0,
                    tokens=rng.integers(0, 256, (1, plen)))
            for i, plen in enumerate([12, 14, 16])]
    reqs.append(Request(
        id=9, priority=Priority.REACTIVE, prompt_len=96, max_new_tokens=4,
        arrival_time=0.004, tokens=rng.integers(0, 256, (1, 96))))

    def run(engine_cls, trace, **kw):
        eng = engine_cls(get_config("llama3-405b")
                         if engine_cls is AgentXPUEngine else cfg,
                         decode_segment_steps=2, **kw)
        eng.run_trace(copy.deepcopy(trace))
        return eng

    base = run(TAgentXPUEngine, reqs)
    assert base.last_sched.contention_cal == Cal.neutral()
    explicit = run(TAgentXPUEngine, reqs,
                   contention_calibration=Cal.neutral())
    assert base.last_trace == explicit.last_trace
    from repro.core import Priority as JP
    from repro.core import Request as JR
    jreqs = [JR(id=r.id, priority=JP[r.priority.name],
                prompt_len=r.prompt_len, max_new_tokens=r.max_new_tokens,
                arrival_time=r.arrival_time, tokens=r.tokens) for r in reqs]
    jbase = run(AgentXPUEngine, jreqs)
    assert base.last_trace == jbase.last_trace
    slow = run(TAgentXPUEngine, reqs, contention_calibration=Cal(
        prefill_slowdown=1.0, decode_slowdown=2.0))
    jslow = run(AgentXPUEngine, jreqs, contention_calibration=JCal(
        prefill_slowdown=1.0, decode_slowdown=2.0))
    assert slow.last_sched.piggyback_steps <= base.last_sched.piggyback_steps
    assert slow.last_trace == jslow.last_trace


def test_reactive_abort_token_exact_dual_device():
    """tests/test_preemption_real.py's dual-device case on the CPU lane: a
    reactive arriving mid fused run truncates the plan and every flow
    replays token-exactly: the single-lane engine's tokens (held to the
    reference's engine by tests/test_torch_engine.py), the reactive flow
    the reference's unscheduled ones."""
    from repro_torch.core import Priority, Request
    eng = _dual_engine(True, max_len=128, decode_segment_steps=2)
    single = _dual_engine(False, max_len=128, decode_segment_steps=2)
    cfg = eng.cfg
    rng = np.random.default_rng(41)
    pro = [Request(id=i, priority=Priority.PROACTIVE, prompt_len=n,
                   max_new_tokens=24, arrival_time=0.0,
                   tokens=rng.integers(0, cfg.vocab_size, (1, n)))
           for i, n in enumerate([12, 14, 16])]
    probe = TAgentXPUEngine(cfg, decode_segment_steps=2)
    probe.run_trace(copy.deepcopy(pro))
    steps = [t for kind, _, t in probe.last_trace if kind == "decode_step"]
    reactive = Request(
        id=50, priority=Priority.REACTIVE, prompt_len=12, max_new_tokens=6,
        arrival_time=steps[int(len(steps) * 0.3)],
        tokens=rng.integers(0, cfg.vocab_size, (1, 12)))
    eng.serve(copy.deepcopy(pro + [reactive]))
    single.serve(copy.deepcopy(pro + [reactive]))
    st = eng.stats()
    assert st["aborted_runs"] > 0 and st["staged_prefills"] > 0
    assert eng.backend.validate() == []
    assert eng.last_trace == single.last_trace
    for r in pro + [reactive]:
        assert eng.output_tokens(r.id) == single.output_tokens(r.id), r.id
        assert len(eng.output_tokens(r.id)) == r.max_new_tokens
    assert eng.output_tokens(50) == _j_reference_tokens(reactive.tokens, 6,
                                                        128)


# the reference's DualDeviceBackend on two host devices, in a subprocess
# (its XLA flag must be set before JAX starts): tiny llama, the mixed trace
# with one staged prefill in flight at most
_REF_DUAL = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_tiny_config
from repro.core import Priority, Request
from repro.core.engine import RealAgentXPUEngine
from repro.models import init_params
assert len(jax.devices()) == 2, jax.devices()
flows = json.load(open(sys.argv[1]))
cfg = get_tiny_config("llama3-405b")
eng = RealAgentXPUEngine(cfg, init_params(cfg, jax.random.PRNGKey(0),
                                          jnp.float32), dual_device=True,
                         **flows["engine"])
eng.serve([Request(id=f["id"], priority=Priority[f["priority"]],
                   prompt_len=len(f["tokens"]), max_new_tokens=f["out"],
                   arrival_time=f["arrival"],
                   tokens=np.asarray([f["tokens"]])) for f in flows["flows"]])
print(json.dumps({"tokens": {f["id"]: eng.output_tokens(f["id"])
                             for f in flows["flows"]},
                  "trace": eng.last_trace, "stats": eng.stats()}))
"""
# values that differ by nature: device names, each side's kernel route,
# and a ratio of wall-clock times
_DUAL_EXEMPT = {"prefill_device", "decode_device", "kernel_backend",
                "co_execution_decode_slowdown_measured"}


def test_staged_counters_match_reference_on_two_devices(tmp_path):
    """The port's staged path on the CPU lane against the reference's
    ``DualDeviceBackend`` on two host devices, on the mixed trace with
    ``prefill_inflight_max=1`` (backpressure) and a prefix hit: tokens, the
    kernel-completion trace and every stats() value (staged_prefills,
    handoff_device_calls, kv_bytes_handoff, the colocated_* fallbacks among
    them) but the device names."""
    engine = dict(max_len=256, pool_slots=6, decode_segment_steps=4,
                  prefill_inflight_max=1)
    reqs = _mixed_trace()
    spec = tmp_path / "flows.json"
    spec.write_text(json.dumps({"engine": engine, "flows": [
        dict(id=r.id, priority=r.priority.name, arrival=r.arrival_time,
             out=r.max_new_tokens, tokens=[int(t) for t in r.tokens[0]])
        for r in reqs]}))
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    out = subprocess.run([sys.executable, "-c", _REF_DUAL, str(spec)],
                         capture_output=True, text=True, env=env,
                         cwd=__file__.rsplit("/", 2)[0], timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    want = json.loads(out.stdout.splitlines()[-1])
    eng = _dual_engine(True, **engine)
    eng.serve(copy.deepcopy(reqs))
    got = {"tokens": {str(r.id): eng.output_tokens(r.id) for r in reqs},
           "trace": json.loads(json.dumps(eng.last_trace)),
           "stats": json.loads(json.dumps(eng.stats()))}
    assert got["tokens"] == want["tokens"]
    assert got["trace"] == want["trace"]
    js, ts = want["stats"], got["stats"]
    assert set(ts) == set(js)
    assert {k: v for k, v in ts.items() if k not in _DUAL_EXEMPT} == \
        {k: v for k, v in js.items() if k not in _DUAL_EXEMPT}
    assert ts["dual_device"] and ts["staged_prefills"] > 0
    assert ts["colocated_backpressure"] > 0 and ts["colocated_hits"] > 0
    assert ts["handoff_device_calls"] == ts["staged_prefills"]
