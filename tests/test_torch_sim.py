"""PyTorch port: the copied scheduling layer makes the reference's decisions,
the training substrate (data pipeline, schedule, AdamW, checkpoints, the
loop and its launcher) matches the reference's, and the port stands alone
(no ``jax``, no ``repro`` import)."""
import os
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
    launcher among them), CPU serves of a dense, an MoE, an RG-LRU hybrid
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
        "repro_torch.launch.train"} <= set(sys.modules)

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
    out = subprocess.run([sys.executable, "-c", script],
                         capture_output=True, text=True, env=env,
                         cwd=__file__.rsplit("/", 2)[0], timeout=300)
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout



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
