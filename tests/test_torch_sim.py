"""PyTorch port: the copied scheduling layer makes the reference's decisions,
and the port stands alone (no ``jax``, no ``repro`` import)."""
import os
import subprocess
import sys

import pytest

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
    """Every repro_torch module imports (``models/moe.py`` among them), and
    CPU serves of a dense and an MoE model run, with ``jax`` and ``repro``
    blocked in ``sys.meta_path``."""
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
assert "repro_torch.models.moe" in sys.modules

from repro_torch.configs import get_tiny_config
from repro_torch.core import Priority, Request
from repro_torch.core.engine import RealAgentXPUEngine
from repro_torch.models import init_params

for arch in ("llama3.2-3b", "qwen2-moe-a2.7b"):
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
