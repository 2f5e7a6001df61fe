"""Single source of truth for CI test sharding.

The tier-1 suite runs ~14 minutes in one process; CI splits it into shard
jobs that each stay well under 10 minutes of wall.  Shards are explicit
file lists (not pytest-xdist): separate processes also sidestep the CPU
XLA live-executable accumulation that conftest.py works around, and an
explicit map keeps "which shard ran my test" greppable from the CI log.

tests/test_shards.py asserts the shards exactly partition the test files
on disk, so adding a test module without assigning it a shard fails CI
instead of silently never running.

Balance (measured single-process durations on the dev box): the real-
engine modules dominate — quant_kv, prefix_cache, elastic_decode, faults,
backend, preemption_real each carry minutes of jit+serve time; the pure
sim/config modules are seconds.
"""
from __future__ import annotations

import os
from typing import Dict, List

SHARDS: Dict[str, List[str]] = {
    "real-backend": [
        "test_backend.py",
        "test_preemption_real.py",
        "test_kernels.py",
        "test_system.py",
        "test_scheduler.py",
        "test_configs.py",
        "test_torch_kernels.py",
        "test_torch_cuda.py",
    ],
    "kv-pool": [
        "test_quant_kv.py",
        "test_elastic_decode.py",
        "test_consistency.py",
        "test_property.py",
        "test_hlocost.py",
        "test_train_data.py",
        "test_torch_models.py",
        "test_torch_moe.py",
    ],
    "serving": [
        "test_prefix_cache.py",
        "test_faults.py",
        "test_frontend.py",
        "test_loadgen.py",
        "test_models_smoke.py",
        "test_shards.py",
        "test_dual_device.py",
        "test_torch_sim.py",
        "test_torch_engine.py",
    ],
}


def shard_files(name: str) -> List[str]:
    """The pytest arguments of one shard (paths relative to tests/)."""
    return [os.path.join("tests", f) for f in SHARDS[name]]


def all_sharded_files() -> List[str]:
    out: List[str] = []
    for files in SHARDS.values():
        out.extend(files)
    return out


if __name__ == "__main__":  # CI: python tests/shards.py <shard-name>
    import sys
    print(" ".join(shard_files(sys.argv[1])))
