import os
import sys

import pytest

# model/test code must see the single real CPU device (the 512-device flag is
# set ONLY inside launch/dryrun.py, never globally)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_executables_between_modules():
    """Free compiled executables after each test module.

    The single-process tier-1 run accumulates hundreds of live jitted
    executables across modules; past a threshold the CPU XLA backend
    segfaults inside ``backend_compile`` on the next large scan program
    (observed deterministically in whichever module compiles it first —
    every module passes in isolation).  Tests never share compiled
    functions across module boundaries, so dropping the caches between
    modules only costs recompiles of the tiny shared configs."""
    yield
    if "jax" in sys.modules:  # never import jax for jax-free modules
        sys.modules["jax"].clear_caches()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)")
