"""On-card test of the benchmark's correctness check: the control fails it
and the program passes it, at the cells' own sizes.

    python -m pytest -q -m cuda portbench/test_portbench_chip.py

For each cell of BENCHMARK.json, on three seeds: its traffic served through
the port in bf16 for a short window, then the served tokens' mean gap
under the float32 reference (the program) and the mean gap of the tokens
the fp8 reference puts first (the control), both in the reference logits'
standard deviations, held against the cell's limit (what
``portbench/control.py`` reads over more seeds).  About a minute a seed.
"""
from __future__ import annotations

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (os.path.join(ROOT, "src"), ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from portbench import bench  # noqa: E402

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


SPEC = bench.load_json(os.path.join(ROOT, "BENCHMARK.json"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_control_fails_and_program_passes(card, name):
    cell = bench.load_cell(SPEC, name)
    limit = cell.limits["mean_gap_sd"]
    for seed in SEEDS:
        got = bench.limit_readings(cell, seed, 10.0, card, True)
        prog, ctl = got["program"], got["control"]
        assert prog["tokens"] >= bench.MIN_COMPARED_TOKENS
        assert prog["mean_gap_sd"] <= limit, prog
        assert ctl["mean_gap_sd"] > limit, ctl
