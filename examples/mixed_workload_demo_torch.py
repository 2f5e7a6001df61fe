"""Paper §8 demo on the PyTorch port: sweep proactive request rates and
compare Agent.xpu with the baseline engines on reactive latency + proactive
throughput (simulation on the paper's Intel SoC hardware profile, over the
port's copy of ``core/``) -- ``examples/mixed_workload_demo.py`` over
``repro_torch``.

    PYTHONPATH=src python examples/mixed_workload_demo_torch.py
    PYTHONPATH=src python examples/mixed_workload_demo_torch.py --device cpu

The study is simulated on the host and launches nothing on a device;
``--device`` names the device the port's real mode would serve on and, as
in every example of the port, ``cuda`` (the default) raises when no GPU is
visible.
"""
import argparse
import copy
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs import get_config
from repro_torch.core import AgentXPUEngine, WorkloadConfig, generate_workload

ENGINES = ["agent.xpu", "fcfs", "naive_preempt", "timeshare",
           "continuous_batching"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("--device cuda and no GPU is visible; pass "
                           "--device cpu to run on the CPU")
    cfg = get_config("llama3.2-3b")
    print(f"{'engine':22s} {'rate':>5s} {'Rnorm ms/t':>11s} "
          f"{'Pe2e s':>8s} {'tok/s':>7s} {'J/tok':>6s}")
    for rate in (0.25, 1.0, 2.0):
        wl = WorkloadConfig(proactive_rate=rate, reactive_interval=15.0,
                            horizon=150.0, seed=1)
        reqs = generate_workload(wl)
        for name in ENGINES:
            m = AgentXPUEngine(cfg, scheduler=name).run_trace(
                copy.deepcopy(reqs), max_time=5000.0)
            s = m.summary()
            print(f"{name:22s} {rate:5.2f} "
                  f"{(s['reactive_norm_latency'] or 0)*1e3:11.2f} "
                  f"{s['proactive_e2e'] or 0:8.2f} "
                  f"{s['tokens_per_s']:7.1f} "
                  f"{s['energy_j_per_token']:6.2f}")
        print()


if __name__ == "__main__":
    main()
