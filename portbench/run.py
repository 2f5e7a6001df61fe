"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  Draws the weights and the traffic from
``--seed`` on the card, serves the cell's traffic through the port's
``ServingFrontend`` for a warm-up and then for ``--seconds`` measured
seconds, checks a sample of the served tokens against the plain
reference, and prints, as the last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (``--trace 0``:
the cell's end-to-end metrics; ``--trace 1``: its per-layer metrics, read
under the profiler and the benchmark's wrappers), ``device`` and, traced,
``breakdown``, then ``checks``: each number compared beside its limit.
The same numbers are the last lines of standard error.

Exits non-zero, printing no result, without CUDA or with fewer cards than
the cell asks for, when the program is missing, and when JAX or the JAX
package is loaded once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _environment():
    """Import paths, and every build and kernel cache inside the
    checkout, at fixed paths."""
    for p in (os.path.join(ROOT, "src"), ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)
    build = os.path.join(ROOT, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # one process with few threads: the program's host work is one engine
    # thread; idle CPU-op worker threads only compete with it for cores
    os.environ["OMP_NUM_THREADS"] = "1"


def result_line(cell, r, metrics, checks, peak, trace, kind) -> dict:
    """The run's result: the contract's keys, ``checks`` (each number
    compared beside its limit) last."""
    from portbench import bench
    window = r.in_window()
    failed = sum(1 for s in window
                 if s.handle.status in ("failed", "timed_out", "rejected"))
    dev = {"platform": "gpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": int(peak)}
    out = {"correct": bench.passed(checks), "attempted": len(window),
           "failed": failed, "metrics": metrics, "device": dev}
    if trace and r.profile is not None:
        dev["busy_s"] = r.profile["busy_s"]
        dev["window_s"] = r.profile["window_s"]
        out["breakdown"] = r.profile["breakdown"]
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch
    from portbench import bench
    spec = bench.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = bench.load_cell(spec, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.set_num_threads(1)
    trace = bool(args.trace)
    r, done, w, peak = bench.serve(cell, args.seed, args.seconds, trace,
                                   device, T_START)
    metrics = bench.read_metrics(cell, r, trace)
    checks = bench.check(cell, r, done, w, args.seed, device)
    detail = checks.pop("_detail")
    bad = bench.forbidden_modules()
    if bad:
        print(f"portbench: loaded in the run's process: {bad}",
              file=sys.stderr)
        return 3
    out = result_line(cell, r, metrics, checks, peak, trace,
                      torch.cuda.get_device_name(device))
    print(f"portbench: {cell.name} seed {args.seed}: {len(done)} finished, "
          f"{detail['tokens']} served tokens compared, mean gap "
          f"{detail['mean_gap']} over logit sd {detail['logit_sd']}, widest "
          f"gap {detail['widest_gap']}, reference argmax share "
          f"{detail['argmax_share']}, generator lag max "
          f"{max(r.lags) if r.lags else 0.0}", file=sys.stderr)
    mix: dict = {}
    for s in r.sent:
        k = f"{s.job.priority}:{s.handle.status}"
        mix[k] = mix.get(k, 0) + 1
    st = {k: r.stats1.get(k, 0) - r.stats0.get(k, 0)
          for k in ("fused_steps", "decode_segments", "prefill_device_calls",
                    "prefill_forward_tokens", "prefix_hit_tokens",
                    "aborted_runs")}
    bins = {"proactive": [0] * 5, "reactive": [0] * 5}
    for s in r.sent:
        for t in s.handle.token_walls:
            if r.t0 <= t < r.t1:
                bins[s.job.priority][min(4, int(5 * (t - r.t0)
                                                / r.window_s))] += 1
    print(f"portbench: requests by class and status {mix}; in the window "
          f"{st}; proactive tokens by fifth of the window "
          f"{bins['proactive']}, reactive {bins['reactive']}; "
          f"simulated clock {r.sim}", file=sys.stderr)
    for k, v in checks.items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
