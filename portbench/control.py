"""The readings a cell's correctness limit is set from, on the card.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \
        --seconds 15 [--control 3]

For each seed, in one process, ``bench.limit_readings``: the cell's
traffic served through the program for a short window, and a sample of
the finished requests (as a run draws it) judged on the same prompts and
served tokens: the program's mean gap under the float32 reference (a
lower reading), and, for the first ``--control`` seeds, the control's: the
reference computed with fp8 (e4m3) products, the precision below the
configuration's bf16, read as the gap under the float32 reference of the
token it puts first at each served position (an upper reading).  Prints
one JSON line a seed and a summary; the benchmark's own runs never run
this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path[:0] = [os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), p) for p in ("src", "")]

from portbench import bench  # noqa: E402
from portbench.run import ROOT, _environment  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--warmup", type=float, default=3.0)
    args = ap.parse_args(argv)
    _environment()
    import torch
    spec = bench.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = bench.load_cell(spec, args.workload)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    rows = []
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        row = {"seed": seed, **bench.limit_readings(
            cell, seed, args.seconds, device, i < args.control,
            warmup_s=args.warmup)}
        row["seconds"] = time.perf_counter() - t
        rows.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    summary = {f"program_{k}_max": max(x["program"][k] for x in rows)
               for k in ("mean_gap_sd", "mean_gap", "widest_gap")}
    ctl = [x["control"] for x in rows if "control" in x]
    for k in ("mean_gap_sd", "mean_gap", "widest_gap") if ctl else ():
        summary[f"control_{k}_min"] = min(c[k] for c in ctl)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
