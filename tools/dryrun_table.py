"""Markdown table of dry-run records (``python -m repro_torch.launch.dryrun``
writes one JSON file per arch x shape x mesh):

    python3 tools/dryrun_table.py DIR [--grid]

One row per record, sorted by arch, shape and mesh: status, per-chip
flops, bytes and collective bytes, the dominant roofline term and its
seconds (H100 constants, ``repro_torch.launch.dryrun``), the useful-flops
ratio and the trace's seconds; a skipped record gives its reason.  With
``--grid``, one row per arch and a column per shape, each cell "flops /
bytes / collective bytes, dominant term seconds" for 16x16, then for
2x16x16.
"""
from __future__ import annotations

import glob
import json
import os
import sys

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESHES = ("16x16", "2x16x16")


def load(directory):
    recs = []
    for path in glob.glob(os.path.join(directory, "*.json")):
        with open(path) as f:
            recs.append(json.load(f))
    recs.sort(key=lambda r: (r["arch"], SHAPES.index(r["shape"])
                             if r["shape"] in SHAPES else 9,
                             r.get("mesh", "")))
    return recs


def _why(r):
    why = r.get("reason") or r.get("traceback", "").strip()
    return why.splitlines()[-1] if why else ""


def _cells(r):
    """(flops, bytes, collective bytes, dominant, useful) of one record."""
    rf = r["roofline"]
    dom = rf["dominant"]
    useful = rf["useful_flops_ratio"]
    return (f"{r['hlo_flops_per_chip']:.3e}", f"{r['hlo_bytes_per_chip']:.3e}",
            f"{r['collective_bytes_per_chip']:.3e}",
            f"{dom[2:]} {rf[dom]:.4g}",
            "—" if useful is None else f"{useful:.3f}")


def rows(recs):
    out = ["| Arch | Shape | Mesh | Status | Flops/chip | Bytes/chip | "
           "Collective bytes/chip | Dominant (s) | Useful flops | Trace s |",
           "| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |"]
    for r in recs:
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | {r.get('mesh', '')} "
                       f"| {r['status']}: {_why(r)} | | | | | | |")
            continue
        out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
                   + " | ".join(_cells(r)) + f" | {r['lower_s']:.1f} |")
    return out


def _short(r):
    if r is None:
        return "missing"
    if r["status"] != "ok":
        return r["status"]
    rf = r["roofline"]
    dom = rf["dominant"]
    return (f"{r['hlo_flops_per_chip']:.2e} / {r['hlo_bytes_per_chip']:.2e}"
            f" / {r['collective_bytes_per_chip']:.2e}, {dom[2:5]} "
            f"{rf[dom]:.3g}")


def grid_rows(recs):
    by = {}
    for r in recs:
        by.setdefault(r["arch"], {})[(r["shape"], r.get("mesh"))] = r
    out = ["| Arch | " + " | ".join(SHAPES) + " |",
           "| --- |" + " --- |" * len(SHAPES)]
    for arch, cells in by.items():
        out.append(f"| {arch} | " + " | ".join(
            " · ".join(_short(cells.get((shape, m))) for m in MESHES)
            for shape in SHAPES) + " |")
    return out


if __name__ == "__main__":
    recs = load(sys.argv[1])
    print("\n".join(grid_rows(recs) if "--grid" in sys.argv[2:]
                    else rows(recs)))
