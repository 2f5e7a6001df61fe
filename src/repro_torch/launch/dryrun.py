"""Multi-pod dry run: trace every (arch x shape x mesh) combination of the
port's sharded programs on placeholder ranks, with per-chip cost, memory and a
roofline.  The port's counterpart of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes] [--out DIR]

Where the reference forces 512 placeholder host devices with ``XLA_FLAGS``
before JAX starts, this module starts a fake process group of 512 ranks
(``torch.distributed``'s ``fake`` backend: collectives return at once and
move nothing) before anything else of ``torch.distributed``, so it runs in
a process of its own (the tests start it as a subprocess).  The production
mesh is the group's first 256 (16x16) or all 512 (2x16x16) ranks, and this
process is rank 0.  Every tensor lives on the ``meta`` device: nothing
is allocated and nothing runs on a device.

The program of one chip is traced eagerly, op by op, through DTensor, and
counted by ``opcost.OpCounter`` on rank 0's local tensors.  Eager tracing
has no loop to multiply, so the repeated layer pattern is traced at 1 and
at 2 repeats and the counts extended linearly to its full count R
(c(R) = c(1) + (R - 1) (c(2) - c(1))): every repeat runs the same ops on
the same shapes, as ``hlo_cost`` multiplies a ``while`` body by its trip
count.  Widths, batch and sequence are never cut.

Artifacts (JSON per combination, the reference's keys) go to ``--out``
(default ``build/dryrun``, which git ignores).  The roofline uses the
NVIDIA H100 SXM5 data sheet (dense bf16 tensor cores, HBM3, NVLink per
direction), not the TPU's constants.  ``memory``: argument and output
bytes are the sums of rank 0's local shard bytes; temp bytes and
generated code have no counterpart on meta tensors and are ``null``,
with the reason in the record.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

# -- NVIDIA H100 SXM5 (per GPU, data sheet) ---------------------------------
PEAK_FLOPS = 989e12  # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 450e9  # bytes/s per direction

WORLD = 512  # the fake group's ranks: the multi-pod mesh
_NULL_REASON = ("meta tensors allocate nothing and nothing is compiled: no "
                "allocator peak and no generated code to measure")


def start_fake_group(world: int = WORLD) -> None:
    """The fake process group of ``world`` ranks, this process rank 0; a
    no-op if a group is up already."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _local_bytes(tree) -> int:
    """Sum of rank 0's local bytes of every tensor in ``tree``."""
    import torch
    from torch.distributed.tensor import DTensor
    if isinstance(tree, DTensor):
        return _local_bytes(tree.to_local())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, torch.nn.Module):
        return sum(_local_bytes(p) for p in tree.parameters())
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    return 0


def pod_data_view(mesh, cfg, shape):
    """The 2x16x16 mesh as the 32x16 ("data", "model") mesh over the same
    ranks in the same order.  At the four shapes the rules shard "pod" and
    "data" together or not at all (every FSDP spec names both; every batch
    is 1 or divisible by 32), so the two meshes lay out every tensor alike
    and one rank's program is the same; on the 3-D mesh DTensor plans each
    reshard over both axes by a graph search that takes minutes an op."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.models.params import batch_pspec
    spec = batch_pspec(mesh, shape.global_batch, 1)[0]
    assert spec in (None, ("pod", "data")), spec
    n_pod, n_data, n_model = mesh.mesh.shape
    return DeviceMesh(mesh.device_type,
                      mesh.mesh.reshape(n_pod * n_data, n_model),
                      mesh_dim_names=("data", "model"))


def at_depth(cfg, r: int):
    """``cfg`` with its repeated layer pattern cut to ``r`` repeats (head
    and tail layers kept), and the full repeat count."""
    from repro_torch.models.transformer import layout
    head, pattern, repeats, tail = layout(cfg)
    kw = dict(num_layers=len(head) + len(pattern) * r + len(tail))
    if cfg.layer_pattern:
        kw["pattern_repeats"] = r
    return cfg.with_overrides(**kw), repeats


def _trace(cfg, shape, mesh, *, serve_sharding, q_chunk, kv_chunk, remat,
           capacity_factor):
    """One chip's program of ``cfg`` x ``shape`` on ``mesh``, traced on meta
    tensors: (cost, argument bytes, output bytes, ops counted, seconds)."""
    import torch
    from repro_torch.launch.opcost import OpCounter
    from repro_torch.launch.shapes import input_specs
    from repro_torch.models.params import batch_pspec
    batch_axes = batch_pspec(mesh, shape.global_batch, 1)[0]
    t0 = time.time()
    step_fn, args = input_specs(
        cfg, shape.name, torch.bfloat16, batch_axes=batch_axes,
        tp_axis="model", q_chunk=q_chunk, kv_chunk=kv_chunk,
        remat="dots" if remat == "dots" else True,
        capacity_factor=capacity_factor, mesh=mesh,
        fsdp="off" if serve_sharding else "auto", shape=shape)
    arg_bytes = _local_bytes(args)
    counter = OpCounter()
    with counter:
        out = step_fn(*args)
    out_bytes = _local_bytes(out)
    return counter.cost(), arg_bytes, out_bytes, counter.ops, \
        time.time() - t0


def _extend(c1, c2, R):
    """c(R) from c(1) and c(2): linear in the repeats (nested dicts)."""
    if isinstance(c1, dict):
        return {k: _extend(c1[k], c2[k], R) for k in c1}
    return c1 + (R - 1) * (c2 - c1)


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool = False,
               verbose: bool = True, serve_sharding: bool = False,
               q_chunk: int = 512, kv_chunk: int = 512, remat="full",
               capacity_factor: float = 1.25, cfg=None, shape=None) -> dict:
    """The record of one combination.  ``cfg`` / ``shape`` replace the
    registry's config and the named shape's sizes (the tests' small
    stand-ins)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.shapes import SHAPES, shape_supported
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "chips": 512 if multi_pod else 256}
    okay, reason = shape_supported(cfg, shape_name)
    if not okay:
        rec.update(status="skipped", reason=reason)
        return rec

    start_fake_group()
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    if multi_pod:
        mesh = pod_data_view(mesh, cfg, shape)
    rec["serve_sharding"] = serve_sharding
    rec["q_chunk"] = q_chunk
    rec["kv_chunk"] = kv_chunk
    kw = dict(serve_sharding=serve_sharding, q_chunk=q_chunk,
              kv_chunk=kv_chunk, remat=remat,
              capacity_factor=capacity_factor)
    cfg1, R = at_depth(cfg, 1)
    c1, a1, o1, n1, s1 = _trace(cfg1, shape, mesh, **kw)
    if R > 1:
        c2, a2, o2, n2, s2 = _trace(at_depth(cfg, 2)[0], shape, mesh, **kw)
    else:
        c2, a2, o2, n2, s2 = c1, a1, o1, n1, 0.0
    hc = _extend(c1, c2, R)
    hc["collective_total"] = sum(hc["collectives"].values())

    # analytic model flops (global): 6*N_active*D train, 2*N_active*D forward
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    model_flops = (6 if shape.kind == "train" else 2) \
        * cfg.active_params() * tokens

    rec.update(status="ok", lower_s=s1 + s2, compile_s=None,
               memory={"argument_bytes": _extend(a1, a2, R),
                       "output_bytes": _extend(o1, o2, R),
                       "temp_bytes": None,
                       "generated_code_bytes": None,
                       "null_reason": _NULL_REASON},
               cost_analysis_raw={"repeats": R, "depth_1": c1,
                                  "depth_2": c2},
               hlo_flops_per_chip=hc["flops"],
               hlo_bytes_per_chip=hc["bytes"],
               collectives=hc["collectives"],
               collective_bytes_per_chip=hc["collective_total"],
               collective_count=hc["collective_count"],
               model_flops_global=model_flops,
               hlo_lines=_extend(n1, n2, R))

    rec["roofline"] = {
        "t_compute": hc["flops"] / PEAK_FLOPS,
        "t_memory": hc["bytes"] / HBM_BW,
        "t_collective": hc["collective_total"] / NVLINK_BW,
    }
    dom = max(rec["roofline"], key=rec["roofline"].get)
    rec["roofline"]["dominant"] = dom
    rec["roofline"]["useful_flops_ratio"] = (
        model_flops / (hc["flops"] * rec["chips"])
        if hc["flops"] else None)
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {rec['mesh']}: "
              f"trace {s1 + s2:.1f}s  flops/chip {hc['flops']:.3e}  "
              f"bytes/chip {hc['bytes']:.3e}  "
              f"coll {hc['collective_total']:.3e}B  dom={dom} "
              f"({rec['roofline'][dom]:.4g} s)  "
              f"useful={rec['roofline']['useful_flops_ratio']}", flush=True)
    return rec


def main(argv=None):
    from repro_torch.configs.registry import ASSIGNED
    from repro_torch.launch.shapes import SHAPES
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=os.path.join("build", "dryrun"))
    ap.add_argument("--serve-sharding", action="store_true",
                    help="no-FSDP weight layout (serving)")
    ap.add_argument("--q-chunk", type=int, default=512)
    ap.add_argument("--kv-chunk", type=int, default=512)
    ap.add_argument("--tag", default="")
    ap.add_argument("--remat", default="full", choices=["full", "dots"])
    ap.add_argument("--capacity-factor", type=float, default=1.25)
    args = ap.parse_args(argv)

    archs = ASSIGNED if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    start_fake_group()
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}_{shape}_{'2x16x16' if mp else '16x16'}"
                if args.tag:
                    tag += "_" + args.tag
                path = os.path.join(args.out, tag + ".json")
                try:
                    rec = dryrun_one(arch, shape, multi_pod=mp,
                                     serve_sharding=args.serve_sharding,
                                     q_chunk=args.q_chunk,
                                     kv_chunk=args.kv_chunk,
                                     remat=args.remat,
                                     capacity_factor=args.capacity_factor)
                except Exception:
                    rec = {"arch": arch, "shape": shape, "status": "FAILED",
                           "traceback": traceback.format_exc()}
                    failures.append(tag)
                    print(f"[dryrun] FAILED {tag}\n{rec['traceback']}",
                          flush=True)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=2)
    if failures:
        raise SystemExit(f"dry-run failures: {failures}")
    print("[dryrun] all combinations OK")


if __name__ == "__main__":
    main()
