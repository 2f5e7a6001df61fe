"""Sharded runs of the port on four gloo CPU ranks, held to the JAX
reference's unsharded runs; shared by tests/test_torch_kernels.py.

The parent computes the reference once per arch (tiny, f32, the
reference's own weights) and writes the weights to an npz; four worker
processes (``python tests/torch_shard_cases.py RANK ...``) start a gloo
group on localhost, lay the same weights out on each case's mesh
(``param_shardings``) and run the port's sharded ``forward``, ``prefill``
plus ``DECODE_STEPS`` decode ``extend`` calls, ``loss_and_grads`` (remat on
and ``"dots"``) and one ``make_train_step``, all with ``batch_axes="data"``
and ``tp_axis="model"``, plus a batch-sharded serve through the attention
kernels' wrappers (their plain versions here, on the CPU, through
``local_map``).  Rank 0 gathers every result whole (``full_tensor``) into
an npz that the tests compare.

Limits (the parity standard): forward and prefill logits 3e-3, decode
logits 1e-2, the loss 1e-5 relative, every gradient leaf 1e-4 relative L2;
``remat="dots"`` gradients equal to ``remat=True``'s within the same
limit."""
import os
import socket
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (arch, mesh shape): the 1x4 mesh puts llama's 2 kv heads under a model
# axis of 4 (_expand_kv), the MoE case its routing under DTensor
CASES = [("llama3-405b", (2, 2)), ("llama3-405b", (1, 4)),
         ("qwen2-moe-a2.7b", (2, 2))]
B, S, DECODE_STEPS = 4, 16, 4
WORLD = 4
PREFILL_TOL, DECODE_TOL = 3e-3, 1e-2
LOSS_REL, GRAD_REL = 1e-5, 1e-4
CASE_TIMEOUT = 600


def case_name(arch, mesh):
    return f"{arch}-{mesh[0]}x{mesh[1]}"


def reference(arch, tmp):
    """The reference's unsharded runs of ``arch`` (numpy), and the npz of
    its weights and tokens at ``tmp``."""
    import jax
    import jax.numpy as jnp
    from repro import models as J
    from repro.train.train_loop import lm_loss as j_lm_loss
    from torch_train_cases import tokens, train_weights
    jcfg, jp, _ = train_weights(arch)
    toks = tokens(jcfg, (B, S + DECODE_STEPS + 1), seed=11)
    logits, _ = J.forward(jcfg, jp, jnp.asarray(toks[:, :S]))
    lg, cache = J.prefill(jcfg, jp, jnp.asarray(toks[:, :S]),
                          max_len=S + DECODE_STEPS, dtype=jnp.float32)
    steps = [np.asarray(lg)]
    for i in range(DECODE_STEPS):
        lg, cache = J.extend(jcfg, jp, cache,
                             jnp.asarray(toks[:, S + i:S + i + 1]))
        steps.append(np.asarray(lg))
    batch = jnp.asarray(toks[:, :S + 1])
    (loss, _), grads = jax.value_and_grad(
        lambda p: j_lm_loss(jcfg, p, batch), has_aux=True)(jp)
    named = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path): np.asarray(g)
             for path, g in jax.tree_util.tree_leaves_with_path(grads)}
    from repro_torch.models import from_jax_params
    sd = {k: v.numpy() for k, v in from_jax_params(jp).items()}
    path = os.path.join(tmp, f"{arch}.npz")
    np.savez(path, tokens=toks, **{"w." + k: v for k, v in sd.items()})
    return {"forward": np.asarray(logits), "steps": steps,
            "loss": float(loss), "grads": named, "weights": path}


def run_workers(archs_npz, out, timeout=CASE_TIMEOUT):
    """Start the four gloo ranks over ``CASES`` (weights from
    ``archs_npz``: {arch: npz path}); rank 0 writes ``out``.  Returns the
    ranks' exit codes and their output."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]))
    env.pop("JAX_PLATFORMS", None)
    arg = ",".join(f"{a}={p}" for a, p in archs_npz.items())
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(port), arg,
         out], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    return [p.returncode for p in procs], logs


def _worker(rank, port, archs_npz, out):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_tiny_config
    from repro_torch.models import (extend, forward, module_from_state_dict,
                                    prefill)
    from repro_torch.models.params import param_shardings
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_loop import loss_and_grads, make_train_step
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD)
    res = {}

    def full(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t
                ).detach().float().numpy()

    for arch, shape in CASES:
        name = case_name(arch, shape)
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        npz = np.load(archs_npz[arch])
        sd = {k[2:]: torch.from_numpy(npz[k]) for k in npz.files
              if k.startswith("w.")}
        toks = torch.from_numpy(npz["tokens"])
        cfg = get_tiny_config(arch)
        params = param_shardings(module_from_state_dict(sd), mesh)
        sh = dict(batch_axes="data", tp_axis="model",
                  kernel_backend="plain")
        with torch.no_grad():
            logits, _ = forward(cfg, params, toks[:, :S], remat=False, **sh)
            res[f"{name}/forward"] = full(logits)
            lg, cache = prefill(cfg, params, toks[:, :S],
                                max_len=S + DECODE_STEPS,
                                dtype=torch.float32, **sh)
            steps = [full(lg)]
            for i in range(DECODE_STEPS):
                lg, cache = extend(cfg, params, cache,
                                   toks[:, S + i:S + i + 1], **sh)
                steps.append(full(lg))
            res[f"{name}/steps"] = np.stack(steps)
            # batch-sharded only, through the attention kernels' wrappers
            # on each rank's rows (their plain versions on the CPU)
            rows = dict(batch_axes="data", kernel_backend="cuda")
            lg, cache = prefill(cfg, params, toks[:, :S],
                                max_len=S + DECODE_STEPS,
                                dtype=torch.float32, **rows)
            steps = [full(lg)]
            for i in range(DECODE_STEPS):
                lg, cache = extend(cfg, params, cache,
                                   toks[:, S + i:S + i + 1], **rows)
                steps.append(full(lg))
            res[f"{name}/rows_steps"] = np.stack(steps)
        for remat in (True, "dots"):
            loss, _, grads = loss_and_grads(cfg, params, toks[:, :S + 1],
                                            remat=remat, **sh)
            res[f"{name}/loss/{remat}"] = full(loss)
            for k, g in grads.items():
                res[f"{name}/grad/{remat}/{k}"] = full(g)
        opt = init_opt_state(params)
        _, opt, met = make_train_step(cfg, AdamWConfig(), **sh)(
            params, opt, {"tokens": toks[:, :S + 1]})
        res[f"{name}/step_loss"] = full(met["loss"])
        res[f"{name}/moments_laid_out"] = np.array(all(
            tuple(opt.m[n].placements) == tuple(p.placements)
            for n, p in params.named_parameters()))
    if rank == 0:
        np.savez(out, **res)
    dist.barrier()
    dist.destroy_process_group()


# the dry run's small stand-ins for the four shapes (sequence cut, the
# batches kept: they decide which data axes a batch is split over)
PROBE_ARCHS = ("llama3-405b", "qwen2-moe-a2.7b")
PROBE_SHAPES = {"train_4k": (64, 256, "train"),
                "prefill_32k": (128, 32, "prefill"),
                "decode_32k": (128, 128, "decode"),
                "long_500k": (256, 1, "decode")}


def run_probe(timeout=CASE_TIMEOUT):
    """``python tests/torch_shard_cases.py probe`` in a process of its own
    (it starts the dry run's fake 512-rank group): its JSON result."""
    import json
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "probe"], env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _probe():
    """On the fake group: the production meshes, ``op_cost`` of a sharded
    product and of two collectives on a 4-rank mesh, every kernel wrapper
    handed a DTensor, and the dry run of ``PROBE_ARCHS`` (tiny) over the
    four shapes on both meshes."""
    import json
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.configs import get_tiny_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.opcost import op_cost
    from repro_torch.launch.shapes import ShapeSpec
    dryrun.start_fake_group()
    res = {"meshes": {}}
    for mp in (False, True):
        m = make_production_mesh(multi_pod=mp, device="cpu")
        res["meshes"][str(mp)] = [list(m.mesh.shape), list(m.mesh_dim_names),
                                  m.device_type,
                                  m.mesh.flatten()[:3].tolist()]
    mesh = DeviceMesh("cpu", [0, 1, 2, 3], mesh_dim_names=("model",))

    def dist(shape, pl, device="meta"):
        return distribute_tensor(torch.empty(shape, device=device), mesh,
                                 pl, src_data_rank=None)
    a, b = dist((512, 256), [Shard(0)]), dist((256, 128), [Replicate()])
    res["sharded_flops"] = op_cost(lambda a, b: a @ b, a, b)["flops"]
    x = dist((64, 32), [Shard(0)])
    res["all_gather"] = op_cost(lambda x: x.full_tensor(), x)
    y, w = dist((64, 32), [Shard(1)]), dist((32, 16), [Shard(0)])
    res["all_reduce"] = op_cost(
        lambda y, w: (y @ w).redistribute(mesh, [Replicate()]), y, w)
    # every kernel wrapper refuses a DTensor
    q = dist((2, 4, 32), [Replicate()], "cpu")
    kv = dist((2, 8, 2, 32), [Replicate()], "cpu")
    sp = distribute_tensor(torch.zeros((2, 8), dtype=torch.int32), mesh,
                           [Replicate()], src_data_rank=None)
    cur = distribute_tensor(torch.zeros((2,), dtype=torch.int32), mesh,
                            [Replicate()], src_data_rank=None)
    q4 = dist((2, 4, 8, 32), [Replicate()], "cpu")
    k4 = dist((2, 2, 8, 32), [Replicate()], "cpu")
    lse = dist((2, 4, 8), [Replicate()], "cpu")
    x3 = dist((2, 4, 16), [Replicate()], "cpu")
    w3 = dist((2, 16, 8), [Replicate()], "cpu")
    h0 = dist((2, 16), [Replicate()], "cpu")
    calls = {
        "decode_attention": lambda: ops.decode_attention(q, kv, kv, sp, cur),
        "decode_attention_partials": lambda: ops.decode_attention_partials(
            q, kv, kv, sp, cur, n_split=2),
        "flash_attention_pool": lambda: ops.flash_attention_pool(
            q4, k4, k4, sp, sp),
        "moe_gemm": lambda: ops.moe_gemm(x3, w3),
        "moe_gemm_with": lambda: ops.moe_gemm_with(None, x3, w3),
        "rglru_scan": lambda: ops.rglru_scan(x3, x3, x3, h0),
        "rwkv6_scan": lambda: ops.rwkv6_scan(q4, q4, q4, q4, h0),
        "flash_attention": lambda: ops.flash_attention(q4, k4, k4),
        "flash_attention_bwd": lambda: ops.flash_attention_bwd(
            q4, k4, k4, q4, lse, q4),
        "flash_attention_train": lambda: ops.flash_attention_train(
            q4, k4, k4)}
    res["refused"] = {}
    for name, call in calls.items():
        try:
            call()
            res["refused"][name] = "ran"
        except TypeError as e:
            res["refused"][name] = "TypeError" if "DTensor" in str(e) \
                else repr(e)
        except Exception as e:  # noqa: BLE001 - recorded for the test
            res["refused"][name] = repr(e)
    res["dryrun"] = []
    for arch in PROBE_ARCHS:
        for name, (seq, batch, kind) in PROBE_SHAPES.items():
            for mp in (False, True):
                rec = dryrun.dryrun_one(
                    arch, name, multi_pod=mp, verbose=False,
                    cfg=get_tiny_config(arch),
                    shape=ShapeSpec(name, seq, batch, kind))
                res["dryrun"].append(rec)
    print(json.dumps(res))


if __name__ == "__main__":
    if sys.argv[1] == "probe":
        _probe()
    else:
        rank, port, arg, out = sys.argv[1:5]
        _worker(int(rank), int(port),
                dict(kv.split("=", 1) for kv in arg.split(",")), out)
