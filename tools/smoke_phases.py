"""Run chosen phases of ``chip_smoke.py`` on the GPU, the kernels built
first (one ``nvcc`` each, in parallel), without the rest of the script:

    python3 tools/smoke_phases.py PHASE [PHASE ...]

PHASE is one of

- ``kernels``: the serving kernels' cases (``kernel_phase``);
- ``flash``: the training flash attention cases (``flash_kernel_phase``);
- ``serve:ARCH``: ``full_width_serve_phase`` for ARCH (the bf16 serve held
  to the plain path, and its profile);
- ``train:ARCH``: ``family_train_phase`` for ARCH (a key of
  ``TRAIN_FAMILIES``), or ``train`` for every family;
- ``lr:ARCH:LR[,LR...]``: the learning-rate trials of ARCH: for each LR,
  fresh weights (seed ``SEED``, the family's depth cut) and
  ``TRAIN_STEPS`` AdamW steps through ``train_loop.train`` on the
  synthetic corpus at ``TRAIN_BATCH x TRAIN_SEQ`` (the frontend forms:
  ``TRAIN_FRONTEND_BATCH`` rows with their frames or patches), the losses
  printed;
- ``encdec``: ``whisper-tiny``'s ``[encdec]`` phase (``encdec_phase``);
- ``vision``: ``llava-next-34b``'s ``[vision]`` phase (``vision_phase``);
- ``examples``: the four ``examples/*_torch.py`` files (``examples_phase``);
- ``prefix_store``: the snapshot-store serve on ``llama3.2-3b``
  (``prefix_store_phase``);
- ``dual`` / ``dual:ARCH``: ``dual_phases`` on ``llama3.2-3b`` (8 flows)
  or ARCH (``recurrentgemma-9b``: 4 flows), as ``chip_smoke.py`` runs
  them: the stream lane, and the second-GPU lane where a second GPU is
  visible;
- ``shard``: ``[shard]`` (``shard_phase``), the sharded entry points on
  the 1x1 host mesh and the full-width dry run of one combination;
- ``tp4``: a tensor-parallel check on four GPUs (needs four): four ranks
  (one process each, an NCCL group on localhost) lay ``qwen2.5-32b`` out
  at full width, cut to ``TP4_LAYERS`` layers, over a 1x4 ("data",
  "model") mesh with ``fsdp="off"`` (the serving layout), and run a
  ``TP4_PROMPT``-token prefill of ``TP4_BATCH`` rows and ``TP4_STEPS``
  decode steps with ``tp_axis="model"``; rank 0 holds every call's logits
  to an unsharded twin on its card (same seed): the largest logit gap and
  the greedy tokens within ``LOGIT_MARGIN`` of the twin's argmax.

Each phase raises as it does in ``chip_smoke.py``; the script exits
non-zero on the first failure and prints ``[phases] ok`` after the last.
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

TP4_ARCH, TP4_LAYERS = "qwen2.5-32b", 16
TP4_BATCH, TP4_PROMPT, TP4_STEPS = 2, 256, 4


def tp4_rank(rank, port):
    """One of the four ``tp4`` ranks (the phase's docstring above)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.params import param_shardings
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=4)
    cfg = get_config(TP4_ARCH).with_overrides(num_layers=TP4_LAYERS)
    mesh = init_device_mesh("cuda", (1, 4), mesh_dim_names=("data", "model"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 9)
    toks = torch.randint(0, cfg.vocab_size, (TP4_BATCH, TP4_PROMPT),
                         generator=gen, device="cuda")
    cs.SHARD_PROMPT, cs.SHARD_STEPS = TP4_PROMPT, TP4_STEPS
    twin = None
    if rank == 0:
        twin = init_params(cfg, seed=cs.SEED, dtype=torch.bfloat16,
                           device="cuda")
        ref, greedy, _ = cs._shard_run(cfg, twin, toks, None,
                                       kernel_backend="plain")
        del twin
        feed = greedy
    else:
        feed = torch.empty((TP4_STEPS, TP4_BATCH), dtype=torch.int32,
                           device="cuda")
    dist.broadcast(feed, 0)
    params = param_shardings(init_params(cfg, seed=cs.SEED,
                                         dtype=torch.bfloat16,
                                         device="cuda"), mesh, fsdp="off")
    torch.cuda.empty_cache()
    per_rank = sum(p.to_local().numel() * p.element_size()
                   for p in params.parameters())
    t0 = time.perf_counter()
    got, _, n = cs._shard_run(cfg, params, toks, feed, tp_axis="model",
                              kernel_backend="cuda")
    wall = time.perf_counter() - t0
    if rank == 0:
        diffs = [float((a - b).abs().max()) for a, b in zip(got, ref)]
        gaps = [float((g.max(-1).values - g.gather(
            -1, feed[i].long()[:, None])[:, 0]).max())
            for i, g in enumerate(got[:TP4_STEPS])]
        same = sum(int((g.argmax(-1) == feed[i]).sum())
                   for i, g in enumerate(got[:TP4_STEPS]))
        cs.log(f"[tp4] {TP4_ARCH} ({TP4_LAYERS} of "
               f"{get_config(TP4_ARCH).num_layers} layers, full width) on "
               f"1x4 (data, model), fsdp off: {per_rank / 1e9:.2f} GB of "
               f"weights a rank; prefill {TP4_PROMPT} x {TP4_BATCH} + "
               f"{TP4_STEPS} decode steps {wall:.2f} s; largest |logit - "
               f"twin| per call {['%.4f' % d for d in diffs]}; greedy "
               f"tokens {same}/{TP4_STEPS * TP4_BATCH} the twin's, largest "
               f"gap {max(gaps):.4f} (margin {cs.LOGIT_MARGIN}); attention "
               f"launches {n['decode_attention'] + n['flash_attention_pool']}")
        assert max(gaps) <= cs.LOGIT_MARGIN, gaps
    dist.barrier()
    dist.destroy_process_group()


def tp4():
    """Start the four ``tp4`` ranks and wait for them."""
    import socket
    import subprocess
    if torch.cuda.device_count() < 4:
        raise SystemExit(f"tp4 needs four GPUs, {torch.cuda.device_count()} "
                         "visible")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "tp4-rank", str(r), str(port)])
             for r in range(4)]
    rcs = [p.wait(timeout=1800) for p in procs]
    if any(rcs):
        raise SystemExit(f"tp4 ranks exited {rcs}")


def lr_trials(arch, lrs):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import train
    torch.set_float32_matmul_precision("highest")
    cut = cs.TRAIN_FAMILIES[arch]
    cfg = get_config(arch).with_overrides(**cut) if cut else get_config(arch)
    batch = cs.TRAIN_BATCH if cfg.frontend == "none" else \
        cs.TRAIN_FRONTEND_BATCH
    frontend = cs._frontend_emb(cfg, batch, torch.float32, cs.SEED + 4)
    for lr in lrs:
        params = init_params(cfg, seed=cs.SEED, dtype=torch.float32,
                             device="cuda")
        data = cs._train_data(cfg, batch, frontend)
        opt = AdamWConfig(lr=lr, warmup_steps=max(cs.TRAIN_STEPS // 10, 1),
                          total_steps=cs.TRAIN_STEPS)
        hist = train(cfg, params, data, opt, cs.TRAIN_STEPS, log_every=1,
                     log_fn=lambda *_: None, kernel_backend="cuda")[2]
        losses = [h["loss"] for h in hist]
        cs.log(f"[lr] {arch} cut {cut or 'none'} lr {lr}: losses "
               + ", ".join(f"{x:.4f}" for x in losses)
               + f"; falls at every step: "
               f"{all(b < a for a, b in zip(losses, losses[1:]))}")
        del params, hist
        cs._release()


def main(argv):
    if argv[:1] == ["tp4-rank"]:
        return tp4_rank(int(argv[1]), int(argv[2]))
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    smi = cs.device_phase()
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build(variants=[cs.MOE_FMA_SRC])
    cs.log(f"[build] {time.perf_counter() - t0:.1f} s")
    llama = None
    for phase in argv:
        t0 = time.perf_counter()
        name, _, rest = phase.partition(":")
        if name == "kernels":
            cs.kernel_phase()
        elif name == "serve":
            cs.full_width_serve_phase(rest)
            cs._release()
        elif name == "flash":
            cs.flash_kernel_phase()
        elif name == "train":
            for arch in [rest] if rest else list(cs.TRAIN_FAMILIES):
                cs.family_train_phase(arch, smi)
        elif name == "lr":
            arch, _, lrs = rest.partition(":")
            lr_trials(arch, [float(x) for x in lrs.split(",")])
        elif name == "examples":
            cs.examples_phase()
        elif name == "encdec":
            cs.encdec_phase(smi)
        elif name == "vision":
            cs.vision_phase(smi)
        elif name == "shard":
            cs.shard_phase(smi)
        elif name == "tp4":
            tp4()
        elif name == "dual" and rest and rest != cs.ARCH:
            cfg, params = cs._init(rest)
            cs.dual_phases(cfg, params, 2)
            del cfg, params
            cs._release()
        elif name in ("prefix_store", "dual"):
            if llama is None:
                llama = cs._init(cs.ARCH)
            if name == "prefix_store":
                cs.prefix_store_phase(*llama)
            else:
                cs.dual_phases(*llama, 6)
        else:
            raise SystemExit(f"unknown phase {phase!r}")
        cs.log(f"[phases] {phase} done in {time.perf_counter() - t0:.1f} s")
    cs.log(smi)
    cs.log("[phases] ok")


if __name__ == "__main__":
    main(sys.argv[1:])
