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
  visible.

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
