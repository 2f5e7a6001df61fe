"""Training launcher of the port (``repro.launch.train``'s flags, plus
``--device`` and ``--kernel-backend``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        --steps 5 --batch 2 --seq 1024
    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-7b \
        --tiny --device cpu --steps 20 --batch 4 --seq 128

Initial parameters are f32 (random, from ``--seed``), as the reference's
launcher makes them; the data is the synthetic byte corpus with ids clipped
to 259.  ``--device cuda`` (the default) raises when no GPU is visible.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_tiny_config
from repro_torch.data.pipeline import PipelineConfig, batches
from repro_torch.models import check_trainable, init_params
from repro_torch.models.transformer import KERNEL_BACKENDS
from repro_torch.train.checkpoint import (latest_checkpoint,
                                          restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_loop import make_train_step


def main(argv=None):
    """Run the launcher; returns the logged steps' metrics (host floats,
    with the step's wall ``elapsed`` seconds since the first step began and
    ``tok_s``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--tiny", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--kernel-backend", default="cuda",
                    choices=KERNEL_BACKENDS)
    args = ap.parse_args(argv)

    cfg = get_tiny_config(args.arch) if args.tiny else get_config(args.arch)
    cfg = cfg.with_overrides(vocab_size=max(cfg.vocab_size, 259)) \
        if cfg.vocab_size < 259 else cfg
    check_trainable(cfg)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda and no GPU is visible; pass "
                           "--device cpu to train on the CPU")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"[train] arch={cfg.name} params={cfg.num_params()/1e6:.1f}M "
          f"device={name} kernel_backend={args.kernel_backend}", flush=True)

    params = init_params(cfg, seed=args.seed, dtype=torch.float32,
                         device=device)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps)
    opt_state = init_opt_state(params)
    start_step = 0
    if args.resume and args.ckpt_dir:
        path = latest_checkpoint(args.ckpt_dir)
        if path:
            params, opt_state, start_step = restore_checkpoint(
                path, params, opt_state)
            print(f"[train] resumed from {path} (step {start_step})")

    data = batches(PipelineConfig(batch_size=args.batch, seq_len=args.seq,
                                  vocab_size=min(cfg.vocab_size, 259),
                                  seed=args.seed))
    step_fn = make_train_step(cfg, opt_cfg,
                              kernel_backend=args.kernel_backend)

    history = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        params, opt_state, met = step_fn(params, opt_state, next(data))
        if step % args.log_every == 0 or step == args.steps - 1:
            met = {k: float(v) for k, v in met.items()}  # waits for the step
            elapsed = time.time() - t0
            tok_s = args.batch * args.seq * (step - start_step + 1) \
                / max(elapsed, 1e-9)
            history.append(dict(met, step=step, elapsed=elapsed,
                                tok_s=tok_s))
            print(f"step {step:5d}  loss {met['loss']:.4f}  "
                  f"lr {met['lr']:.2e}  gnorm {met['grad_norm']:.3f}  "
                  f"tok/s {tok_s:.0f}", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, step + 1, params, opt_state)
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, args.steps, params, opt_state)
    print("[train] done", flush=True)
    return history


if __name__ == "__main__":
    main()
