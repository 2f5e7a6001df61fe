"""Quickstart on the PyTorch port: train a small LM on the synthetic corpus,
then serve it through the Agent.xpu engine (real token generation under the
paper's scheduler) -- ``examples/quickstart.py`` over ``repro_torch``.

    PYTHONPATH=src python examples/quickstart_torch.py [--steps 200]
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

``--device cuda`` (the default) raises when no GPU is visible;
``--kernel-backend plain`` runs attention without the CUDA kernels.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs import get_tiny_config
from repro_torch.core.engine import RealAgentXPUEngine
from repro_torch.core.requests import Priority, Request
from repro_torch.data.pipeline import ByteTokenizer, PipelineConfig, batches
from repro_torch.models import init_params
from repro_torch.models.transformer import KERNEL_BACKENDS
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=96)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--kernel-backend", default="cuda",
                    choices=KERNEL_BACKENDS)
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda and no GPU is visible; pass "
                           "--device cpu to run on the CPU")

    tok = ByteTokenizer()
    cfg = get_tiny_config("llama3-405b").with_overrides(
        name="quickstart-lm", vocab_size=tok.vocab_size,
        num_layers=2, d_model=192, d_ff=512)
    print(f"model: {cfg.num_params()/1e6:.2f}M params "
          f"({cfg.num_layers}L d={cfg.d_model})")

    params = init_params(cfg, seed=0, dtype=torch.float32, device=device)
    data = batches(PipelineConfig(batch_size=args.batch, seq_len=args.seq,
                                  vocab_size=tok.vocab_size))
    params, _, hist = train(
        cfg, params, data,
        AdamWConfig(lr=2e-3, warmup_steps=20, total_steps=args.steps),
        args.steps, log_every=20, kernel_backend=args.kernel_backend)
    print(f"loss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")

    # serve two prompts through the paper's engine (reactive preempts)
    prompts = ["the scheduler ", "agent 7 schedules a "]
    reqs = []
    for i, p in enumerate(prompts):
        ids = tok.encode(p)[None, :]
        reqs.append(Request(
            id=i, priority=Priority.REACTIVE if i == 1 else Priority.PROACTIVE,
            prompt_len=ids.shape[1], max_new_tokens=32,
            arrival_time=0.02 * i, tokens=ids))
    with torch.no_grad():
        eng = RealAgentXPUEngine(cfg, params, max_len=256, device=device,
                                 kernel_backend=args.kernel_backend)
        m = eng.serve(reqs)
    for r in m.completed:
        text = tok.decode(eng.output_tokens(r.id))
        print(f"[{r.priority.name}] {prompts[r.id]!r} -> {text!r} "
              f"(ttft {r.ttft*1e3:.1f} ms simulated)")


if __name__ == "__main__":
    main()
