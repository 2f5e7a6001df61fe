"""AdamW with cosine schedule and global-norm clipping.

The port's counterpart of ``repro.train.optimizer``, with the same math:
moments in f32, the update computed in f32 and cast back to the parameter's
dtype, no weight decay on norms, biases and scalar gains.  Where the
reference returns new trees, this updates the parameters, the moments and
the gradients (as scratch) in place, one leaf at a time, so the update
needs at most a leaf's worth of extra memory.  The state holds the moments
by the parameters' ``state_dict`` names; leaves are walked in the order of
the reference's ``tree_flatten_with_path`` (sorted keys at every level).
Sharded parameters (DTensors) get moments laid out as they are, and the
update runs on each rank's shards (the global norm is reduced over the
mesh).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Tuple

import torch

from repro_torch.models.sharding import is_dtensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    m: Dict[str, torch.Tensor]  # f32, by state_dict name
    v: Dict[str, torch.Tensor]


def param_leaves(params) -> List[Tuple[str, torch.Tensor]]:
    """(state_dict name, tensor) of every parameter, in the order of the
    reference's ``tree_flatten_with_path`` (its dicts flatten by sorted
    keys)."""
    return sorted(params.named_parameters(),
                  key=lambda kv: tuple(kv[0].split(".")))


def init_opt_state(params) -> AdamWState:
    leaves = param_leaves(params)
    dev = leaves[0][1].device
    zeros = lambda: {n: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
                     if is_dtensor(p) else
                     torch.zeros(p.shape, dtype=torch.float32, device=dev)
                     for n, p in leaves}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros(), v=zeros())


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``: an f32 scalar
    on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * (step + 1) / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.minimum(warm, cfg.lr * cos)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in f32 (an f32 tensor
    is read in place, with no squared copy; a DTensor's is reduced over
    its mesh)."""
    sq = [t.float().square().sum().full_tensor() if is_dtensor(t) else
          torch.dot(t.float().reshape(-1), t.float().reshape(-1))
          for t in tensors]
    return torch.sqrt(torch.stack(sq).sum())


_NO_DECAY = {"norm1", "norm2", "norm_x", "final_norm", "kv_norm", "ln_w",
             "ln_b", "w0", "u", "lam", "conv_b", "b_a", "b_i", "bq", "bk",
             "bv"}


def _decay_mask(path) -> bool:
    """No weight decay on norms / biases / scalar gains.  ``path``: the
    leaf's name split into its keys."""
    return not any(str(e) in _NO_DECAY for e in path)


@torch.no_grad()
def adamw_update(opt_cfg: AdamWConfig, params, grads, state: AdamWState):
    """One AdamW step over every parameter, in place.  ``grads``: by
    state_dict name (consumed: each is used as scratch).  Returns (params,
    new state, {"lr", "grad_norm"})."""
    leaves = param_leaves(params)
    if any(is_dtensor(p) for _, p in leaves):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication():  # the scalars meet the shards
            return _adamw_update(opt_cfg, leaves, params, grads, state)
    return _adamw_update(opt_cfg, leaves, params, grads, state)


def _adamw_update(opt_cfg, leaves, params, grads, state):
    gnorm = global_norm(grads[n] for n, _ in leaves)
    scale = torch.clamp(opt_cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_at(opt_cfg, state.step)
    b1, b2 = opt_cfg.b1, opt_cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf
    for name, p in leaves:
        g = grads[name]
        g = g.mul_(scale) if g.dtype == torch.float32 else g.float() * scale
        m, v = state.m[name], state.v[name]
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = (v / bc2).sqrt_().add_(opt_cfg.eps)
        delta = torch.div(m, bc1, out=g).div_(denom)  # g is scratch now
        del denom
        if _decay_mask(name.split(".")):
            delta.add_(p.float(), alpha=opt_cfg.weight_decay)
        delta.mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_((p.float() - delta).to(p.dtype))
    return params, AdamWState(step=step, m=state.m, v=state.v), {
        "lr": lr, "grad_norm": gnorm}
