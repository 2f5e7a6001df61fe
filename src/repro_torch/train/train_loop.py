"""Training loop: the next-token loss, the train step, and a host-driven loop
(``repro.train.train_loop``'s counterparts).

A step is ``loss.backward()`` then ``adamw_update``: eager PyTorch, with
no ``torch.compile``.  With ``kernel_backend="cuda"`` every attention
layer's forward runs the CUDA ``flash_attention`` kernel (twice under
remat: once in the forward, once in the backward's recompute) and its
backward the CUDA ``flash_attention_bwd`` kernel; the MoE expert products
and the recurrent scans run on the plain path
(``models.check_trainable``).  The MoE aux loss, summed over the layers by
``forward``, enters the loss at ``router_aux_loss_coef``.  A batch may
carry the frontend's embeddings under ``"frontend"``: an encoder-decoder's
frames, or a vision config's patches, whose positions the loss skips.
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from repro_torch.models import forward
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         init_opt_state, param_leaves)


def lm_loss(cfg, params, tokens, frontend_emb=None, *, q_chunk=512,
            kv_chunk=512, remat=True, kernel_backend="cuda"):
    """Next-token cross entropy in f32 plus ``router_aux_loss_coef`` times
    the MoE aux loss.  tokens: (B, S+1) -> predict [1:] from [:-1]; with
    prepended patches (vision) only the text positions, the logits' last
    S, are scored.  Returns (loss, {"nll", "aux"})."""
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    logits, aux = forward(cfg, params, inp, frontend_emb, q_chunk=q_chunk,
                          kv_chunk=kv_chunk, remat=remat,
                          kernel_backend=kernel_backend)
    logits = logits[:, -inp.shape[1]:].float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, tgt.long()[..., None])[..., 0]
    nll = (logz - gold).mean()
    loss = nll + cfg.router_aux_loss_coef * aux
    return loss, {"nll": nll, "aux": aux}


def loss_and_grads(cfg, params, tokens, frontend_emb=None, **kw):
    """``lm_loss`` and its gradient with respect to every parameter (as
    ``jax.value_and_grad`` gives it): returns (loss, metrics, grads by
    state_dict name).  The gradients are also left in ``p.grad``."""
    for _, p in param_leaves(params):
        p.requires_grad_(True)
        p.grad = None
    loss, met = lm_loss(cfg, params, tokens, frontend_emb, **kw)
    loss.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in param_leaves(params)}
    return loss.detach(), {k: v.detach() for k, v in met.items()}, grads


def make_train_step(cfg, opt_cfg: AdamWConfig, *, q_chunk=512, kv_chunk=512,
                    remat=True, kernel_backend="cuda") -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), updating the parameters in place.  batch = {"tokens":
    (B, S+1) int, ["frontend": (B, F, frontend_dim)]}, numpy or tensors;
    they are moved to the parameters' device."""
    def train_step(params, opt_state, batch):
        dev = opt_state.step.device
        tokens = torch.as_tensor(batch["tokens"]).to(dev)
        fe = batch.get("frontend")
        if fe is not None:
            fe = torch.as_tensor(fe).to(dev)
        loss, met, grads = loss_and_grads(
            cfg, params, tokens, fe, q_chunk=q_chunk, kv_chunk=kv_chunk,
            remat=remat, kernel_backend=kernel_backend)
        for _, p in param_leaves(params):
            p.grad = None  # the update consumes grads; free them after it
        params, opt_state, opt_met = adamw_update(opt_cfg, params, grads,
                                                  opt_state)
        del grads
        return params, opt_state, {"loss": loss, **met, **opt_met}

    return train_step


def train(cfg, params, data_iter, opt_cfg: AdamWConfig, num_steps: int,
          log_every: int = 10, log_fn=print, kernel_backend="cuda"):
    """The reference's host loop (single device).  Returns
    (params, opt_state, history), history holding the metrics of every
    logged step (each fetched to the host, which waits for the step) with
    its wall ``elapsed`` seconds."""
    opt_state = init_opt_state(params)
    step_fn = make_train_step(cfg, opt_cfg, kernel_backend=kernel_backend)
    history = []
    t0 = time.time()
    for step in range(num_steps):
        params, opt_state, met = step_fn(params, opt_state, next(data_iter))
        if step % log_every == 0 or step == num_steps - 1:
            met = {k: float(v) for k, v in met.items()}
            met.update(step=step, elapsed=time.time() - t0)
            history.append(met)
            log_fn(f"step {step:5d}  loss {met['loss']:.4f}  "
                   f"nll {met['nll']:.4f}  lr {met['lr']:.2e}  "
                   f"gnorm {met['grad_norm']:.3f}")
    return params, opt_state, history
