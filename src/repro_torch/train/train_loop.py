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

``batch_axes`` / ``tp_axis`` make the step a sharded program over the
parameters' ``DeviceMesh`` (``models.params.param_shardings``), as the
reference's do under GSPMD: the batch is split over ``batch_axes`` (each
rank keeps its rows of the same full batch), the gradients come back as
DTensors laid out as their parameters, and so do the AdamW moments
(``optimizer.init_opt_state``), as the reference's ``_opt_pspecs`` lays
them out.
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from repro_torch.models import forward
from repro_torch.models.params import P, param_placements
from repro_torch.models.sharding import is_dtensor, sharded_mesh
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         init_opt_state, param_leaves)


def _batch_shard(t, mesh, batch_axes):
    """A plain (B, ...) tensor, the same on every rank, as a DTensor split
    over ``batch_axes`` (each rank keeps its rows; no collective)."""
    if t is None or mesh is None or not batch_axes:
        return t
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(
        t, mesh, param_placements(P(batch_axes, *([None] * (t.ndim - 1))),
                                  mesh), src_data_rank=None)


def lm_loss(cfg, params, tokens, frontend_emb=None, *, q_chunk=512,
            kv_chunk=512, remat=True, batch_axes=None, tp_axis=None,
            kernel_backend="cuda"):
    """Next-token cross entropy in f32 plus ``router_aux_loss_coef`` times
    the MoE aux loss.  tokens: (B, S+1) -> predict [1:] from [:-1]; with
    prepended patches (vision) only the text positions, the logits' last
    S, are scored.  Sharded (``batch_axes`` / ``tp_axis``), the loss is a
    replicated DTensor scalar.  Returns (loss, {"nll", "aux"})."""
    mesh = sharded_mesh(params, batch_axes, tp_axis)
    tokens = _batch_shard(tokens, mesh, batch_axes)
    frontend_emb = _batch_shard(frontend_emb, mesh, batch_axes)
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    logits, aux = forward(cfg, params, inp, frontend_emb, q_chunk=q_chunk,
                          kv_chunk=kv_chunk, remat=remat,
                          batch_axes=batch_axes, tp_axis=tp_axis,
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
    state_dict name; sharded, each laid out as its parameter).  The
    gradients are also left in ``p.grad``."""
    for _, p in param_leaves(params):
        p.requires_grad_(True)
        p.grad = None
    loss, met = lm_loss(cfg, params, tokens, frontend_emb, **kw)
    if sharded_mesh(params, kw.get("batch_axes"), kw.get("tp_axis")):
        # the backward (and remat's recompute) meets the model's own plain
        # tensors, saved for it, as the forward did
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication():
            loss.backward()
    else:
        loss.backward()
    grads = {n: _like(p.grad, p) if p.grad is not None else
             torch.zeros_like(p) for n, p in param_leaves(params)}
    return loss.detach(), {k: v.detach() for k, v in met.items()}, grads


def _like(g, p):
    """A sharded gradient laid out as its parameter (a partial sum is
    reduce-scattered), as the reference's gradients take their
    parameters' shardings."""
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        g = g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(cfg, opt_cfg: AdamWConfig, *, q_chunk=512, kv_chunk=512,
                    remat=True, batch_axes=None, tp_axis=None,
                    kernel_backend="cuda") -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), updating the parameters in place.  batch = {"tokens":
    (B, S+1) int, ["frontend": (B, F, frontend_dim)]}, numpy or tensors;
    they are moved to the parameters' device (sharded: every rank holds
    the whole batch and keeps its rows)."""
    def train_step(params, opt_state, batch):
        dev = opt_state.step.device
        tokens = torch.as_tensor(batch["tokens"]).to(dev)
        fe = batch.get("frontend")
        if fe is not None:
            fe = torch.as_tensor(fe).to(dev)
        loss, met, grads = loss_and_grads(
            cfg, params, tokens, fe, q_chunk=q_chunk, kv_chunk=kv_chunk,
            remat=remat, batch_axes=batch_axes, tp_axis=tp_axis,
            kernel_backend=kernel_backend)
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
