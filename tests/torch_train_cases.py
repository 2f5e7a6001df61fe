"""Training parity cases shared by tests/test_torch_models.py (the dense
and recurrent families) and tests/test_torch_moe.py (the MoE family): the
reference's f32 weights carried across, its training forward and
``jax.value_and_grad`` of its loss, cached per case so both kernel backends
are held to one reference run.

Limits: logits 3e-3 (the consistency tolerance), the aux loss
1e-5 relative, the loss 1e-5 relative and every gradient leaf 1e-4
relative L2 (f32 summation order only)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import models as J
from repro.configs import get_tiny_config as j_tiny
from repro.train.train_loop import lm_loss as j_lm_loss
from repro_torch import models as T
from repro_torch.configs import get_tiny_config as t_tiny
from torch_recurrent_cases import tiny

LOGITS_TOL = 3e-3
AUX_REL = LOSS_REL = 1e-5
GRAD_REL = 1e-4


@functools.lru_cache(maxsize=None)
def train_weights(arch):
    """(jcfg, jp as numpy, tcfg): the reference's f32 init; the qkv biases,
    zero at init, drawn at random so they count."""
    jcfg, tcfg = tiny(j_tiny, arch), tiny(t_tiny, arch)
    jp = jax.tree_util.tree_map(
        np.asarray, J.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32))
    if jcfg.qkv_bias:
        rng = np.random.default_rng(7)
        ap = jp["blocks"]["0"]["attn"]
        for n in ("bq", "bk", "bv"):
            ap[n] = (rng.standard_normal(ap[n].shape) * 0.5).astype(
                np.float32)
    return jcfg, jp, tcfg


def port(jp):
    """A fresh port module holding the reference's weights."""
    return T.module_from_state_dict(T.from_jax_params(jp))


def tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape,
                                                dtype=np.int32)


def _nll(logits, tgt, xp):
    """The next-token cross entropy of ``lm_loss`` in either framework
    (``xp`` is jnp or torch)."""
    if xp is torch:
        logits = logits.float()
        gold = logits.gather(-1, tgt.long()[..., None])[..., 0]
        return (torch.logsumexp(logits, dim=-1) - gold).mean()
    logits = logits.astype(jnp.float32)
    gold = jnp.take_along_axis(logits, tgt[..., None], axis=-1)[..., 0]
    return (jax.nn.logsumexp(logits, axis=-1) - gold).mean()


@functools.lru_cache(maxsize=None)
def jax_forward(arch, S, capacity_factor=1.25):
    """The reference's training forward on ``tokens(cfg, (2, S))``:
    (logits, aux) as numpy."""
    jcfg, jp, _ = train_weights(arch)
    logits, aux = J.forward(jcfg, jp, jnp.asarray(tokens(jcfg, (2, S))),
                            capacity_factor=capacity_factor)
    return np.asarray(logits), float(aux)


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads(arch, S, capacity_factor=None):
    """(loss, nll, grads by the port's state_dict names) of
    ``jax.value_and_grad`` on ``tokens(cfg, (2, S + 1))``: the reference's
    ``lm_loss``, or with a ``capacity_factor`` its loss formula over
    ``forward`` at that factor."""
    jcfg, jp, _ = train_weights(arch)
    toks = jnp.asarray(tokens(jcfg, (2, S + 1)))
    if capacity_factor is None:
        def loss_fn(p):
            return j_lm_loss(jcfg, p, toks)
    else:
        def loss_fn(p):
            logits, aux = J.forward(jcfg, p, toks[:, :-1],
                                    capacity_factor=capacity_factor)
            nll = _nll(logits, toks[:, 1:], jnp)
            return nll + jcfg.router_aux_loss_coef * aux, {"nll": nll}
    (loss, met), grads = jax.value_and_grad(loss_fn, has_aux=True)(jp)
    named = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path): np.asarray(g)
             for path, g in jax.tree_util.tree_leaves_with_path(grads)}
    return float(loss), float(met["nll"]), named


def port_loss_and_grads(tcfg, params, toks, capacity_factor, **kw):
    """The port's loss and gradients at ``capacity_factor``, the loss
    formula of ``lm_loss`` over ``forward``: (loss, nll, grads)."""
    from repro_torch.train.optimizer import param_leaves
    for _, p in param_leaves(params):
        p.requires_grad_(True)
        p.grad = None
    toks = torch.from_numpy(toks)
    logits, aux = T.forward(tcfg, params, toks[:, :-1],
                            capacity_factor=capacity_factor, **kw)
    nll = _nll(logits, toks[:, 1:], torch)
    loss = nll + tcfg.router_aux_loss_coef * aux
    loss.backward()
    return float(loss.detach()), float(nll.detach()), {
        n: p.grad for n, p in param_leaves(params)}


def assert_close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def assert_rel(got, want, rel, what):
    assert abs(got - want) <= rel * abs(want), (what, got, want)


def assert_grads_match(grads, want):
    """Every leaf present on both sides, each within GRAD_REL relative L2."""
    assert set(grads) == set(want)
    for name, w in want.items():
        g = grads[name].numpy()
        assert g.shape == w.shape, name
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= GRAD_REL, (name, rel)
