"""Encoder-decoder and vision-prefix cases shared by the CPU parity tests
(tests/test_torch_models.py, against the JAX reference) and the on-card
tests (tests/test_torch_cuda.py, the kernels against the plain path): the
tiny ``whisper-tiny`` and ``llava-next-34b`` configs, variants whose
``frontend_dim`` is not ``d_model`` (so the weights hold
``frontend_proj``), and tokens and frames drawn with numpy from fixed
seeds.  JAX is imported only inside the functions that run the
reference, so the on-card tests import this module where JAX is absent."""
import functools

import numpy as np

WHISPER, LLAVA = "whisper-tiny", "llava-next-34b"
# a variant whose frontend delivers PROJ_DIM-wide embeddings
PROJ = "+proj"
PROJ_DIM = 96
FRONTEND_ARCHS = [WHISPER, LLAVA, WHISPER + PROJ, LLAVA + PROJ]
# the end-to-end parity runs: both forms, and the projected prepend (the
# projected encoder is held by itself)
PARITY_ARCHS = [WHISPER, LLAVA, LLAVA + PROJ]
# the prompt of the parity runs, and the cache they build
PROMPT, MAX_LEN = 12, 48


def frontend_tiny(get_tiny_config, arch):
    """The tiny config of ``arch`` from either framework's
    ``get_tiny_config`` (both are equal), or its ``+proj`` variant."""
    cfg = get_tiny_config(arch.removesuffix(PROJ))
    if arch.endswith(PROJ):
        cfg = cfg.with_overrides(name=cfg.name + "-proj",
                                 frontend_dim=PROJ_DIM)
    return cfg


def tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape,
                                                dtype=np.int32)


def frames(cfg, batch, seed=2):
    """(batch, frontend_tokens, frontend_dim) f32 frame (whisper) or patch
    (llava) embeddings, as the reference's stub delivers them."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, cfg.frontend_tokens,
                                cfg.frontend_dim), dtype=np.float32) * 0.5


@functools.lru_cache(maxsize=None)
def weights(arch):
    """(jcfg, the reference's f32 ``init_params`` as numpy, tcfg)."""
    import jax
    import jax.numpy as jnp
    from repro import models as J
    from repro.configs import get_tiny_config as j_tiny
    from repro_torch.configs import get_tiny_config as t_tiny
    jcfg, tcfg = frontend_tiny(j_tiny, arch), frontend_tiny(t_tiny, arch)
    jp = jax.tree_util.tree_map(
        np.asarray, J.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32))
    return jcfg, jp, tcfg


def port(jp):
    """A fresh port module holding the reference's weights."""
    from repro_torch import models as T
    return T.module_from_state_dict(T.from_jax_params(jp))


@functools.lru_cache(maxsize=None)
def jax_serve(arch):
    """The reference on ``tokens(cfg, (2, PROMPT))`` and ``frames(cfg,
    2)``: the training forward's logits, a prefill into a ``MAX_LEN``
    cache, a 3-token ``extend`` (C > 1) after it, one decode step (C == 1)
    on the chunk's argmax and an 8-step ``decode_run`` from the step's
    argmax, every row active.  Returns numpy arrays (the inputs it chose
    among them)."""
    import jax.numpy as jnp
    from repro import models as J
    jcfg, jp, _ = weights(arch)
    toks, fe = tokens(jcfg, (2, PROMPT)), frames(jcfg, 2)
    out = {"forward": J.forward(jcfg, jp, jnp.asarray(toks),
                                jnp.asarray(fe))[0]}
    out["prefill"], cache = J.prefill(jcfg, jp, jnp.asarray(toks),
                                      max_len=MAX_LEN, dtype=jnp.float32,
                                      frontend_emb=jnp.asarray(fe))
    out["chunk"] = tokens(jcfg, (2, 3), seed=3)
    out["extend"], cache = J.extend(jcfg, jp, cache,
                                    jnp.asarray(out["chunk"]))
    out["step"] = np.asarray(jnp.argmax(out["extend"], -1),
                             np.int32)[:, None]
    out["decode"], cache = J.extend(jcfg, jp, cache,
                                    jnp.asarray(out["step"]))
    out["last"] = np.asarray(jnp.argmax(out["decode"], -1), np.int32)
    out["stream"], _, cache = J.decode_run(
        jcfg, jp, cache, jnp.asarray(out["last"]),
        jnp.ones((2,), bool), 8)
    out["pos"] = cache["pos"]
    return {k: np.array(v) for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads(arch, S):
    """(loss, nll, aux, grads by the port's state_dict names) of
    ``jax.value_and_grad`` of the reference's ``lm_loss`` on
    ``tokens(cfg, (2, S + 1))`` and ``frames(cfg, 2)``."""
    import jax
    import jax.numpy as jnp
    from repro.train.train_loop import lm_loss
    jcfg, jp, _ = weights(arch)
    toks = jnp.asarray(tokens(jcfg, (2, S + 1)))
    fe = jnp.asarray(frames(jcfg, 2))
    (loss, met), grads = jax.value_and_grad(
        lambda p: lm_loss(jcfg, p, toks, fe), has_aux=True)(jp)
    named = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path): np.asarray(g)
             for path, g in jax.tree_util.tree_leaves_with_path(grads)}
    return float(loss), float(met["nll"]), float(met["aux"]), named
