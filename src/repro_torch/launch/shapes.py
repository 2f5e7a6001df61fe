"""Assigned input shapes and meta-tensor stand-ins for the dry run: the
port's counterpart of ``repro.launch.shapes``.

Every model input is a tensor on the ``meta`` device (shape and dtype, no
storage), PyTorch's counterpart of a ``ShapeDtypeStruct``.  The four
assigned shapes:

    train_4k     seq 4096    global_batch 256   -> train_step
    prefill_32k  seq 32768   global_batch 32    -> prefill_step
    decode_32k   seq 32768   global_batch 128   -> serve_step (1 new token)
    long_500k    seq 524288  global_batch 1     -> serve_step, sub-quadratic

Modality frontends are STUBS: ``input_specs`` provides frame / patch
embeddings of the right shape (the one sanctioned carve-out).

``params_spec`` is ``init_params`` on the meta device, where it draws
nothing.  (Under ``FakeTensorMode`` instead, DTensor's sharding
propagation fails on the strided shards that flattening a batch- and
sequence-sharded activation makes: it computes their sizes with a
``.tolist()`` that a fake tensor cannot answer.)  Given a ``mesh``,
``input_specs`` lays the parameters, the batch and the cache out on it
(``models.params``' rules), as the reference's dry run lays its
``ShapeDtypeStruct``s out with ``in_shardings``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models import extend, init_cache, init_params
from repro_torch.models.params import batch_pspec, param_shardings
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_loop import make_train_step


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_supported(cfg, shape_name: str) -> tuple[bool, str]:
    """(supported, reason).  Skips recorded in DESIGN.md §Arch-applicability."""
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return False, ("full-attention arch without sliding-window variant: "
                       "a 500k dense KV cache is out of scope by assignment")
    return True, ""


def frontend_spec(cfg, batch: int, dtype=torch.bfloat16, device="meta"):
    if cfg.frontend == "none":
        return None
    return torch.empty((batch, cfg.frontend_tokens, cfg.frontend_dim),
                       dtype=dtype, device=device)


def decode_window(cfg, shape: ShapeSpec) -> Optional[int]:
    """Effective attention window when lowering a decode shape."""
    if shape.name == "long_500k":
        return cfg.long_context_window or cfg.sliding_window
    return cfg.sliding_window


def params_spec(cfg, dtype=torch.bfloat16, device="meta"):
    """The parameters' shapes and dtypes: ``init_params`` on the meta
    device."""
    return init_params(cfg, seed=0, dtype=dtype, device=device)


def _batch(t, mesh, n):
    """A (B, ...) input laid out over the data axes that divide its batch
    (``batch_pspec``); as it is without a mesh."""
    if mesh is None or t is None:
        return t
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models.params import param_placements
    spec = batch_pspec(mesh, n, t.ndim)
    return distribute_tensor(t, mesh, param_placements(spec, mesh),
                             src_data_rank=None)


def input_specs(cfg, shape_name: str, dtype=torch.bfloat16, batch_axes=None,
                tp_axis=None, q_chunk=512, kv_chunk=512, remat=True,
                capacity_factor=1.25, *, mesh=None, fsdp="auto",
                shape: Optional[ShapeSpec] = None, device="meta"):
    """(step_fn, args) of meta tensors for the given architecture x shape;
    with ``mesh``, laid out on it (parameters by ``param_pspecs`` at
    ``fsdp``, batch by ``batch_pspec``, cache by ``cache_pspecs``, the
    AdamW moments as the parameters).  ``shape`` overrides the named
    shape's sizes (small stand-ins for the tests)."""
    shape = shape or SHAPES[shape_name]
    B, S = shape.global_batch, shape.seq_len
    params = params_spec(cfg, dtype, device)
    if mesh is not None:
        param_shardings(params, mesh, fsdp=fsdp)

    if shape.kind == "train":
        n_text = S - (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
        batch = {"tokens": _batch(torch.zeros((B, n_text + 1),
                                              dtype=torch.int32,
                                              device=device), mesh, B)}
        fe = _batch(frontend_spec(cfg, B, dtype, device), mesh, B)
        if fe is not None:
            batch["frontend"] = fe
        opt = init_opt_state(params)
        step = make_train_step(cfg, AdamWConfig(), batch_axes=batch_axes,
                               tp_axis=tp_axis, q_chunk=q_chunk,
                               kv_chunk=kv_chunk, remat=remat,
                               kernel_backend="plain")
        return step, (params, opt, batch)

    if shape.kind == "prefill":
        n_text = S - (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
        tokens = _batch(torch.zeros((B, n_text), dtype=torch.int32,
                                    device=device), mesh, B)
        fe = _batch(frontend_spec(cfg, B, dtype, device), mesh, B)
        window = cfg.sliding_window

        def prefill_step(params, tokens, frontend_emb=None):
            from repro_torch.models import prefill as _prefill
            return _prefill(cfg, params, tokens, max_len=S, window=window,
                            frontend_emb=frontend_emb, dtype=dtype,
                            batch_axes=batch_axes, tp_axis=tp_axis,
                            q_chunk=q_chunk, kv_chunk=kv_chunk,
                            capacity_factor=capacity_factor,
                            kernel_backend="plain")

        args = (params, tokens) + ((fe,) if fe is not None else ())
        return prefill_step, args

    # decode: one new token against a seq_len-deep cache
    window = decode_window(cfg, shape)
    fe = _batch(frontend_spec(cfg, B, dtype, device), mesh, B)
    cache = init_cache(cfg, params, B, S, dtype, window=window,
                       frontend_emb=fe, mesh=mesh, device=device)
    tokens = _batch(torch.zeros((B, 1), dtype=torch.int32, device=device),
                    mesh, B)

    def serve_step(params, cache, tokens):
        return extend(cfg, params, cache, tokens, window=window,
                      batch_axes=batch_axes, tp_axis=tp_axis,
                      kernel_backend="plain")

    return serve_step, (params, cache, tokens)


__all__ = ["SHAPES", "ShapeSpec", "shape_supported", "frontend_spec",
           "decode_window", "params_spec", "input_specs"]
