"""Runtime helpers of the sharded model programs (DTensor on a
``DeviceMesh``): the layouts that the reference gets from GSPMD's
constraints, and the local blocks that DTensor is not asked to propagate.

* ``redistribute_to`` lays a DTensor out by a spec and, as
  ``jax.lax.with_sharding_constraint`` does with a cotangent, its gradient
  too: a view's backward then never meets an uneven head shard.
* ``split_heads`` / ``merge_heads`` keep a head axis sharded over the
  model axis only where the axis divides it.
* ``local_call`` runs attention and the WKV scan on each rank's own rows
  and heads, and the MoE's routed experts on its share of the slots,
  through ``local_map``: code that DTensor is not asked to propagate.
* ``constrain_rows`` gathers an activation's sharded features (Megatron's
  gather) before a product that shards its own output features.
* ``unshard`` is FSDP's per-layer weight gather over the data axes.
* ``local_rows`` gives a rank its rows of a batch-sharded cache leaf, which
  it writes in place.

Every helper is the identity on a plain tensor, or when the call is not
sharded (``ctx["mesh"]`` is ``None``).
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.models.params import P, mesh_axis_size, param_placements


def sharded_mesh(params, batch_axes=None, tp_axis=None):
    """The ``DeviceMesh`` of a sharded model call (``batch_axes`` or
    ``tp_axis`` given): the parameters' own; ``None`` unsharded.  Raises
    when the parameters are not DTensors, or when their mesh lacks an
    axis: a sharded call never runs unsharded."""
    if not batch_axes and not tp_axis:
        return None
    w = params["embed"]["w"]
    if not is_dtensor(w):
        raise ValueError("batch_axes / tp_axis need the parameters "
                         "distributed over a DeviceMesh (param_shardings)")
    mesh = w.device_mesh
    missing = [a for a in mesh_axes(batch_axes) + mesh_axes(tp_axis)
               if a not in mesh.mesh_dim_names]
    if missing:
        raise ValueError(f"mesh axes {missing} not in the parameters' mesh "
                         f"{mesh.mesh_dim_names}")
    return mesh


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def redistribute_to(t, spec):
    """``t`` laid out as ``spec`` over its own mesh, and its gradient too,
    as ``jax.lax.with_sharding_constraint`` constrains a value and its
    cotangent; a plain tensor is returned as it is."""
    if not is_dtensor(t):
        return t
    pl = tuple(param_placements(spec, t.device_mesh))
    if t.requires_grad and torch.is_grad_enabled():
        return _Constrain.apply(t, pl)
    if pl == tuple(t.placements):
        return t
    return t.redistribute(t.device_mesh, pl)


class _Constrain(torch.autograd.Function):
    """Redistribute a DTensor to ``placements`` and its gradient back to
    the same placements (where the gradient arrives laid out otherwise, a
    view's backward may not split a sharded axis)."""

    @staticmethod
    def forward(ctx, t, placements):
        ctx.placements = placements
        if tuple(t.placements) == placements:
            return t.view_as(t)
        return t.redistribute(t.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def local_rows(t, like):
    """This rank's part of ``t`` laid out as the DTensor ``like`` (a cache
    leaf, sharded only on its leading batch dim), as a local tensor: a
    DTensor is redistributed to ``like``'s placements, a plain tensor (the
    same on every rank) is cut to this rank's rows."""
    if is_dtensor(t):
        if tuple(t.placements) != tuple(like.placements):
            t = t.redistribute(like.device_mesh, like.placements)
        return t.to_local()
    mesh = like.device_mesh
    coord = mesh.get_coordinate()
    for i, p in enumerate(like.placements):
        if p.is_shard():
            assert p.dim == 0, like.placements
            t = t.chunk(mesh.size(i), 0)[coord[i]]
    return t


def replicated(ctx):
    """``implicit_replication()`` for a sharded call (``ctx["mesh"]``
    set), else nothing: the tensors the model makes itself (positions,
    RoPE tables, masks, zero states, dispatch indices) are the same on
    every rank and enter DTensor ops as replicated."""
    if ctx.get("mesh") is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


FSDP_AXES = ("pod", "data")


def unshard(tree, ctx):
    """FSDP: a layer's weights (a tree of parameters) gathered over the
    data axes for its forward, their model-axis sharding kept (each
    gradient comes back reduce-scattered to its shard).  The matmuls then
    see whole input dims, so DTensor shards their outputs as Megatron
    does and never mixes the data axes into the model axis's work.  The
    identity unsharded."""
    if ctx.get("mesh") is None:
        return tree
    if isinstance(tree, torch.Tensor):
        if not is_dtensor(tree):
            return tree
        mesh = tree.device_mesh
        pl = [replicate() if n in FSDP_AXES and p.is_shard() else p
              for n, p in zip(mesh.mesh_dim_names, tree.placements)]
        if pl == list(tree.placements):
            return tree
        return tree.redistribute(mesh, pl)
    return {k: unshard(tree[k], ctx) for k in tree.keys()}


def replicate():
    from torch.distributed.tensor import Replicate
    return Replicate()


def axis_size(ctx, name):
    return mesh_axis_size(ctx["mesh"], name)


def rows_spec(ctx, nd):
    """The spec of a (B, ...) tensor with its batch over ``batch_axes``."""
    return P(ctx.get("batch_axes"), *([None] * (nd - 1)))


def heads_spec(ctx, H=None, nd=4, dim=2):
    """The spec of a (B, S, H, ...) attention tensor: batch over
    ``batch_axes``, heads over ``tp_axis`` (only where the axis divides
    ``H``, when ``H`` is given: a view may not split an uneven shard)."""
    tp = ctx.get("tp_axis")
    spec = list(rows_spec(ctx, nd))
    if tp and (H is None or H % axis_size(ctx, tp) == 0):
        spec[dim] = tp
    return P(*spec)


def split_heads(t, H, hd, ctx):
    """(B, S, H * hd) -> (B, S, H, hd).  Sharded, the head axis is kept
    over ``tp_axis`` where the axis divides H and whole otherwise (8 kv
    heads over a model axis of 16: DTensor cannot view a head split
    through an uneven shard), before the view and, for the gradient,
    after it."""
    if ctx.get("mesh") is not None and is_dtensor(t):
        spec = heads_spec(ctx, H)
        t = redistribute_to(t, P(*spec[:2], spec[2]))
        return redistribute_to(t.reshape(t.shape[0], t.shape[1], H, hd),
                               spec)
    return t.reshape(t.shape[0], t.shape[1], H, hd)


def merge_heads(t, ctx):
    """(B, S, H, hd) -> (B, S, H * hd), the inverse of
    :func:`split_heads` (an uneven head shard gathered first)."""
    B, S, H, hd = t.shape
    if ctx.get("mesh") is not None and is_dtensor(t):
        spec = heads_spec(ctx, H)
        t = redistribute_to(t, spec).reshape(B, S, H * hd)
        return redistribute_to(t, P(*spec[:3]))
    return t.reshape(B, S, H * hd)


def placements(ctx, spec, partial=()):
    """The placements of ``spec`` on the call's mesh, with ``Partial()``
    on the mesh dims named in ``partial`` (a partial sum over them)."""
    from torch.distributed.tensor import Partial
    pl = param_placements(spec, ctx["mesh"])
    names = ctx["mesh"].mesh_dim_names
    return [Partial() if n in partial else p for n, p in zip(names, pl)]


def mesh_axes(axes) -> tuple:
    """A spec entry (``None``, a name or a tuple of names) as a tuple."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_index(ctx, axes) -> tuple:
    """(this rank's index, count) over the mesh axes ``axes`` together,
    major first."""
    i, n = 0, 1
    for a in mesh_axes(axes):
        size = axis_size(ctx, a)
        i, n = i * size + ctx["mesh"].get_local_rank(a), n * size
    return i, n


def local_call(ctx, fn, args, specs, out_specs, grad_partial=None,
               out_partial=None):
    """``fn(*args)``: directly when unsharded; sharded, on each rank's own
    blocks through ``local_map``.  Each DTensor argument is first laid out
    by its spec (``specs``, one per argument); a plain tensor or ``None``
    is passed whole (the model's own tensors, the same on every rank).
    The results are DTensors laid out by ``out_specs`` (a spec, or a tuple
    of specs for a tuple of results), partial sums over the mesh axes
    ``out_partial`` names for each result where given; ``grad_partial``
    names, for each argument, the axes over which its gradient from one
    rank is a partial sum (a replicated input that each rank uses only a
    part of).  Attention, the scans and the routed experts are
    independent across batch rows and heads (or slots), so each rank
    computes its part alone, as GSPMD partitions them in the reference."""
    if ctx.get("mesh") is None:
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map
    mesh = ctx["mesh"]
    args = [redistribute_to(a, sp) if is_dtensor(a) else a
            for a, sp in zip(args, specs)]
    in_pl = tuple(placements(ctx, sp) if is_dtensor(a) else None
                  for a, sp in zip(args, specs))
    grads = None
    if grad_partial is not None:
        grads = tuple(placements(ctx, sp, part) if is_dtensor(a) else None
                      for a, sp, part in zip(args, specs, grad_partial))
    # a list: local_map reads a tuple as one placement list per output
    if isinstance(out_specs, P):
        out_pl = placements(ctx, out_specs, (out_partial or [()])[0])
    else:
        out_pl = tuple(placements(ctx, sp, part) for sp, part in zip(
            out_specs, out_partial or [()] * len(out_specs)))
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=grads, device_mesh=mesh)(*args)


def constrain_rows(t, ctx):
    """``t`` (and its gradient) with its batch dim over ``batch_axes`` and
    every other dim whole: the Megatron gather of an activation whose
    feature dim is sharded before a product that shards that dim's
    output."""
    if ctx.get("mesh") is None:
        return t
    return redistribute_to(t, rows_spec(ctx, t.ndim))
