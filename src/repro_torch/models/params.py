"""Parameter containers, and weights carried across from the JAX reference.

The model's parameters are an ``nn.Module`` tree whose ``state_dict`` keys
are the reference's tree paths (``embed.w``, ``blocks.0.attn.wq``, ...),
with ``blocks`` leaves stacked on a leading repeats axis as in the
reference.  Its nodes (``ParamTree``) index like the nested dicts the model
functions were written against, so the functions take either.  A node may
hold tensors and subtrees side by side, as the MoE block does (an f32
``router`` beside the ``experts`` and ``shared`` subtrees).

The sharding rules for the production meshes (``param_pspecs``,
``batch_pspec``, ``cache_pspecs``) are the reference's, logic unchanged:
name-based, the last path component of each leaf decides which dims get
"model" (tensor parallel) and which the FSDP axes ("data", plus "pod" on
the multi-pod mesh); a dim is sharded only if it divides evenly by the
axes' extent.  A spec is a :class:`PartitionSpec`, a tuple with one entry
per tensor dim (``None``, an axis name, or a tuple of axis names) that
prints like the reference's and compares equal to ``tuple(P(...))``.  The
rules read only ``axis_names`` (or ``mesh_dim_names``) and the axis sizes
of ``mesh``, so they run without a process group; ``param_placements`` and
``param_shardings`` turn specs into DTensor placements on a
``DeviceMesh``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn


class ParamTree(nn.Module):
    """One node of the parameter tree: tensors as parameters, subtrees as
    submodules, indexed by name like a dict, in insertion order."""

    def __init__(self, tree):
        super().__init__()
        self._names = list(tree)
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=False))
            else:
                self.add_module(k, ParamTree(v))

    def __getitem__(self, key):
        if key not in self._names:
            raise KeyError(key)
        return getattr(self, key)

    def __contains__(self, key) -> bool:
        return key in self._names

    def keys(self):
        return list(self._names)


def to_module(tree) -> nn.Module:
    """Nested dict of tensors -> ``ParamTree`` (inference weights:
    ``requires_grad=False``)."""
    return ParamTree(tree)


def tree_from_state_dict(sd) -> dict:
    """Flat ``state_dict`` (dotted keys) -> nested dict."""
    tree: dict = {}
    for key, val in sd.items():
        node = tree
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def module_from_state_dict(sd, device=None) -> nn.Module:
    """Build the parameter module from a flat ``state_dict``."""
    tree = tree_from_state_dict(
        {k: (v.to(device) if device is not None else v)
         for k, v in sd.items()})
    return to_module(tree)


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16, not imported here
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def from_jax_params(tree, prefix: str = "") -> dict:
    """The reference's ``init_params`` tree, given as numpy arrays (or
    anything ``np.asarray`` takes), as the port's flat ``state_dict``.  bf16
    leaves are moved bit for bit through their uint16 view.  Empty tuples
    (the reference's ``head``/``tail`` of a homogeneous trunk) add no key."""
    out = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: _to_tensor(tree)}
    for k, v in items:
        out.update(from_jax_params(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


# ============================ sharding rules ================================
class PartitionSpec(tuple):
    """Per-dim mesh axes of a tensor: ``None`` (replicated), an axis name,
    or a tuple of axis names (sharded over their product, major first).  A
    one-name tuple becomes the name, as in JAX's ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return "PartitionSpec(" + ", ".join(repr(e) for e in self) + ")"


P = PartitionSpec


def mesh_axis_names(mesh) -> tuple:
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = mesh.mesh_dim_names
    return tuple(names)


def mesh_axis_size(mesh, name: str) -> int:
    """Extent of one named axis of a ``DeviceMesh`` or of any object with
    ``axis_names`` and a ``shape`` mapping (the reference's ``Mesh``)."""
    shape = getattr(mesh, "shape", None)
    if isinstance(shape, dict):
        return int(shape[name])
    return int(mesh.size(mesh_axis_names(mesh).index(name)))


def _axis_size(mesh, axes) -> int:
    if axes is None or axes == "__none__":
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return int(np.prod([mesh_axis_size(mesh, a) for a in axes]))


# (in_axis_spec, out_axis_spec) applied to the trailing two dims.
# fsdp = the data(-pod) axes; "model" = tensor axis.
_IN_OUT = {"FSDP_MODEL": ("fsdp", "model"), "MODEL_FSDP": ("model", "fsdp")}

# last-two-dims rule per leaf name
_RULES = {
    # projections with (d_in, d_out): shard in over fsdp, out over model
    "wq": "FSDP_MODEL", "wk": "FSDP_MODEL", "wv": "FSDP_MODEL",
    "w1": "FSDP_MODEL", "wg": "FSDP_MODEL",
    "w_q": "FSDP_MODEL", "w_dkv": "FSDP_MODEL", "w_krope": "FSDP_MODEL",
    "wr": "FSDP_MODEL", "w_lora_a": "FSDP_MODEL",
    "wk_cm": "FSDP_MODEL", "wr_cm": "FSDP_MODEL",
    "w_x": "FSDP_MODEL", "w_gate": "FSDP_MODEL", "w_a": "FSDP_MODEL",
    "w_i": "FSDP_MODEL",
    "xq": "FSDP_MODEL", "xk": "FSDP_MODEL", "xv": "FSDP_MODEL",
    # output projections (d_out_big, d): shard in over model, out over fsdp
    "wo": "MODEL_FSDP", "w2": "MODEL_FSDP", "wv_cm": "MODEL_FSDP",
    "w_out": "MODEL_FSDP", "xo": "MODEL_FSDP",
}


def _leaf_spec(path: Tuple[str, ...], shape, mesh, fsdp) -> PartitionSpec:
    name = path[-1]
    ndim = len(shape)
    model_n = _axis_size(mesh, "model")
    fsdp_n = _axis_size(mesh, fsdp)
    if fsdp == "__none__":
        fsdp = None  # spec entries become replicated

    def ok(dim_idx, ax_n):
        return ax_n > 1 and shape[dim_idx] % ax_n == 0

    spec = [None] * ndim
    if name == "w" and path[-2] == "embed":
        if ok(0, model_n):
            spec[0] = "model"
        if ok(1, fsdp_n):
            spec[1] = fsdp
    elif name == "w" and path[-2] == "lm_head":
        if ok(0, fsdp_n):
            spec[0] = fsdp
        if ok(1, model_n):
            spec[1] = "model"
    elif name == "w" and path[-2] == "frontend_proj":
        if ok(1, model_n):
            spec[1] = "model"
    elif name in ("router",):
        if ok(ndim - 2, fsdp_n):
            spec[ndim - 2] = fsdp
    elif name in ("w_uk", "w_uv"):  # (.., r, H, dn)
        if ok(ndim - 3, fsdp_n):
            spec[ndim - 3] = fsdp
        if ok(ndim - 2, model_n):
            spec[ndim - 2] = "model"
    elif name in _RULES and ndim >= 2:
        a_in, a_out = _IN_OUT[_RULES[name]]
        ax_i = fsdp if a_in == "fsdp" else "model"
        ax_o = fsdp if a_out == "fsdp" else "model"
        if ok(ndim - 2, _axis_size(mesh, ax_i)):
            spec[ndim - 2] = ax_i
        if ok(ndim - 1, _axis_size(mesh, ax_o)):
            spec[ndim - 1] = ax_o
    elif ndim >= 1 and name in ("conv_w", "lam", "conv_b", "b_a", "b_i"):
        if ok(ndim - 1, model_n):
            spec[ndim - 1] = "model"
    elif ndim >= 1 and name in ("bq", "bk", "bv"):
        if ok(ndim - 1, model_n):
            spec[ndim - 1] = "model"
    # everything else (norms, mus, u, w0, biases): replicated
    return PartitionSpec(*spec)


def _named_leaves(tree, prefix=()):
    """(path tuple, leaf) of a ``ParamTree`` (its ``named_parameters``),
    or of a nested dict / tuple of tensors (a cache)."""
    if isinstance(tree, nn.Module):
        return [(tuple(n.split(".")), p) for n, p in tree.named_parameters()]
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += _named_leaves(v, prefix + (str(k),))
    return out


def param_pspecs(params, mesh, *, multi_pod: Optional[bool] = None,
                 fsdp: str = "auto") -> dict:
    """{state_dict name: PartitionSpec} of every parameter of ``params``
    (the model's ``ParamTree``, or a nested dict of tensors or fake
    tensors).

    fsdp="auto": weights 2-D sharded (FSDP over data axes + TP over model) —
    the training layout.  fsdp="off": weights sharded over the model axis
    only and replicated across data (serving layout: no per-step weight
    all-gathers at the cost of data-axis weight replication)."""
    axis_names = mesh_axis_names(mesh)
    if fsdp == "off":
        fsdp_axes = "__none__"
    else:
        fsdp_axes = ("pod", "data") if "pod" in axis_names else "data"
    return {".".join(path): _leaf_spec(path, leaf.shape, mesh, fsdp_axes)
            for path, leaf in _named_leaves(params)}


def batch_pspec(mesh, batch_size: int, ndim: int) -> PartitionSpec:
    """Shard the leading batch dim over as many data axes as divide it."""
    axis_names = mesh_axis_names(mesh)
    cand = [a for a in ("pod", "data") if a in axis_names]
    use = []
    n = 1
    for a in cand:
        if batch_size % (n * mesh_axis_size(mesh, a)) == 0:
            use.append(a)
            n *= mesh_axis_size(mesh, a)
    first = tuple(use) if use else None
    return PartitionSpec(first, *([None] * (ndim - 1)))


def _cache_leaf_spec(path, shape, mesh, batch_size) -> PartitionSpec:
    if path[-1] == "pos":
        return batch_pspec(mesh, batch_size, 1)
    # stacked (repeats, B, ...) leaves live under "blocks"
    nlead = 1 if "blocks" in path else 0
    spec = [None] * len(shape)
    bspec = batch_pspec(mesh, batch_size, 1)[0]
    if bspec is not None and shape[nlead] == batch_size:
        spec[nlead] = bspec
    return PartitionSpec(*spec)


def cache_pspecs(cache, mesh, batch_size: int) -> dict:
    """{path tuple: PartitionSpec} of every cache leaf: its batch dim
    sharded over the data axes that divide it (``pos`` too)."""
    return {path: _cache_leaf_spec(path, leaf.shape, mesh, batch_size)
            for path, leaf in _named_leaves(cache)}


def param_placements(spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim: a dim
    sharded over ("pod", "data") is ``Shard(i)`` on both mesh dims, in mesh
    order (JAX's major-to-minor order), every other mesh dim
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh_axis_names(mesh):
        dims = [i for i, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        assert len(dims) <= 1, (spec, name)
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def param_shardings(params, mesh, *, fsdp: str = "auto"):
    """Distribute the ``ParamTree`` ``params`` over the ``DeviceMesh``
    ``mesh`` in place, each parameter by :func:`param_pspecs`, and return
    it.  Every rank holds the same full weights (drawn from one seed, or
    carried across from the reference), so each keeps its own shard with
    no collective.  Parameters keep their ``requires_grad``."""
    from torch.distributed.tensor import distribute_module, distribute_tensor
    specs = param_pspecs(params, mesh, fsdp=fsdp)

    def partition(name, module, device_mesh):
        for pname, p in list(module.named_parameters(recurse=False)):
            full = f"{name}.{pname}" if name else pname
            d = distribute_tensor(p.data, device_mesh,
                                  param_placements(specs[full], device_mesh),
                                  src_data_rank=None)
            module.register_parameter(
                pname, nn.Parameter(d, requires_grad=p.requires_grad))

    return distribute_module(params, mesh, partition)
