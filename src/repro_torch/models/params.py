"""Parameter containers, and weights carried across from the JAX reference.

The model's parameters are an ``nn.Module`` tree whose ``state_dict`` keys
are the reference's tree paths (``embed.w``, ``blocks.0.attn.wq``, ...),
with ``blocks`` leaves stacked on a leading repeats axis as in the
reference.  Its nodes (``ParamTree``) index like the nested dicts the model
functions were written against, so the functions take either.  A node may
hold tensors and subtrees side by side, as the MoE block does (an f32
``router`` beside the ``experts`` and ``shared`` subtrees).
"""
from __future__ import annotations

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
