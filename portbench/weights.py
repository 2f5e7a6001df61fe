"""Random weights for a configuration, drawn on the device from the seed.

The benchmark, not the program, makes the weights: it reads the shapes and
dtypes of the port's parameter tree (``init_params`` on the meta device,
which draws nothing), draws every leaf of one dtype from one
``torch.Generator`` on the device in a few large calls, and scales each
leaf by its kind.  The same flat dict of tensors goes to the port (as its
``ParamTree``) and to the plain reference, which reads the leaves by their
tree paths.
"""
from __future__ import annotations

import torch

# elements drawn per call (the generator's calls stay well below 2**31)
_DRAW = 1 << 30


def _scale_of(name: str, n_layers: int):
    """(std, offset) of a leaf, by the last parts of its tree path."""
    leaf = name.rsplit(".", 1)[-1]
    parent = name.rsplit(".", 2)[-2] if name.count(".") >= 1 else ""
    if leaf == "w" and parent in ("norm1", "norm2", "final_norm"):
        return 0.05, 1.0
    if leaf == "kv_norm":
        return 0.05, 1.0
    if leaf in ("wo", "w2"):
        return 0.02 / (2 * n_layers) ** 0.5, 0.0
    return 0.02, 0.0


def draw(cfg, seed: int, device, dtype=torch.bfloat16) -> dict:
    """{tree path: tensor} for ``cfg`` (a port ``ModelConfig``): every
    leaf normal with its kind's std (``_scale_of``) plus its offset, in the
    dtype the port's tree gives it (``dtype``, or f32 for the router)."""
    from repro_torch.models import init_params
    meta = init_params(cfg, dtype=dtype, device="meta").state_dict()
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = {}
    by_dtype: dict = {}
    for name, t in meta.items():
        by_dtype.setdefault(t.dtype, []).append((name, t.shape))
    for dt, leaves in by_dtype.items():
        total = sum(torch.Size(s).numel() for _, s in leaves)
        flat = torch.empty(total, dtype=dt, device=device)
        for lo in range(0, total, _DRAW):
            hi = min(total, lo + _DRAW)
            torch.randn(hi - lo, generator=gen, dtype=dt, device=device,
                        out=flat[lo:hi])
        off = 0
        for name, shape in leaves:
            n = torch.Size(shape).numel()
            leaf = flat[off:off + n].view(shape)
            std, base = _scale_of(name, cfg.num_layers)
            leaf.mul_(std)
            if base:
                leaf.add_(base)
            out[name] = leaf
            off += n
    return out


def as_port_params(flat: dict):
    """The port's parameter module over the same tensors (no copy)."""
    from repro_torch.models.params import to_module, tree_from_state_dict
    return to_module(tree_from_state_dict(flat))
