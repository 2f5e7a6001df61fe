"""Flat-npz checkpointing with resume, in ``repro.train.checkpoint``'s
format: one ``step_<n>.npz`` whose leaves sit under slash-joined path keys
(``params/blocks/0/attn/wq``, ``opt/.step``, ``opt/.m/...``, ``opt/.v/...``,
as the reference's ``tree_flatten_with_path`` names them) and a
``latest.json`` pointing at it.  A checkpoint of either package restores in
the other.  bf16 leaves are stored as the reference stores them (2-byte
void, its ``ml_dtypes.bfloat16`` as numpy writes it) and move through their
uint16 view.  Restore checks every leaf's shape against the template, so
shape drift fails loudly.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.train.optimizer import AdamWState, param_leaves


def _key(name: str) -> str:
    return name.replace(".", "/")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _to_tensor(a: np.ndarray, like: torch.Tensor, key: str) -> torch.Tensor:
    if tuple(a.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {key}: shape {a.shape} does not "
                         f"match the template's {tuple(like.shape)}")
    if (a.dtype.kind == "V" and a.dtype.itemsize == 2) \
            or a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                             .copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(like.dtype)


def save_checkpoint(ckpt_dir: str, step: int, params,
                    opt_state: Optional[AdamWState] = None,
                    extra: Optional[dict] = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    blobs = {f"params/{_key(n)}": _to_numpy(p)
             for n, p in param_leaves(params)}
    if opt_state is not None:
        blobs["opt/.step"] = _to_numpy(opt_state.step.to(torch.int32))
        for part in ("m", "v"):
            blobs.update({f"opt/.{part}/{_key(n)}": _to_numpy(t) for n, t
                          in getattr(opt_state, part).items()})
    np.savez(path + ".tmp.npz", **blobs)
    os.replace(path + ".tmp.npz", path)
    meta = {"step": step, **(extra or {})}
    with open(os.path.join(ckpt_dir, "latest.json"), "w") as f:
        json.dump({"path": path, **meta}, f)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    meta = os.path.join(ckpt_dir, "latest.json")
    if not os.path.exists(meta):
        return None
    with open(meta) as f:
        return json.load(f)["path"]


@torch.no_grad()
def restore_checkpoint(path: str, params_template,
                       opt_template: Optional[AdamWState] = None
                       ) -> Tuple[object, Optional[AdamWState], int]:
    """Copy the checkpoint's leaves into ``params_template`` (and the
    moments into ``opt_template``), in place, on their devices.  Returns
    (params, opt_state, step)."""
    data = np.load(path)
    for n, p in param_leaves(params_template):
        key = f"params/{_key(n)}"
        p.copy_(_to_tensor(data[key], p, key))
    opt_state = None
    if opt_template is not None:
        for part in ("m", "v"):
            for n, t in getattr(opt_template, part).items():
                key = f"opt/.{part}/{_key(n)}"
                t.copy_(_to_tensor(data[key], t, key))
        step = torch.as_tensor(np.asarray(data["opt/.step"]),
                               dtype=torch.int32,
                               device=opt_template.step.device)
        opt_state = AdamWState(step=step, m=opt_template.m,
                               v=opt_template.v)
    step = int(os.path.basename(path).split("_")[1].split(".")[0])
    return params_template, opt_state, step
