"""The two stage lanes of stage-decoupled execution (DESIGN.md §14), PyTorch
port of the dual-stage part of ``repro.launch.mesh``.

The reference stages prefill on a second JAX device (the paper's NPU beside
the iGPU, both on one DDR).  A lane here is a device and the stream its
work is issued on: with a second GPU visible the prefill lane is that GPU,
as in the reference; on one GPU it is the same GPU with a
``torch.cuda.Stream`` of its own, two lanes sharing HBM the way the NPU and
the iGPU share DDR.  Without a GPU there is one device and no second lane,
so the functions raise the typed :class:`MeshDeviceError`, as the reference
raises on one device.

Functions, never module-level constants: importing this module touches no
device state.
"""
from __future__ import annotations

from typing import NamedTuple, Optional


class MeshDeviceError(RuntimeError):
    """Raised when the visible devices cannot give the lanes a mesh needs.

    Carries ``requested`` / ``available`` so callers (the dual-device
    backend's co-located fallback, launch scripts) can branch on capacity
    instead of parsing a message."""

    def __init__(self, requested: int, available: int, what: str):
        self.requested = requested
        self.available = available
        super().__init__(
            f"{what} needs {requested} lanes but only {available} "
            f"visible — run on a host with a GPU (one GPU gives two lanes: "
            f"two streams), or pass an explicit prefill_device")


class Lane(NamedTuple):
    """One stage lane: a device and the stream its work is issued on (None:
    the device's current stream at launch, and on the CPU, in order)."""
    device: object
    stream: Optional[object]


class StageMesh(NamedTuple):
    """The 1-D ("stage",) layout of stage-decoupled execution: lane 0 owns
    decode and the KV pool, lane 1 owns prefill."""
    lanes: tuple
    axis_names: tuple = ("stage",)


def make_dual_device_mesh(device=None) -> StageMesh:
    """Two stage lanes: decode on ``device`` (default: the current GPU) and
    its current stream, prefill on the next visible GPU or, with one GPU,
    on a new stream of the same GPU.  Raises :class:`MeshDeviceError` when
    no GPU is visible: callers fall back to co-located execution."""
    import torch
    n = torch.cuda.device_count()
    if n < 1:
        raise MeshDeviceError(2, 1, "make_dual_device_mesh")
    dec = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else torch.device(device)
    if dec.type != "cuda":
        raise MeshDeviceError(2, 1, "make_dual_device_mesh")
    if dec.index is None:
        dec = torch.device("cuda", torch.cuda.current_device())
    decode = Lane(dec, torch.cuda.current_stream(dec))
    if n >= 2:
        pf = torch.device("cuda", (dec.index + 1) % n)
        return StageMesh((decode, Lane(pf, torch.cuda.Stream(pf))))
    return StageMesh((decode, Lane(dec, torch.cuda.Stream(dec))))


def dual_stage_devices(device=None):
    """(decode lane, prefill lane) of :func:`make_dual_device_mesh`.  Decode
    keeps ``device``: the device every single-lane pool already lives on, so
    enabling dual mode never migrates existing state."""
    decode, prefill = make_dual_device_mesh(device).lanes
    return decode, prefill
