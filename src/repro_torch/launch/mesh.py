"""Meshes: the production meshes of the sharded programs, and the two stage
lanes of stage-decoupled execution (DESIGN.md §14).  PyTorch port of
``repro.launch.mesh``.

The production meshes are ``DeviceMesh``es over the default process group
(``torch.distributed``), PyTorch's counterpart of a JAX ``Mesh``: 16x16
("data", "model") on one pod, 2x16x16 ("pod", "data", "model") on two,
over the group's first 256 / 512 ranks.  A smaller group raises the typed
:class:`MeshDeviceError`, as the reference raises on a short device list.
``make_host_mesh`` is a 1x1 mesh on the local device.  Their device type
follows the port's rule: ``cuda`` unless the caller asks for the CPU.

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
        if what == "make_production_mesh":
            hint = ("start a process group of that many ranks "
                    "(torch.distributed; the dry run starts a fake one)")
        else:
            hint = ("run on a host with a GPU (one GPU gives two lanes: "
                    "two streams), or pass an explicit prefill_device")
        unit = "ranks" if what == "make_production_mesh" else "lanes"
        super().__init__(f"{what} needs {requested} {unit} but only "
                         f"{available} visible — {hint}")


def _device_type(device) -> str:
    """``cuda`` unless the caller asks for the CPU; raises for CUDA without
    a GPU."""
    import torch
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the mesh is on CUDA by default and no GPU is "
                           "visible; pass device='cpu' to use the CPU")
    return dev.type


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 single-pod ("data", "model") or 2x16x16 ("pod", "data",
    "model") ``DeviceMesh`` over the first 256 / 512 ranks of the default
    process group.  Raises :class:`MeshDeviceError` (requested, available)
    when the group is smaller (a world of 1 without a group)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for e in shape:
        n *= e
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < n:
        raise MeshDeviceError(n, world, "make_production_mesh")
    ranks = torch.arange(n).reshape(shape)
    return DeviceMesh(_device_type(device), ranks, mesh_dim_names=axes)


def make_host_mesh(device=None):
    """1x1 ("data", "model") mesh on the local device (smoke tests,
    examples).  Starts a world-1 process group (NCCL on a GPU, gloo on the
    CPU) only if none is up."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dtype = _device_type(device)
    if not dist.is_initialized():
        import socket
        with socket.socket() as s:  # a free local port for the store
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        dist.init_process_group("nccl" if dtype == "cuda" else "gloo",
                                init_method=f"tcp://127.0.0.1:{port}",
                                rank=0, world_size=1)
    return init_device_mesh(dtype, (1, 1), mesh_dim_names=("data", "model"))


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
