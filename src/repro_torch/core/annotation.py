"""Hardware profiles and per-kernel predictive annotation (paper §5.3).

The paper derives annotations from VTune profiling; we derive them from a
kernel-wise roofline over the hardware profile (the same four fields the
paper lists: standalone latency, memory-bandwidth utilization, memory
footprint, power).  Two profiles ship:

* INTEL_CORE_ULTRA_5_125H — the paper's evaluation SoC (NPU 11.5 TOPS,
  Arc iGPU 18 TOPS, 32 GB DDR5-5600 ~ 89.6 GB/s).  Used by the simulator to
  reproduce the paper's figures.
* TPU_V5E_LANES — the beyond-paper adaptation: "NPU" = prefill submesh,
  "iGPU" = decode submesh of a v5e pod (197 TFLOP/s bf16, 819 GB/s HBM per
  chip); the shared-DRAM contention term becomes HBM+ICI contention.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class XPUSpec:
    name: str
    flops: float  # effective op/s for the deployed precision
    mem_bw: float  # achievable bytes/s when running alone
    static_only: bool  # NPU-style: only pre-compiled static shapes
    power: float  # active watts (paper: stable per-XPU dynamic power)
    kernel_overhead: float = 1e-4  # dispatch + sync per kernel (s)


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    name: str
    npu: XPUSpec
    igpu: XPUSpec
    shared_bw: float  # DDR (SoC) / HBM (TPU lane pair) bytes/s ceiling
    idle_power: float = 3.0

    def xpu(self, lane: str) -> XPUSpec:
        return self.npu if lane == "npu" else self.igpu


INTEL_CORE_ULTRA_5_125H = HardwareProfile(
    name="intel_core_ultra_5_125h",
    # W8A16: NPU INT8 MACs; effective sustained ~70% of peak
    npu=XPUSpec("npu", flops=11.5e12 * 0.7, mem_bw=60e9, static_only=True,
                power=9.0),
    # paper restricts iGPU utilization for graphics headroom
    igpu=XPUSpec("igpu", flops=18e12 * 0.5, mem_bw=70e9, static_only=False,
                 power=14.0),
    shared_bw=89.6e9,
)

TPU_V5E_LANES = HardwareProfile(
    name="tpu_v5e_lanes",
    npu=XPUSpec("prefill_lane", flops=197e12 * 0.6, mem_bw=819e9,
                static_only=True, power=170.0),
    igpu=XPUSpec("decode_lane", flops=197e12 * 0.6, mem_bw=819e9,
                 static_only=False, power=170.0),
    shared_bw=819e9 * 2,
)

PROFILES = {p.name: p for p in (INTEL_CORE_ULTRA_5_125H, TPU_V5E_LANES)}


@dataclasses.dataclass(frozen=True)
class KernelAnnotation:
    """Paper §5.3 predictive annotation, per backend."""
    flops: float
    bytes: float
    # standalone execution time per lane (None = lane not allowed)
    t_npu: Optional[float]
    t_igpu: Optional[float]
    # memory bandwidth utilization (fraction of shared bw while running)
    bw_util_npu: float
    bw_util_igpu: float
    mem_footprint: float  # bytes resident while the kernel is active
    energy_npu: Optional[float]
    energy_igpu: Optional[float]

    def time_on(self, lane: str) -> Optional[float]:
        return self.t_npu if lane == "npu" else self.t_igpu

    def bw_util_on(self, lane: str) -> float:
        return self.bw_util_npu if lane == "npu" else self.bw_util_igpu


def annotate(flops: float, nbytes: float, hw: HardwareProfile, *,
             allow_npu: bool = True, allow_igpu: bool = True,
             footprint: Optional[float] = None) -> KernelAnnotation:
    """Roofline latency + bandwidth utilization per backend."""
    def lane(spec: XPUSpec, allowed: bool):
        if not allowed:
            return None, 0.0, None
        t = max(flops / spec.flops, nbytes / spec.mem_bw) \
            + spec.kernel_overhead
        bw = min(nbytes / max(t, 1e-12), spec.mem_bw) / hw.shared_bw
        return t, bw, spec.power * t

    t_n, bw_n, e_n = lane(hw.npu, allow_npu)
    t_g, bw_g, e_g = lane(hw.igpu, allow_igpu)
    return KernelAnnotation(
        flops=flops, bytes=nbytes, t_npu=t_n, t_igpu=t_g,
        bw_util_npu=bw_n, bw_util_igpu=bw_g,
        mem_footprint=footprint if footprint is not None else nbytes,
        energy_npu=e_n, energy_igpu=e_g)
