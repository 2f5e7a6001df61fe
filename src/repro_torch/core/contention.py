"""Memory-pressure estimation and the NPU-iGPU contention model (paper §6.4).

P_mem(t) = sum over active kernels of BW_k / BW_peak.  When the combined
demand exceeds the shared DDR/HBM bandwidth, each kernel's progress rate
drops in proportion to its own memory-boundness — memory-bound GEMV-like
kernels suffer, compute-bound GEMM-like kernels barely notice (the paper's
Fig. 3 ordering).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Optional


class MemoryPressureEstimator:
    """Tracks aggregate bandwidth utilization of active kernels."""

    def __init__(self):
        self._active: Dict[str, float] = {}

    def add(self, key: str, bw_util: float):
        self._active[key] = bw_util

    def remove(self, key: str):
        self._active.pop(key, None)

    @property
    def pressure(self) -> float:
        return sum(self._active.values())

    @property
    def active(self) -> Dict[str, float]:
        """Snapshot of the currently-registered kernels (copy)."""
        return dict(self._active)

    def rates(self) -> List[float]:
        """Co-execution progress rates of the registered kernels, in
        insertion order (the §6.4 model applied to the live set)."""
        return co_execution_rates(self._active.values())


@dataclasses.dataclass(frozen=True)
class CoExecutionCalibration:
    """Measured (or modeled) prefill/decode mutual-interference factors.

    ``prefill_slowdown`` / ``decode_slowdown`` are >= 1.0 multipliers on a
    stage's standalone time when the two stages overlap.  The scheduler's
    prefill-ETC and piggyback-horizon estimates consume these; the neutral
    default (1.0, 1.0) keeps every scheduling decision — and therefore the
    sim==real trace invariant — bit-identical to the uncalibrated path.
    """
    prefill_slowdown: float = 1.0
    decode_slowdown: float = 1.0

    @classmethod
    def neutral(cls) -> "CoExecutionCalibration":
        return cls()

    @classmethod
    def from_rates(cls, prefill_bw: float,
                   decode_bw: float) -> "CoExecutionCalibration":
        """Calibration from the §6.4 bandwidth model (no measurement)."""
        rp, rd = co_execution_rates([prefill_bw, decode_bw])
        return cls(prefill_slowdown=1.0 / max(rp, 1e-9),
                   decode_slowdown=1.0 / max(rd, 1e-9))

    @classmethod
    def from_backend_stats(
            cls, stats: Mapping[str, float],
            default: Optional["CoExecutionCalibration"] = None,
    ) -> "CoExecutionCalibration":
        """Calibration from a backend ``stats()`` dict: prefer the measured
        overlapped-vs-solo decode slowdown when the run co-executed enough
        segments to have one; otherwise fall back to the bandwidth model
        (or ``default``)."""
        measured = stats.get("co_execution_decode_slowdown_measured")
        model = default or cls.from_rates(
            stats.get("prefill_bw_util", 0.35),
            stats.get("decode_bw_util", 0.85))
        if measured is None or measured <= 0.0:
            return model
        return cls(prefill_slowdown=model.prefill_slowdown,
                   decode_slowdown=max(float(measured), 1.0))


def co_execution_rates(bw_utils: Iterable[float]) -> list:
    """Progress-rate multiplier for each concurrently-running kernel.

    total <= 1: bandwidth uncontended, everyone runs at standalone speed.
    total > 1: the shared bus saturates; kernel i's achieved bandwidth is
    scaled by 1/total, slowing it by a factor interpolated by its own
    memory-boundness m_i ~ bw_util_i (a fully compute-bound kernel has
    bw_util ~ 0 and is unaffected).
    """
    bw = list(bw_utils)
    total = sum(bw)
    if total <= 1.0:
        return [1.0] * len(bw)
    rates = []
    for b in bw:
        m = min(b, 1.0)  # memory-bound fraction proxy
        slowdown = 1.0 + m * (total - 1.0)
        rates.append(1.0 / slowdown)
    return rates
