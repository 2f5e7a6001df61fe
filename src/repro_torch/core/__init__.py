from repro_torch.core.annotation import (H100_LANES, HardwareProfile,
                                         INTEL_CORE_ULTRA_5_125H,
                                         TPU_V5E_LANES, PROFILES, annotate)
from repro_torch.core.backend import (DualDeviceBackend, ExecutionBackend,
                                      SimBackend, TorchRealBackend)
from repro_torch.core.engine import (AgentXPUEngine, RealAgentXPUEngine,
                                     make_scheduler)
from repro_torch.core.heg import HEG, HEGNode, KernelKind
from repro_torch.core.requests import (Priority, ReqState, Request,
                                       WorkloadConfig, generate_workload)
from repro_torch.core.scheduler import AgentXpuScheduler
from repro_torch.core.simulator import SimMetrics, Simulator

__all__ = ["H100_LANES", "HardwareProfile", "INTEL_CORE_ULTRA_5_125H",
           "TPU_V5E_LANES", "PROFILES", "annotate", "DualDeviceBackend",
           "ExecutionBackend", "SimBackend", "TorchRealBackend", "AgentXPUEngine", "RealAgentXPUEngine",
           "make_scheduler", "HEG", "HEGNode", "KernelKind", "Priority",
           "ReqState", "Request", "WorkloadConfig", "generate_workload",
           "AgentXpuScheduler", "SimMetrics", "Simulator"]
