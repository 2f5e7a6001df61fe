"""Agent.xpu engine facade (paper §4/§7), PyTorch port.

Offline phase: build the HEG for the model + hardware profile (op grouping,
chunk-size knee, predictive annotation).  Online phase: run the scheduler
against an ``ExecutionBackend`` (core.backend) — ``SimBackend`` for the pure
timing study or ``TorchRealBackend``, where every HEG chunk /
decode-iteration completion runs the model on the device so real tokens
stream out under the paper's scheduling order.

``AgentXPUEngine``, ``make_scheduler`` and ``stream_printer`` are copies of
the reference's; ``RealAgentXPUEngine`` builds the PyTorch backend.  The
coordinator interleaves kernels in simulated-clock order while the model
math runs for real on one device, or on two lanes (stage-decoupled).
"""
from __future__ import annotations

import os
from typing import List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.annotation import (HardwareProfile, INTEL_CORE_ULTRA_5_125H)
from repro_torch.core.backend import ExecutionBackend, TokenCallback
from repro_torch.core.baselines import BASELINES
from repro_torch.core.heg import HEG
from repro_torch.core.requests import Priority, Request, ReqState
from repro_torch.core.scheduler import AgentXpuScheduler, SchedulerBase
from repro_torch.core.simulator import Simulator, SimMetrics
from repro_torch.core.tracing import Tracer


def stream_printer(prefix: str = "  ") -> TokenCallback:
    """Default ``on_token`` callback: print each token as it is generated
    (shared by launch/serve.py --stream and examples/serve_agentic.py)."""
    def on_token(req: Request, token: int):
        print(f"{prefix}[stream] req {req.id} "
              f"[{req.priority.name.lower():9s}] token {token}", flush=True)
    return on_token


def make_scheduler(name: str, heg: HEG,
                   backend: Optional[ExecutionBackend] = None,
                   **kw) -> SchedulerBase:
    cls = AgentXpuScheduler if name == "agent.xpu" else BASELINES[name]
    return cls(heg, backend=backend, **kw)


class AgentXPUEngine:
    """Simulation-mode engine: offline HEG + online scheduling over a trace."""

    backend: Optional[ExecutionBackend] = None  # None -> per-run SimBackend
    _strict_invariants: bool = False  # audit slot accounting every turn

    def __init__(self, cfg: ModelConfig,
                 hw: HardwareProfile = INTEL_CORE_ULTRA_5_125H,
                 scheduler: str = "agent.xpu", **sched_kw):
        self.cfg = cfg
        self.hw = hw
        self.heg = HEG(cfg, hw)  # offline phase
        self.scheduler_name = scheduler
        self.sched_kw = sched_kw
        self.last_trace: List[tuple] = []  # kernel-completion trace
        self.last_sched: Optional[SchedulerBase] = None
        self._sim: Optional[Simulator] = None  # live event loop, if any
        self._sched: Optional[SchedulerBase] = None  # scheduler of that loop
        self._arrival_poll = None
        # in-program spans (core.tracing): off until ``tracer.enable()``;
        # shared with every run's scheduler and simulator, the backend and
        # the serving front end
        self.tracer = Tracer()

    def _run(self, requests: List[Request], max_time: float) -> SimMetrics:
        sched = make_scheduler(self.scheduler_name, self.heg,
                               backend=self.backend, **self.sched_kw)
        sched.tracer = self.tracer
        self._sched = sched  # cancel() targets the LIVE scheduler
        # per-turn poll composition (DESIGN.md §12), in order: (1) the
        # scheduler quarantines parked backend faults / expired deadlines
        # and drains the admission queue, (2) the strict-invariant audit
        # proves slot accounting is clean AFTER those reclamations, (3) the
        # arrival source sees the freed capacity
        arrival = self._arrival_poll
        strict = self._strict_invariants
        backend = sched.backend

        def poll(now: float):
            sched.on_turn(now)
            if strict:
                backend.validate(strict=True)
            if arrival is not None:
                arrival(now)
        sim = Simulator(sched, requests, max_time=max_time, poll=poll,
                        tracer=self.tracer)
        self._sim = sim
        try:
            metrics = sim.run()
        finally:
            self._sim = None
        self.last_trace = sched.trace
        self.last_sched = sched
        return metrics

    def run_trace(self, requests: List[Request],
                  max_time: float = 36_000.0) -> SimMetrics:
        return self._run(requests, max_time)


class RealAgentXPUEngine(AgentXPUEngine):
    """Real-execution mode: scheduler kernel completions drive the
    ``TorchRealBackend`` (device-resident slot-pool KV cache updated in
    place, zero-copy in-pool prefill, batched masked decode — elastic in
    both the live-row and live-KV-prefix axes (``elastic_decode``,
    DESIGN.md §9) — scheduler-announced fused multi-step decode runs in
    abortable segments, streaming token callbacks).

    Host<->device synchronization happens only at scheduler-visible
    boundaries: prefill fetches one first token per request, and each
    fused decode segment's token block is fetched once, with per-token
    ``on_token`` callbacks replaying from it (``max_fused_steps=1``
    restores the per-iteration path).

    ``device=None`` means ``"cuda"`` and raises when no GPU is visible:
    the CPU runs only when asked for (``device="cpu"``, as the tests do).
    ``params`` must already live on that device in ``dtype``.
    ``kernel_backend`` is ``"cuda"`` (the hand-written attention kernels;
    their plain versions for CPU tensors) or ``"plain"``.

    ``prefix_cache`` (shared-prefix KV reuse, DESIGN.md §10) defaults to
    True, as in the reference; ``faults=`` threads a ``FaultInjector``
    through the backend's fault seam (DESIGN.md §12).
    ``device_resident=False`` / ``in_pool_prefill=False`` are the
    reference's pre-donation and scratch-cache baselines.

    ``dual_device`` (DESIGN.md §14) selects stage-decoupled execution
    (``DualDeviceBackend``): prefill on a second lane, decode and the KV
    pool on ``device``, the KV handed off at ``prefill_done``.  ``None``
    (default) turns it on when two GPUs are visible; ``True`` takes a second
    GPU if there is one, else a second stream of the one GPU, and on the
    CPU co-locates every prefill, as the reference does on one device;
    ``False`` pins the single-lane backend.  An explicit ``prefill_device``
    equal to ``device`` is a lane of its own: a stream of that GPU, and on
    the CPU the staged code run in order (how the CPU tests run every
    staged line)."""

    def __init__(self, cfg: ModelConfig, params,
                 hw: HardwareProfile = INTEL_CORE_ULTRA_5_125H,
                 scheduler: str = "agent.xpu", max_len: int = 512,
                 dtype=None, device=None, pool_slots: Optional[int] = None,
                 max_fused_steps: int = 32, device_resident: bool = True,
                 in_pool_prefill: Optional[bool] = None,
                 abortable_runs: bool = True, decode_segment_steps: int = 8,
                 elastic_decode: bool = True,
                 prefix_cache: bool = True,
                 prefix_cache_tokens: Optional[int] = None,
                 kv_dtype: str = "bf16",
                 kernel_backend: str = "cuda",
                 pool_slots_max: Optional[int] = None,
                 admission_queue_len: int = 8,
                 deadline_s: Optional[float] = None,
                 isolate_flow_faults: bool = True,
                 strict_invariants: Optional[bool] = None,
                 faults=None,
                 dual_device: Optional[bool] = None,
                 prefill_device=None,
                 prefill_inflight_max: int = 8,
                 contention_calibration=None,
                 **sched_kw):
        import torch
        from repro_torch.core.backend import (DualDeviceBackend,
                                              TorchRealBackend)
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "RealAgentXPUEngine runs on CUDA by default and no GPU is "
                "visible; pass device='cpu' to run on the CPU")
        # abortable_runs / decode_segment_steps reach BOTH sides of the seam:
        # the scheduler's plan-truncation arithmetic must mirror the
        # backend's lazy segment launches (DESIGN.md §8).  pool_slots_max
        # likewise: the scheduler's admission ladder and the backend's
        # AllocationFault backstop enforce the same cap (§12).
        if contention_calibration is not None:
            sched_kw["contention_calibration"] = contention_calibration
        super().__init__(cfg, hw, scheduler,
                         max_fused_steps=max_fused_steps,
                         abortable_runs=abortable_runs,
                         decode_segment_steps=decode_segment_steps,
                         pool_slots_max=pool_slots_max,
                         admission_queue_len=admission_queue_len,
                         **sched_kw)
        if dual_device is None:
            # auto: stage-decoupled execution iff a second GPU is visible
            dual_device = torch.cuda.device_count() >= 2
        backend_cls = DualDeviceBackend if dual_device else TorchRealBackend
        backend_kw = {}
        if dual_device:
            backend_kw = dict(prefill_device=prefill_device,
                              prefill_inflight_max=prefill_inflight_max,
                              heg=self.heg)
        self.backend = backend_cls(
            cfg, params, pool_slots=pool_slots or self.heg.B_max,
            max_len=max_len, dtype=dtype, device=device,
            device_resident=device_resident,
            in_pool_prefill=in_pool_prefill, abortable_runs=abortable_runs,
            decode_segment_steps=decode_segment_steps,
            elastic_decode=elastic_decode,
            # shared-prefix KV reuse (DESIGN.md §10); prefix_cache=False is
            # the cold-prefill baseline (--no-prefix-cache)
            prefix_cache=prefix_cache,
            prefix_cache_tokens=prefix_cache_tokens,
            kv_dtype=kv_dtype, kernel_backend=kernel_backend,
            pool_slots_max=pool_slots_max,
            isolate_flow_faults=isolate_flow_faults, faults=faults,
            **backend_kw)
        self.backend.tracer = self.tracer
        # default SLO for human-facing flows: reactive requests submitted
        # without their own deadline inherit this (seconds from arrival)
        self.deadline_s = deadline_s
        if strict_invariants is None:
            strict_invariants = bool(os.environ.get(
                "REPRO_STRICT_INVARIANTS", "") not in ("", "0"))
        self._strict_invariants = strict_invariants
        self._pending: List[Request] = []
        self._live: List[Request] = []  # everything owned by the active run

    # -- streaming flow API ---------------------------------------------------
    def submit(self, req: Request,
               on_token: Optional[TokenCallback] = None) -> Request:
        """Enqueue a request; ``on_token(req, token)`` fires per generated
        token (first token at prefill completion, then one per decode
        iteration).  Callable mid-run — from an ``on_token`` callback or an
        arrival source — in which case the request is injected into the live
        event loop at the current sim instant (its arrival is processed
        before any later event, and a committed fused decode run is
        truncated at the next segment boundary if the request is
        reactive)."""
        if req.deadline is None and self.deadline_s is not None \
                and req.priority == Priority.REACTIVE:
            req.deadline = self.deadline_s
        self.backend.register(req, on_token)
        if self._sim is not None:
            req.arrival_time = max(req.arrival_time, self._sim.now)
            self._live.append(req)
            self._sim.inject(req)
        else:
            self._pending.append(req)
        return req

    def cancel(self, req) -> bool:
        """Client cancellation of a submitted flow (DESIGN.md §13).  Takes
        a ``Request`` or its id.  A flow still pending between runs retires
        immediately (state ``cancelled``, register-time backend state
        freed); a flow inside the live event loop is parked with the
        scheduler and quarantined at the next per-turn poll — one abort
        segment of latency, slot and prefix pins released, survivors
        untouched.  Returns False when the engine holds no trace of the
        flow (already retired, or never submitted).  Thread-safe under the
        GIL: the serving front-end calls this from consumer threads."""
        rid = req.id if isinstance(req, Request) else int(req)
        for i, r in enumerate(self._pending):
            if r.id == rid:
                del self._pending[i]
                r.state = ReqState.CANCELLED
                r.fault = "client cancelled before run"
                self.backend.finish(r, 0.0)
                return True
        if self._sim is not None and self._sched is not None \
                and any(r.id == rid for r in self._live):
            return self._sched.request_cancel(rid)
        return False

    def set_arrival_source(self, source) -> None:
        """Install a streaming arrival source: ``source(sim_now)`` is polled
        once per event-loop turn and returns an iterable of ``Request`` (or
        ``(Request, on_token)`` pairs) to submit at that instant.  This is
        the single-threaded stand-in for an external arrival queue: with
        abortable fused runs the poll runs between decode *segments*, so a
        wall-clock arrival is noticed within one segment instead of one
        full fused run (``benchmarks … reactive_latency``).  The source is
        polled one final time as the event loop drains; anything it would
        only release *after* the run ends is not served — callers holding
        deadline-based sources should keep deadlines inside the expected
        run wall time (or submit the stragglers to the next ``run``)."""
        if source is None:
            self._arrival_poll = None
            return

        def _poll(now: float):
            for item in source(now) or ():
                req, cb = item if isinstance(item, tuple) else (item, None)
                self.submit(req, cb)
        self._arrival_poll = _poll

    def run(self, max_time: float = 36_000.0) -> SimMetrics:
        """Serve everything submitted since the last run (plus anything
        submitted *during* the run via streaming arrivals)."""
        reqs, self._pending = self._pending, []
        self._live = list(reqs)
        try:
            metrics = self._run(reqs, max_time)
        except BaseException:
            # with isolate_flow_faults=True (default) an on_token hook
            # exception quarantines only its own flow (DESIGN.md §12) and
            # never reaches here; this path now covers arrival-source
            # raises and the legacy isolate_flow_faults=False mode, where
            # a hook raise still tears the run down — either way, free
            # every slot the failed run may still hold (leaking them would
            # shrink the pool for all subsequent runs on this engine).
            # Partial outputs stay retrievable via ``output_tokens``.
            self.backend.release(self._live, 0.0)
            self._live = []
            raise
        done = {r.id for r in metrics.completed}
        # requests cut off by max_time must not hold slots/scratch forever
        self.backend.release([r for r in self._live if r.id not in done],
                             metrics.sim_time)
        self._live = []
        return metrics

    def serve(self, requests: List[Request],
              max_time: float = 36_000.0) -> SimMetrics:
        """Replay-style entry point: submit the whole trace, then run."""
        for r in requests:
            self.submit(r)
        return self.run(max_time)

    def output_tokens(self, req_id: int) -> list:
        return self.backend.output_tokens(req_id)

    def stats(self) -> dict:
        return self.backend.stats()
