"""Online workload-aware scheduler (paper §6).

Dual-queue architecture, kernel-level preemption, slack-aware backfill,
ETC/aging resumption, and the memory-pressure three-tier dispatch of
Algorithm 1.  The scheduler is execution-agnostic: the discrete-event
simulator (core.simulator) and the real executor (core.engine) both drive it
through three callbacks:

    on_arrival(req, now)
    on_complete(running, now)
    next_dispatch(now) -> [RunningKernel to start]

A ``RunningKernel`` is either one HEG kernel of one request or a batched
decode iteration (the iGPU dynamic kernel).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

from repro_torch.core.backend import ExecutionBackend, SimBackend
from repro_torch.core.contention import (CoExecutionCalibration,
                                   MemoryPressureEstimator)
from repro_torch.core.faults import AdmissionRejected
from repro_torch.core.heg import HEG, HEGNode, KernelKind
from repro_torch.core.preemption import ReqContext
from repro_torch.core.requests import Priority, ReqState, Request


@dataclasses.dataclass
class RunningKernel:
    lane: str
    node: HEGNode  # representative node (decode: the batch node)
    req_ids: List[int]
    t_standalone: float
    bw_util: float
    energy: float
    started: float = 0.0
    work_done: float = 0.0  # standalone-seconds of progress
    is_decode_batch: bool = False

    @property
    def remaining(self) -> float:
        return max(self.t_standalone - self.work_done, 0.0)


class SchedulerBase:
    """Shared machinery: queues, contexts, decode set, metric hooks."""

    name = "base"
    lanes = ("npu", "igpu")

    def __init__(self, heg: HEG, *, b_max: Optional[int] = None,
                 backend: Optional[ExecutionBackend] = None,
                 max_fused_steps: int = 32, abortable_runs: bool = True,
                 decode_segment_steps: int = 8,
                 pool_slots_max: Optional[int] = None,
                 admission_queue_len: int = 8,
                 contention_calibration:
                 Optional[CoExecutionCalibration] = None):
        self.heg = heg
        self.hw = heg.hw
        self.rt_queue: deque = deque()  # reactive req ids
        self.be_queue: deque = deque()  # proactive req ids (prefill pending)
        self.ctx: Dict[int, ReqContext] = {}
        self.decode_ready: List[int] = []
        self.running: Dict[str, Optional[RunningKernel]] = {
            ln: None for ln in self.lanes}
        # live-kernel bandwidth ledger (§6.4): _start registers each
        # dispatched kernel's bw_util under its lane, on_complete retires
        # it, and the dispatch gate reads the aggregate — the same quantity
        # the old per-gate sum computed, now maintained incrementally and
        # observable between dispatches
        self.pressure = MemoryPressureEstimator()
        # measured (or modeled) prefill/decode mutual interference feeding
        # the piggyback-horizon slack model.  An explicit config input —
        # NEVER runtime-measured in place — so a sim scheduler given the
        # same calibration makes bit-identical decisions (trace invariant);
        # the neutral default changes nothing at all
        self.contention_cal = contention_calibration \
            or CoExecutionCalibration.neutral()
        self.b_max = b_max or heg.B_max
        self.done: List[Request] = []
        self.backend: ExecutionBackend = backend or SimBackend()
        self.trace: List[tuple] = []  # (kernel kind, req ids, sim time)
        # fused decode run (§6.3 stage elasticity / DESIGN.md §6): while a
        # plan is active the decode batch membership is committed for
        # ``left`` more iterations, so the backend may run them all on
        # device in one shot.  max_fused_steps bounds how long a newly
        # decode-ready request can wait to join the batch (1 = no fusion).
        self.max_fused_steps = max(int(max_fused_steps), 1)
        # abortable runs (DESIGN.md §8): the backend executes fused plans in
        # ``decode_segment_steps``-iteration segments, so a plan can be
        # truncated at the next segment boundary (``_abort_fused_plan``)
        # when a reactive arrives or a prefill completes mid-plan.  Both
        # values MUST match the real backend's — the truncation arithmetic
        # below mirrors its lazy segment launches, which keeps sim and real
        # traces identical by construction.
        self.abortable_runs = abortable_runs
        self.decode_segment_steps = max(int(decode_segment_steps), 1)
        # {"order": tuple, "left": n, "total": n_announced}
        self._fused_plan: Optional[dict] = None
        # bounded-resource admission (DESIGN.md §12): ``pool_slots_max``
        # caps occupancy = live flows + off-pool KV snapshot rows; at
        # saturation arrivals walk the degradation ladder (evict -> shrink
        # -> defer -> reject) instead of growing the pool without bound.
        self.pool_slots_max = None if pool_slots_max is None \
            else max(int(pool_slots_max), 1)
        self.admission_queue_len = max(int(admission_queue_len), 0)
        self._admission_wait: deque = deque()  # rung-3 bounded wait queue
        self._base_max_fused = self.max_fused_steps  # rung-2 restore target
        self.rejected: List[Request] = []
        # failure-model counters (surface through launcher reports)
        self.admission_deferrals = 0
        self.admission_rejections = 0
        self.pressure_evictions = 0
        self.horizon_shrinks = 0
        self.deadline_aborts = 0
        self.fault_quarantines = 0
        self.cancelled_flows = 0  # client-abandoned flows (DESIGN.md §13)
        # client cancellations parked for the per-turn poll: like backend
        # faults, a cancel takes effect at the next event-loop turn — an
        # abort-segment boundary under abortable runs — so the serving
        # front-end may file one from any thread at any time
        self._cancel_pending: set = set()
        # rung firings in order ("evict"/"shrink"/"defer"/"reject") — the
        # chaos suite asserts the ladder is walked top-down
        self.ladder_events: List[str] = []

    # -- request lifecycle ---------------------------------------------------
    def _build_ctx(self, req: Request) -> ReqContext:
        """Prefill context consulting the backend's shared-prefix index
        (DESIGN.md §10): a cache hit means kernels — and with them the
        prefill ETC, piggyback horizons and HEG timing — cover only the
        tail from ``seq_start = hit``; the matched prefix is served by one
        KV copy on the execution side, not by forward passes."""
        req.prefix_hit = self.backend.prefix_hit(req)
        return ReqContext.build(req, self.heg, start_tok=req.prefix_hit)

    def on_arrival(self, req: Request, now: float):
        if req.id in self._cancel_pending:
            # cancel filed between submit and the arrival event (the front-
            # end's client vanished before the flow ever entered the queues)
            self._cancel_pending.discard(req.id)
            self.cancelled_flows += 1
            self._retire(req, now, ReqState.CANCELLED,
                         "client cancelled before arrival")
            return
        if not self._admit(req, now):
            return
        self._enqueue(req, now)

    def _enqueue(self, req: Request, now: float):
        """Actually start tracking an ADMITTED request.  Policy subclasses
        override this (not ``on_arrival``) for arrival side effects such as
        reactive preemption, so a deferred or rejected arrival never
        perturbs the running flows."""
        c = self._build_ctx(req)
        self.ctx[req.id] = c
        req.state = ReqState.QUEUED
        req.last_enqueue_t = now
        if req.priority == Priority.REACTIVE:
            self.rt_queue.append(req.id)
        else:
            self.be_queue.append(req.id)

    # -- admission control (DESIGN.md §12) -----------------------------------
    def _occupancy(self) -> int:
        """KV-slot pressure: live flows (each owns / will own a pool slot)
        plus off-pool prefix-snapshot rows (same HBM budget).  The sim
        backend reports 0 store rows, so sim occupancy is just ctx size."""
        return len(self.ctx) + self.backend.kv_store_rows()

    def _admit(self, req: Request, now: float) -> bool:
        """Degradation ladder.  Uncapped schedulers admit everything (the
        pre-§12 behavior).  At saturation, each rung sheds load before the
        next is tried: (1) evict unpinned prefix-cache leaves, (2) halve
        the fused/piggyback horizon down to one abort segment, (3) defer to
        the bounded wait queue, (4) typed rejection — never an unhandled
        exception, never silent pool growth."""
        cap = self.pool_slots_max
        if cap is None:
            return True
        self._drain_admission(now)  # FIFO fairness: earlier deferrals first
        if self._occupancy() < cap:
            return True
        # rung 1: drop evictable prefix-cache state (frees snapshot rows)
        self.backend.evict_prefix_leaves()
        self.pressure_evictions += 1
        self.ladder_events.append("evict")
        if self._occupancy() < cap:
            return True
        # rung 2: shrink the fused horizon so committed runs release the
        # device — and their finishing members' slots — sooner
        if self.max_fused_steps > self.decode_segment_steps:
            self.max_fused_steps = max(self.decode_segment_steps,
                                       self.max_fused_steps // 2)
            self.horizon_shrinks += 1
            self.ladder_events.append("shrink")
            self._abort_fused_plan(now)
        # rung 3: bounded deferral (reactive jumps the line)
        if len(self._admission_wait) < self.admission_queue_len:
            self._defer(req, now)
            return False
        if req.priority == Priority.REACTIVE:
            # a full queue must not wedge the human-facing flow behind
            # proactive deferrals: bump the youngest proactive instead
            for i in range(len(self._admission_wait) - 1, -1, -1):
                if self._admission_wait[i].priority == Priority.PROACTIVE:
                    victim = self._admission_wait[i]
                    del self._admission_wait[i]
                    self._reject(victim, now)
                    self._defer(req, now)
                    return False
        # rung 4: typed terminal rejection
        self._reject(req, now)
        return False

    def _defer(self, req: Request, now: float):
        self.admission_deferrals += 1
        self.ladder_events.append("defer")
        req.state = ReqState.QUEUED
        req.last_enqueue_t = now
        if req.priority == Priority.REACTIVE:
            self._admission_wait.appendleft(req)
        else:
            self._admission_wait.append(req)

    def _reject(self, req: Request, now: float):
        self.admission_rejections += 1
        self.ladder_events.append("reject")
        self.rejected.append(req)
        self._retire(req, now, ReqState.REJECTED, str(AdmissionRejected(
            f"pool saturated: occupancy {self._occupancy()} >= "
            f"pool_slots_max {self.pool_slots_max} and wait queue full")))

    def _retire(self, req: Request, now: float, state: ReqState,
                cause: str):
        """Terminal retirement for a request that never entered ``ctx``
        (rejected at admission, or expired while deferred).  The backend
        may hold register-time prompt state for it, so ``finish`` runs."""
        req.state = state
        req.fault = cause
        req.finish_t = now
        self.done.append(req)
        self.backend.finish(req, now)

    def _drain_admission(self, now: float):
        """Re-admit deferred requests while capacity lasts; once the queue
        clears, restore the fused horizon one doubling per call (no
        whiplash under bursts)."""
        cap = self.pool_slots_max
        if cap is None:
            return
        if self._admission_wait and self._occupancy() >= cap \
                and self.backend.kv_store_rows() > 0:
            # liveness rung: deferred flows must never strand behind pure
            # cache ballast.  Without this, a drained pool whose occupancy
            # is all prefix-snapshot rows re-admits nobody and the run ends
            # with the wait queue populated (exposed by the open-loop
            # serving bench at >100 flows).
            if self.backend.evict_prefix_leaves() > 0:
                self.pressure_evictions += 1
                self.ladder_events.append("evict")
        while self._admission_wait and self._occupancy() < cap:
            req = self._admission_wait.popleft()
            if self.backend.deadline_expired(req, now):
                self.deadline_aborts += 1
                self._retire(req, now, ReqState.TIMED_OUT,
                             "deadline expired while deferred at admission")
                continue
            self._enqueue(req, now)
        if not self._admission_wait and self._occupancy() < cap \
                and self.max_fused_steps < self._base_max_fused:
            self.max_fused_steps = min(self._base_max_fused,
                                       self.max_fused_steps * 2)

    # -- client cancellation (DESIGN.md §13) ---------------------------------
    def request_cancel(self, req_id: int) -> bool:
        """Park a client cancellation for the next per-turn poll.  Safe to
        call at any point of the flow's life: a rid not yet known (the
        arrival event is still in the heap) stays parked until its arrival
        claims it, and parked leftovers die with the scheduler at run end.
        Thread-safe under the GIL: the serving front-end files cancels from
        consumer threads while the event loop runs."""
        self._cancel_pending.add(req_id)
        return True

    def _drain_cancels(self, now: float):
        cancels, self._cancel_pending = self._cancel_pending, set()
        for rid in cancels:
            c = self.ctx.get(rid)
            if c is not None:
                self._quarantine(c.req, now, ReqState.CANCELLED,
                                 "client cancelled mid-flight")
                continue
            for i, r in enumerate(self._admission_wait):
                if r.id == rid:
                    del self._admission_wait[i]
                    self.cancelled_flows += 1
                    self._retire(r, now, ReqState.CANCELLED,
                                 "client cancelled while deferred at "
                                 "admission")
                    break
            else:
                # not arrived yet (event still heap-bound): keep parked so
                # ``on_arrival`` can claim it
                self._cancel_pending.add(rid)

    # -- per-turn poll: fault quarantine + deadlines (DESIGN.md §12) ---------
    def on_turn(self, now: float):
        """Driven once per event-loop turn (Simulator ``poll``).  Order
        matters: client cancels first (an abandoned flow must not be
        charged a deadline miss or fault), then parked backend faults,
        then expired deadlines abort at the segment boundary, then freed
        capacity re-admits."""
        if self._cancel_pending:
            self._drain_cancels(now)
        for f in self.backend.take_flow_faults():
            c = self.ctx.get(f.req_id)
            if c is not None:
                self._quarantine(c.req, now, ReqState.FAILED,
                                 f"{f.stage}: {f.cause!r}")
            else:
                # flow already retired between fault and poll: idempotent
                # backend cleanup only, its terminal status stands
                self.backend.quarantine_flow(f.req, now)
        for rid in list(self.ctx):
            c = self.ctx.get(rid)
            if c is not None and self.backend.deadline_expired(c.req, now):
                self._quarantine(
                    c.req, now, ReqState.TIMED_OUT,
                    f"deadline {c.req.deadline}s exceeded at t={now:.3f}")
        if self._admission_wait:
            keep: deque = deque()
            for r in self._admission_wait:
                if self.backend.deadline_expired(r, now):
                    self.deadline_aborts += 1
                    self._retire(r, now, ReqState.TIMED_OUT,
                                 "deadline expired while deferred at "
                                 "admission")
                else:
                    keep.append(r)
            self._admission_wait = keep
        self._drain_admission(now)

    def _quarantine(self, req: Request, now: float, state: ReqState,
                    cause: str):
        """Remove ONE flow from every scheduler structure and reclaim its
        backend state while all other flows keep running.  A quarantined
        fused-plan member is excised from the committed membership with the
        same segment-boundary arithmetic as ``_abort_fused_plan``, which is
        exactly what ``backend.quarantine_flow`` does to its replay buffer
        — survivors' buffered iterations still commit token-exactly."""
        rid = req.id
        if self.ctx.pop(rid, None) is None:
            return  # already retired
        if rid in self.decode_ready:
            self.decode_ready.remove(rid)
        plan = self._fused_plan
        if plan is not None and rid in plan["order"]:
            if self.abortable_runs:
                seg = self.decode_segment_steps
                committed = plan["total"] - plan["left"]
                executed = min(plan["total"],
                               seg * max(1, -(-committed // seg)))
                plan["left"] = executed - committed
                plan["total"] = executed
            plan["order"] = tuple(o for o in plan["order"] if o != rid)
            if not plan["order"] or plan["left"] <= 0:
                self._fused_plan = None
        req.state = state
        req.fault = cause
        req.finish_t = now
        self.done.append(req)
        self.backend.quarantine_flow(req, now)
        if state == ReqState.TIMED_OUT:
            self.deadline_aborts += 1
        elif state == ReqState.CANCELLED:
            self.cancelled_flows += 1
        else:
            self.fault_quarantines += 1
        self._drain_admission(now)

    def _finish_prefill(self, req: Request, now: float):
        req.prefill_done_t = now
        req.decoded = 1  # prefill emits the first token
        req.state = ReqState.DECODE
        self.backend.prefill_done(req, now)
        if req.decoded >= req.max_new_tokens:
            self._finish(req, now)
        else:
            self.decode_ready.append(req.id)

    def _finish(self, req: Request, now: float):
        """Retire a request.  Slot lifetime spans PREFILL (the real backend
        allocates the pool slot at prefill start, DESIGN.md §7), so every
        path that drops a request — completion here, or the engine's
        ``backend.release`` for requests cut off mid-prefill by max_time —
        must reach ``backend.finish`` to return the slot; a discard-style
        preemption (scheme (a)) instead keeps the slot and replays the row
        on the next ``prefill_chunk``."""
        req.state = ReqState.DONE
        req.finish_t = now
        self.done.append(req)
        self.ctx.pop(req.id, None)
        self.backend.finish(req, now)
        self._drain_admission(now)  # freed slot -> re-admit deferrals

    def on_complete(self, rk: RunningKernel, now: float):
        self.running[rk.lane] = None
        self.pressure.remove(rk.lane)
        self.trace.append((rk.node.kind.value, tuple(rk.req_ids), now))
        if rk.is_decode_batch:
            self.backend.decode_iteration(
                [self.ctx[rid].req for rid in rk.req_ids if rid in self.ctx],
                now)
            for rid in rk.req_ids:
                c = self.ctx.get(rid)
                if c is None:
                    continue
                c.req.decoded += 1
                if c.req.decoded >= c.req.max_new_tokens:
                    if rid in self.decode_ready:
                        self.decode_ready.remove(rid)
                    self._finish(c.req, now)
            if self._fused_plan is not None:
                self._fused_plan["left"] -= 1
                if self._fused_plan["left"] <= 0:
                    self._fused_plan = None
            return
        rid = rk.req_ids[0]
        c = self.ctx.get(rid)
        if c is None:
            return
        c.complete(rk.node)
        j = rk.node.chunk_idx
        if 0 <= j < len(c.chunk_kernels) \
                and c.progress[j] == len(c.chunk_kernels[j]):
            # all kernels of this prompt chunk are done -> materialize it
            self.backend.prefill_chunk(c.req, rk.node.seq_start,
                                       rk.node.tokens, now)
        if c.prefill_done and c.req.state in (ReqState.PREFILL,
                                              ReqState.QUEUED,
                                              ReqState.PREEMPTED):
            self._finish_prefill(c.req, now)

    # -- helpers -------------------------------------------------------------
    def _mk_running(self, node: HEGNode, lane: str) -> RunningKernel:
        t = node.time_on(lane)
        assert t is not None, (node.kind, lane)
        e = node.ann.energy_npu if lane == "npu" else node.ann.energy_igpu
        return RunningKernel(lane=lane, node=node, req_ids=[node.req_id],
                             t_standalone=t, bw_util=node.ann.bw_util_on(lane),
                             energy=e or 0.0)

    def _mk_decode_batch(self, rids: List[int], lane: str = "igpu"
                         ) -> RunningKernel:
        if self._fused_plan is not None:
            # a fused run is in flight on the real backend: the announced
            # membership is committed until it drains (the horizon guarantees
            # none of these requests can finish before then)
            rids = list(self._fused_plan["order"])
        kv_lens = []
        for rid in rids:
            r = self.ctx[rid].req
            kv_lens.append(r.prompt_len + r.decoded)
        ann = self.heg.decode_step_ann(len(rids), kv_lens)
        node = HEGNode(kind=KernelKind.DECODE_STEP, layer=-1, chunk_idx=-1,
                       tokens=len(rids), ann=ann, elastic=False)
        return RunningKernel(lane=lane, node=node, req_ids=list(rids),
                             t_standalone=ann.time_on(lane),
                             bw_util=ann.bw_util_on(lane),
                             energy=ann.energy_igpu or 0.0,
                             is_decode_batch=True)

    def _start(self, rk: RunningKernel, now: float) -> RunningKernel:
        rk.started = now
        self.running[rk.lane] = rk
        self.pressure.add(rk.lane, rk.bw_util)
        if rk.is_decode_batch:
            self._maybe_fuse(rk, now)
        else:
            c = self.ctx[rk.req_ids[0]]
            c.start(rk.node)
            if c.req.state == ReqState.QUEUED:
                c.req.state = ReqState.PREFILL
        return rk

    # -- fused decode runs (DESIGN.md §6, §8) --------------------------------
    def _decode_horizon(self, rids: List[int], t_iter: float) -> int:
        """Event horizon: a GUARANTEED lower bound on how many consecutive
        decode iterations run with exactly this membership.  Membership only
        changes through a prefill completion (new request joins), a batch
        member hitting ``max_new_tokens``, or batch re-formation admitting a
        waiting decode-ready request — so fusion is safe iff every live
        request is already in the batch, and then bounded by the first
        member to finish.  Future *arrivals* are handled by commitment: the
        plan pins membership until it drains (their prefill still overlaps;
        only their decode join waits, at most ``max_fused_steps``).

        ``t_iter`` (the batch's standalone per-iteration time) lets policy
        subclasses size slack-aware piggyback runs; the base policy ignores
        it."""
        if not rids:
            return 1
        if set(self.ctx) - set(rids):
            return 1  # someone is still prefilling / waiting to join
        steps = min(self.ctx[r].req.max_new_tokens - self.ctx[r].req.decoded
                    for r in rids)
        return max(1, min(steps, self.max_fused_steps))

    def _maybe_fuse(self, rk: RunningKernel, now: float):
        if self._fused_plan is not None:
            return
        n = self._decode_horizon(rk.req_ids, rk.t_standalone)
        if n > 1:
            self._fused_plan = {"order": tuple(rk.req_ids), "left": n,
                                "total": n}
            self.backend.decode_run(
                [self.ctx[r].req for r in rk.req_ids if r in self.ctx],
                n, now)

    def _abort_fused_plan(self, now: float):
        """Truncate the committed fused plan at the next segment boundary
        (DESIGN.md §8).  The backend has already launched
        ``seg * ceil(max(committed, 1) / seg)`` iterations — one segment at
        announce, then one more each time the replay buffer drained — so
        those must still commit (token block replay), but everything beyond
        them is cancelled via ``backend.request_preempt`` and the scheduler
        re-plans as soon as the executed prefix drains.  Deterministic in
        scheduler state only, hence identical under Sim and Jax backends."""
        plan = self._fused_plan
        if plan is None or not self.abortable_runs:
            return
        seg = self.decode_segment_steps
        committed = plan["total"] - plan["left"]
        executed = min(plan["total"], seg * max(1, -(-committed // seg)))
        new_left = executed - committed
        if new_left >= plan["left"]:
            return  # nothing left to cancel (plan already fully launched)
        plan["left"] = new_left
        plan["total"] = executed
        self.backend.request_preempt(now)
        if plan["left"] <= 0:
            self._fused_plan = None

    def _reactive_active(self) -> Optional[ReqContext]:
        for rid in self.rt_queue:
            c = self.ctx.get(rid)
            if c and not c.prefill_done:
                return c
        return None

    def _prune_queues(self):
        self.rt_queue = deque(r for r in self.rt_queue if r in self.ctx
                              and not self.ctx[r].prefill_done)
        self.be_queue = deque(r for r in self.be_queue if r in self.ctx
                              and not self.ctx[r].prefill_done)

    # subclasses implement
    def next_dispatch(self, now: float) -> List[RunningKernel]:
        raise NotImplementedError


class AgentXpuScheduler(SchedulerBase):
    """The paper's scheduler: scheme (d) with all mechanisms enabled."""

    name = "agent.xpu"

    def __init__(self, heg: HEG, *, b_max=None, enable_backfill: bool = True,
                 enable_contention: bool = True, tau_low: float = 0.4,
                 tau_high: float = 0.7, starvation_threshold: float = 30.0,
                 reactive_offload: bool = True,
                 backend: Optional[ExecutionBackend] = None,
                 max_fused_steps: int = 32, abortable_runs: bool = True,
                 decode_segment_steps: int = 8,
                 pool_slots_max: Optional[int] = None,
                 admission_queue_len: int = 8,
                 contention_calibration:
                 Optional[CoExecutionCalibration] = None):
        super().__init__(heg, b_max=b_max, backend=backend,
                         max_fused_steps=max_fused_steps,
                         abortable_runs=abortable_runs,
                         decode_segment_steps=decode_segment_steps,
                         pool_slots_max=pool_slots_max,
                         admission_queue_len=admission_queue_len,
                         contention_calibration=contention_calibration)
        self.enable_backfill = enable_backfill
        self.enable_contention = enable_contention
        self.tau_low = tau_low
        self.tau_high = tau_high
        self.starvation_threshold = starvation_threshold
        self.reactive_offload = reactive_offload
        self._bf_used = 0.0  # micro-backfill budget since last decode
        self.piggyback_runs = 0  # fused runs committed under live prefills
        self.piggyback_steps = 0

    # -- Algorithm 1: memory-aware dispatch gate -----------------------------
    def _gate(self, cand: RunningKernel, now: float, reactive: bool) -> bool:
        if not self.enable_contention:
            return True
        if not any(self.running.values()):
            return True  # empty SoC: WaitForSlot would deadlock, just run
        if self._reactive_active() is None and not any(
                rk and any(self.ctx[r].req.priority == Priority.REACTIVE
                           for r in rk.req_ids if r in self.ctx)
                for rk in self.running.values()):
            # proactive-only regime: co-execution always raises throughput
            # (paper Fig. 3) — the pressure tiers protect *reactive* latency
            return True
        # §6.4 kernel reordering: compute-intensive kernels are
        # preferentially overlapped (the paper's flagship backfill pair is
        # proactive NPU prefill under reactive iGPU decode)...
        if cand.bw_util < 0.35:
            return True
        # ...while memory-intensive kernels are separated temporally; the
        # aggregate comes from the pressure ledger _start/on_complete keep
        # in lockstep with ``running``, so the decision is unchanged
        p_new = self.pressure.pressure + cand.bw_util
        if p_new > self.tau_high:
            return reactive  # high pressure: serialize, reactive only
        if p_new > self.tau_low and not reactive:
            return False  # medium: memory-heavy best-effort must wait
        return True

    def _duration_ok(self, cand: RunningKernel, now: float) -> bool:
        """§6.3 duration constraint: best-effort work must fit inside the
        running reactive kernel's execution window — a reactive prefill needs
        the iGPU back every linear-kernel interval for its attention, so any
        best-effort kernel longer than that window would stall the pipeline
        once per layer."""
        ra = self._reactive_active()
        if ra is None:
            return True
        windows = [rk.remaining for rk in self.running.values()
                   if rk and rk.req_ids and rk.req_ids[0] == ra.req.id]
        window = max(windows) if windows else 0.005
        return cand.t_standalone <= max(window, 0.005) * 1.5

    # -- dispatch -------------------------------------------------------------
    def next_dispatch(self, now: float) -> List[RunningKernel]:
        self._prune_queues()
        out: List[RunningKernel] = []
        reactive = self._reactive_active()

        # NPU lane: reactive prefill first, then proactive prefill (backfill)
        if self.running["npu"] is None:
            rk = self._pick_prefill(now, lane="npu", reactive_first=True)
            if rk is not None:
                out.append(self._start(rk, now))

        # iGPU lane priority order (paper §6.1 task dispatch):
        # 1) reactive dynamic kernels (attention)
        # 2) reactive elastic chunk offload (prefill on both XPUs)
        # 3) decode batch (reactive decode never waits; proactive joins)
        # 4) proactive dynamic kernels / elastic chunks (inter-XPU backfill)
        if self.running["igpu"] is None:
            rk = self._pick_igpu(now, reactive)
            if rk is not None:
                out.append(self._start(rk, now))
        return out

    def _pick_prefill(self, now: float, *, lane: str, reactive_first: bool
                      ) -> Optional[RunningKernel]:
        order: List[int] = []
        if reactive_first:
            order += [r for r in self.rt_queue]
        # §6.2 resumption priority for best-effort prefill
        bes = sorted(
            (r for r in self.be_queue),
            key=lambda r: -self.ctx[r].resume_priority(
                now, self.heg, starvation_threshold=self.starvation_threshold))
        order += bes
        for rid in order:
            c = self.ctx.get(rid)
            if c is None or c.prefill_done:
                continue
            is_reactive = c.req.priority == Priority.REACTIVE
            for node in c.ready_kernels():
                if lane == "npu" and not node.elastic:
                    continue  # dynamic kernels cannot run on the NPU
                cand = self._mk_running(node, lane)
                if not is_reactive and not self._duration_ok(cand, now):
                    continue
                if not is_reactive and not self.enable_backfill \
                        and self._reactive_active() is not None:
                    continue
                if self._gate(cand, now, is_reactive):
                    if c.preempted_at is not None:
                        c.resumed_at = now
                        c.preempted_at = None
                    return cand
        return None

    def _pick_igpu(self, now: float, reactive: Optional[ReqContext]
                   ) -> Optional[RunningKernel]:
        # 1) reactive dynamic kernel / 2) reactive elastic offload
        if reactive is not None:
            npu_busy_with_reactive = (
                self.running["npu"] is not None and
                self.running["npu"].req_ids[0] == reactive.req.id)
            for node in reactive.ready_kernels():
                if not node.elastic:
                    return self._mk_running(node, "igpu")
                if self.reactive_offload and npu_busy_with_reactive:
                    return self._mk_running(node, "igpu")

        # 3) decode batch at iteration boundary (intra-XPU backfill: pending
        #    proactive decodes join without disturbing reactive latency).
        #    A purely-proactive iteration is best-effort work and must obey
        #    the §6.3 duration constraint while a reactive prefill pipelines
        #    through the iGPU (one ATTN_DYN per layer).
        # 4) inter-XPU backfill: proactive dynamic / elastic kernels.
        # Ordering between 3 and 4 is throughput-driven (§6.2: low-ETC tasks
        # enter the decode pipeline early to keep the batch full): while the
        # decode batch is underfull, finishing prefills beats burning a full
        # weight-stream iteration on one or two tokens.
        rids = self._form_decode_batch() if self.decode_ready else []
        has_reactive_decode = any(
            self.ctx[r].req.priority == Priority.REACTIVE for r in rids)
        batch_underfull = (not has_reactive_decode
                           and len(rids) < max(2, self.b_max // 2))

        def try_decode():
            if not rids:
                return None
            cand = self._mk_decode_batch(rids)
            ok = has_reactive_decode or self._duration_ok(cand, now)
            if ok and self._gate(cand, now, has_reactive_decode):
                self._bf_used = 0.0  # reset the micro-backfill budget
                return cand
            return None

        def try_backfill():
            # "backfill" = co-scheduling best-effort work WITH reactive; a
            # free iGPU with no reactive task is ordinary dispatch
            if not self.enable_backfill and \
                    self._reactive_active() is not None:
                return None
            return self._pick_prefill(now, lane="igpu", reactive_first=False)

        def try_micro_backfill():
            # structural-slack repair: short best-effort kernels (prefill
            # ATTN_DYN etc.) squeeze between decode iterations within a
            # bounded time budget, so NPU-side prefill pipelines never starve
            # on their iGPU dependencies while decodes loop.
            if not rids or (not self.enable_backfill and
                            self._reactive_active() is not None):
                return None
            est = self._mk_decode_batch(rids).t_standalone
            cand = try_backfill()
            if cand is None:
                return None
            if self._bf_used + cand.t_standalone <= 0.15 * est:
                self._bf_used += cand.t_standalone
                return cand
            return None

        order = (try_backfill, try_decode) if batch_underfull \
            else (try_micro_backfill, try_decode, try_backfill)
        for fn in order:
            rk = fn()
            if rk is not None:
                return rk
        return None

    def _form_decode_batch(self) -> List[int]:
        """Reactive decodes always join; fill with proactive up to B_max,
        preferring power efficiency (shorter remaining output first)."""
        if self._fused_plan is not None:
            return list(self._fused_plan["order"])
        rts = [r for r in self.decode_ready
               if self.ctx[r].req.priority == Priority.REACTIVE]
        bes = [r for r in self.decode_ready
               if self.ctx[r].req.priority == Priority.PROACTIVE]
        bes.sort(key=lambda r: self.ctx[r].req.max_new_tokens
                 - self.ctx[r].req.decoded)
        return (rts + bes)[:self.b_max]

    # -- slack-aware piggybacking (DESIGN.md §8) ------------------------------
    def _decode_horizon(self, rids: List[int], t_iter: float) -> int:
        """Extends the base horizon: when every non-member is still in
        prefill, proactive decode steps PIGGYBACK into the prefill gap as a
        bounded fused run instead of dropping to one device call per token.
        The run is sized by the same slack model ``_duration_ok`` leans on —
        the nearest joiner's estimated time to prefill completion (ETC)
        divided by the batch's per-iteration time — rounded down to whole
        abort segments, so the plan ends at a kernel boundary before the
        join is even expected; if the prefill finishes early anyway,
        ``_finish_prefill`` truncates the plan at the next boundary.  Only
        meaningful with ``abortable_runs`` (commitment without abort would
        re-create the head-of-line blocking this exists to remove)."""
        if not rids:
            return 1
        others = set(self.ctx) - set(rids)
        steps = min(self.ctx[r].req.max_new_tokens - self.ctx[r].req.decoded
                    for r in rids)
        if others:
            if not self.abortable_runs or any(
                    self.ctx[o].prefill_done for o in others):
                # a decode-ready request is waiting to join: no commitment
                return 1
            # contention calibration (§6.4): under overlap the joiner's
            # prefill runs SLOWER (more slack than its standalone ETC
            # claims) and each piggybacked decode iteration runs slower
            # too — both corrections push the horizon toward what actually
            # fits before the join.  Neutral (1.0, 1.0) reproduces the
            # uncalibrated arithmetic bit-for-bit.
            cal = self.contention_cal
            slack = min(self.ctx[o].etc() for o in others) \
                * cal.prefill_slowdown
            t_eff = t_iter * cal.decode_slowdown
            seg = self.decode_segment_steps
            # cap BEFORE rounding down to whole segments: the committed
            # plan must end on an abort-segment boundary even when
            # max_fused_steps is not a segment multiple
            n = min(steps, int(slack / max(t_eff, 1e-9)),
                    self.max_fused_steps)
            steps = (n // seg) * seg  # whole segments only; 0 -> no fusion
            if steps > 1:
                self.piggyback_runs += 1  # _maybe_fuse announces iff > 1
                self.piggyback_steps += steps
        return max(1, min(steps, self.max_fused_steps))

    def _finish_prefill(self, req: Request, now: float):
        super()._finish_prefill(req, now)
        # a joiner became decode-ready mid-plan (piggybacked run, or an
        # arrival that prefilled under a proactive-only plan): cut the plan
        # at the next segment boundary so the join waits O(segment), not
        # O(max_fused_steps)
        self._abort_fused_plan(now)

    # -- preemption (kernel boundary; §6.2) -----------------------------------
    def _enqueue(self, req: Request, now: float):
        # _enqueue (not on_arrival) so a deferred/rejected arrival cannot
        # preempt or truncate work it will never displace
        super()._enqueue(req, now)
        if req.priority == Priority.REACTIVE:
            # mark running best-effort prefill as preempted; their current
            # kernel completes (no mid-kernel abort), context checkpointed
            for c in self.ctx.values():
                if c.req.priority == Priority.PROACTIVE \
                        and c.req.state == ReqState.PREFILL:
                    c.req.state = ReqState.PREEMPTED
                    c.req.preempt_count += 1
                    c.preempted_at = now
            # abortable fused decode (DESIGN.md §8): cancel the unlaunched
            # segments of any committed proactive run so the reactive's
            # prefill/decode reach the device within one segment instead of
            # waiting out up to max_fused_steps iterations
            self._abort_fused_plan(now)
