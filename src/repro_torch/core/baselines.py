"""Baseline schedulers: the paper's Fig. 4 schemes (a)(b)(c) and the
llama.cpp-like FCFS engine used in §8.

All run on the same simulator and hardware profile so the comparison
isolates the *scheduling policy* (the paper's llama.cpp baseline also loses
on raw hardware by being CPU-only; our FCFS is therefore a conservative,
stronger baseline — noted in EXPERIMENTS.md).
"""
from __future__ import annotations

from collections import deque
from typing import List, Optional

from repro_torch.core.heg import HEG
from repro_torch.core.requests import Priority, ReqState, Request
from repro_torch.core.scheduler import RunningKernel, SchedulerBase


class FCFSScheduler(SchedulerBase):
    """llama.cpp-like: single lane, run-to-completion, FIFO, no batching,
    no priority awareness.  (The agent frontend cannot tag priorities.)"""

    name = "fcfs"
    lanes = ("igpu",)

    def __init__(self, heg: HEG, **kw):
        super().__init__(heg, b_max=1, **kw)
        self.fifo: deque = deque()

    def _enqueue(self, req: Request, now: float):
        # admission (the base on_arrival ladder) still applies; only the
        # queueing discipline differs
        c = self._build_ctx(req)
        self.ctx[req.id] = c
        req.state = ReqState.QUEUED
        req.last_enqueue_t = now
        self.fifo.append(req.id)

    def next_dispatch(self, now: float) -> List[RunningKernel]:
        if self.running["igpu"] is not None:
            return []
        # continue current head request: prefill kernels then decode steps
        while self.fifo:
            rid = self.fifo[0]
            c = self.ctx.get(rid)
            if c is None:
                self.fifo.popleft()
                continue
            if not c.prefill_done:
                for node in c.ready_kernels(max_parallel_chunks=1):
                    return [self._start(self._mk_running(node, "igpu"), now)]
                return []
            if rid in self.decode_ready:
                return [self._start(self._mk_decode_batch([rid]), now)]
            self.fifo.popleft()
        return []


class NaivePreemptScheduler(SchedulerBase):
    """Scheme (a): single XPU; a reactive arrival instantly discards the
    running proactive prefill (no context save -> full recomputation)."""

    name = "naive_preempt"
    lanes = ("igpu",)

    def _enqueue(self, req: Request, now: float):
        super()._enqueue(req, now)
        if req.priority == Priority.REACTIVE:
            rk = self.running["igpu"]
            if rk is not None and not rk.is_decode_batch:
                c = self.ctx.get(rk.req_ids[0])
                if c and c.req.priority == Priority.PROACTIVE:
                    c.discard_progress()
                    c.req.preempt_count += 1
                    c.req.state = ReqState.PREEMPTED
                    self.running["igpu"] = None  # killed mid-kernel

    def next_dispatch(self, now: float) -> List[RunningKernel]:
        if self.running["igpu"] is not None:
            return []
        self._prune_queues()
        for q in (self.rt_queue, self.be_queue):
            for rid in q:
                c = self.ctx.get(rid)
                if c is None or c.prefill_done:
                    continue
                for node in c.ready_kernels(max_parallel_chunks=1):
                    return [self._start(self._mk_running(node, "igpu"), now)]
        # decode FIFO, reactive first, unbatched
        rts = [r for r in self.decode_ready
               if self.ctx[r].req.priority == Priority.REACTIVE]
        bes = [r for r in self.decode_ready if r not in rts]
        for rid in rts + bes:
            return [self._start(self._mk_decode_batch([rid]), now)]
        return []


class TimeShareScheduler(SchedulerBase):
    """Scheme (b): single XPU multi-stream time sharing — all active
    requests round-robin at kernel granularity (fair, priority-blind)."""

    name = "timeshare"
    lanes = ("igpu",)

    def __init__(self, heg: HEG, **kw):
        super().__init__(heg, b_max=1, **kw)
        self.rr: deque = deque()

    def _enqueue(self, req: Request, now: float):
        super()._enqueue(req, now)
        self.rr.append(req.id)

    def next_dispatch(self, now: float) -> List[RunningKernel]:
        if self.running["igpu"] is not None:
            return []
        for _ in range(len(self.rr)):
            rid = self.rr.popleft()
            c = self.ctx.get(rid)
            if c is None:
                continue
            self.rr.append(rid)
            if not c.prefill_done:
                for node in c.ready_kernels(max_parallel_chunks=1):
                    return [self._start(self._mk_running(node, "igpu"), now)]
                continue
            if rid in self.decode_ready:
                return [self._start(self._mk_decode_batch([rid]), now)]
        return []


class ContinuousBatchingScheduler(SchedulerBase):
    """Scheme (c): ORCA/vLLM-style iteration-level continuous batching on a
    single XPU.  Prefills join the batch whole (no chunking), so a reactive
    request waits for the in-flight iteration — the Fig. 4(c) pathology."""

    name = "continuous_batching"
    lanes = ("igpu",)

    def __init__(self, heg: HEG, *, b_max: Optional[int] = None, **kw):
        super().__init__(heg, b_max=b_max, **kw)
        self.wait: deque = deque()

    def _enqueue(self, req: Request, now: float):
        c = self._build_ctx(req)
        self.ctx[req.id] = c
        req.state = ReqState.QUEUED
        req.last_enqueue_t = now
        self.wait.append(req.id)

    def next_dispatch(self, now: float) -> List[RunningKernel]:
        if self.running["igpu"] is not None:
            return []
        # admit one waiting prefill per iteration (batched with decodes):
        # modeled as the prefill kernels of the admitted request running
        # before the decode batch of the iteration (serialized on one XPU).
        if self.wait:
            rid = self.wait[0]
            c = self.ctx.get(rid)
            if c is None:
                self.wait.popleft()
            elif not c.prefill_done:
                for node in c.ready_kernels(max_parallel_chunks=1):
                    return [self._start(self._mk_running(node, "igpu"), now)]
            else:
                self.wait.popleft()
        if self.decode_ready:
            rids = sorted(
                self.decode_ready,
                key=lambda r: self.ctx[r].req.prefill_done_t or 0)[:self.b_max]
            return [self._start(self._mk_decode_batch(rids), now)]
        return []


BASELINES = {
    "fcfs": FCFSScheduler,
    "naive_preempt": NaivePreemptScheduler,
    "timeshare": TimeShareScheduler,
    "continuous_batching": ContinuousBatchingScheduler,
}
