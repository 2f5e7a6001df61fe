"""Discrete-event hetero-SoC simulator.

Replays a timestamped request trace against any SchedulerBase policy with
the §6.4 contention model: at every event the running kernels' progress is
integrated at their current co-execution rates, rates are recomputed, and
completions are (re)scheduled — a processor-sharing simulation over the two
XPU lanes and the shared memory bus.  Also integrates energy (per-kernel
dynamic power x time plus idle power).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Dict, List, Optional

from repro_torch.core.contention import co_execution_rates
from repro_torch.core.requests import Priority, ReqState, Request
from repro_torch.core.scheduler import SchedulerBase
from repro_torch.core.tracing import Tracer


@dataclasses.dataclass
class SimMetrics:
    completed: List[Request]
    sim_time: float
    energy_j: float
    lane_busy: Dict[str, float]

    def _lat(self, prio, fn):
        # latency aggregates cover COMPLETED flows only: a quarantined /
        # timed-out / rejected flow's partial timestamps would skew the
        # paper metrics (its fate is reported via the status counts below)
        vals = [fn(r) for r in self.completed
                if r.priority == prio and r.state == ReqState.DONE
                and fn(r) is not None]
        return sum(vals) / len(vals) if vals else None

    def summary(self) -> dict:
        ok = [r for r in self.completed if r.state == ReqState.DONE]
        rs = [r for r in ok if r.priority == Priority.REACTIVE]
        ps = [r for r in ok if r.priority == Priority.PROACTIVE]
        tokens = sum(r.decoded for r in self.completed)
        statuses = {"completed": 0, "failed": 0, "timed_out": 0,
                    "rejected": 0, "cancelled": 0}
        for r in self.completed:
            s = r.terminal_status
            if s is not None:
                statuses[s] += 1
        return {
            # terminal-status lattice (DESIGN.md §12)
            "n_completed": statuses["completed"],
            "n_failed": statuses["failed"],
            "n_timed_out": statuses["timed_out"],
            "n_rejected": statuses["rejected"],
            "n_cancelled": statuses["cancelled"],
            "reactive_norm_latency":
                self._lat(Priority.REACTIVE, lambda r: r.normalized_latency),
            "reactive_ttft": self._lat(Priority.REACTIVE, lambda r: r.ttft),
            "proactive_norm_latency":
                self._lat(Priority.PROACTIVE, lambda r: r.normalized_latency),
            "proactive_ttft": self._lat(Priority.PROACTIVE, lambda r: r.ttft),
            "proactive_e2e":
                self._lat(Priority.PROACTIVE, lambda r: r.e2e_latency),
            "n_reactive": len(rs),
            "n_proactive": len(ps),
            "throughput_rps": len(self.completed) / max(self.sim_time, 1e-9),
            "tokens_per_s": tokens / max(self.sim_time, 1e-9),
            "energy_j_per_token": self.energy_j / max(tokens, 1),
            "npu_util": self.lane_busy.get("npu", 0.0)
                / max(self.sim_time, 1e-9),
            "igpu_util": self.lane_busy.get("igpu", 0.0)
                / max(self.sim_time, 1e-9),
            "recomputed_tokens": sum(r.recomputed_tokens
                                     for r in self.completed),
            "preemptions": sum(r.preempt_count for r in self.completed),
            # shared-prefix KV reuse (DESIGN.md §10): prompt tokens served
            # by a cache copy instead of prefill forward passes
            "prefix_hit_tokens": sum(r.prefix_hit for r in self.completed),
            "prefix_hit_rate": sum(r.prefix_hit for r in self.completed)
                / max(sum(r.prompt_len for r in self.completed), 1),
        }


class Simulator:
    def __init__(self, scheduler: SchedulerBase, requests: List[Request],
                 *, max_time: float = 36_000.0,
                 poll: Optional[callable] = None,
                 tracer: Optional[Tracer] = None):
        self.sched = scheduler
        # in-program spans (core.tracing): one ``engine.turn`` a loop turn,
        # and the scheduler's three callbacks inside it
        self.tracer = tracer or Tracer()
        self.requests = sorted(requests, key=lambda r: r.arrival_time)
        self.max_time = max_time
        # streaming-arrival hook: called once per event-loop turn with the
        # current sim time; may call ``inject`` to add requests mid-run
        # (``RealAgentXPUEngine.submit`` during an active run routes here)
        self.poll = poll
        self.now = 0.0
        self.energy = 0.0
        self.lane_busy: Dict[str, float] = {ln: 0.0
                                            for ln in scheduler.lanes}
        self._heap: List = []
        self._counter = itertools.count()
        self._epoch: Dict[str, int] = {ln: 0 for ln in scheduler.lanes}

    # -- event plumbing -------------------------------------------------------
    def _push(self, t: float, kind: str, payload):
        heapq.heappush(self._heap, (t, next(self._counter), kind, payload))

    def inject(self, req: Request):
        """Streaming arrival: enqueue a request while the event loop is
        live.  Safe to call from ``poll``, ``on_token`` callbacks, or any
        scheduler/backend hook — the arrival event lands at the current sim
        instant (or the request's future ``arrival_time``) and is processed
        before any later event."""
        self._push(max(req.arrival_time, self.now), "arrival", req)

    def _rates(self) -> Dict[str, float]:
        lanes = [ln for ln in self.sched.lanes
                 if self.sched.running.get(ln) is not None]
        rates = co_execution_rates(
            [self.sched.running[ln].bw_util for ln in lanes])
        return dict(zip(lanes, rates))

    def _advance(self, to: float):
        """Integrate progress + energy from self.now to `to`."""
        dt = to - self.now
        if dt <= 0:
            self.now = max(self.now, to)
            return
        rates = self._rates()
        idle_lanes = 0
        for ln in self.sched.lanes:
            rk = self.sched.running.get(ln)
            if rk is None:
                idle_lanes += 1
                continue
            r = rates.get(ln, 1.0)
            rk.work_done += dt * r
            self.lane_busy[ln] += dt
            # dynamic energy ~ power x wall time while active
            self.energy += (rk.energy / max(rk.t_standalone, 1e-9)) * dt
        self.energy += self.sched.hw.idle_power * dt * \
            (idle_lanes / max(len(self.sched.lanes), 1))
        self.now = to

    def _schedule_completions(self):
        rates = self._rates()
        for ln in self.sched.lanes:
            rk = self.sched.running.get(ln)
            if rk is None:
                continue
            self._epoch[ln] += 1
            r = max(rates.get(ln, 1.0), 1e-9)
            eta = self.now + rk.remaining / r
            self._push(eta, "done", (ln, self._epoch[ln]))

    # -- main loop -------------------------------------------------------------
    def run(self) -> SimMetrics:
        for req in self.requests:
            self._push(req.arrival_time, "arrival", req)
        tr = self.tracer
        while self.now < self.max_time:
            turn = tr.open("engine.turn") if tr.on else None
            try:
                if self.poll is not None:
                    self.poll(self.now)  # may inject() new arrivals
                if not self._heap:
                    # the poll may have freed capacity (quarantine, deadline
                    # abort) and drained the admission wait queue: give the
                    # scheduler one dispatch chance before declaring the run
                    # over, else an admitted-at-drain flow would stall
                    # forever
                    sp = tr.open("sched.dispatch") if tr.on else None
                    started = self.sched.next_dispatch(self.now)
                    if sp is not None:
                        tr.close(sp)
                    if started:
                        self._schedule_completions()
                        continue
                    break
                t, _, kind, payload = heapq.heappop(self._heap)
                if kind == "done":
                    ln, epoch = payload
                    if epoch != self._epoch[ln]:
                        continue  # stale completion (rates changed)
                    rk = self.sched.running.get(ln)
                    if rk is None:
                        continue
                    self._advance(t)
                    if rk.remaining > 1e-9:
                        self._schedule_completions()
                        continue
                    sp = tr.open("sched.complete") if tr.on else None
                    self.sched.on_complete(rk, self.now)
                else:
                    self._advance(t)
                    sp = tr.open("sched.arrival") if tr.on else None
                    self.sched.on_arrival(payload, self.now)
                if sp is not None:
                    tr.close(sp)
                    sp = tr.open("sched.dispatch")
                started = self.sched.next_dispatch(self.now)
                if sp is not None:
                    tr.close(sp)
                if started or kind == "done":
                    self._schedule_completions()
            finally:
                if turn is not None:
                    tr.close(turn)
        return SimMetrics(completed=self.sched.done, sim_time=self.now,
                          energy_j=self.energy, lane_busy=self.lane_busy)
