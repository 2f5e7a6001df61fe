"""Async serving front-end over ``RealAgentXPUEngine`` (DESIGN.md §13).

The engine below this layer is a *synchronous* discrete-event loop: one
``run()`` serves everything submitted, polling an arrival source between
abortable decode segments.  ``ServingFrontend`` turns that into an
always-on service: a worker thread owns the engine and keeps a run alive
while flows exist, a thread-safe per-priority inbox feeds the engine's
arrival-source seam (reactive arrivals jump the proactive line, mirroring
the scheduler's dual queues), and every flow streams its tokens into a
bounded per-client buffer (``FlowHandle``) that sync and asyncio consumers
drain concurrently with generation.

A copy of the reference's ``repro.launch.frontend``, logic unchanged.  The
worker thread drives a CUDA engine: torch's current device is per thread,
so the engine's tensors name their device explicitly and nothing here
depends on the worker thread's current device.

Lifecycle guarantees (tested in tests/test_torch_sim.py):

  * every accepted flow reaches exactly one terminal status — ``completed``
    / ``failed`` / ``timed_out`` / ``rejected`` / ``cancelled`` — surfaced
    on its handle; ``drain()`` blocks until the in-flight set is empty
  * ``FlowHandle.cancel()`` (or a consumer vanishing past its buffer
    bound) releases the flow's pool slot and prefix pins within one abort
    segment via the engine's §13 cancel seam — no leak under
    ``REPRO_STRICT_INVARIANTS=1``
  * per-flow token streams are deterministic: a row's tokens depend only
    on its prompt and the params, never on what else shared the batch

Backpressure is per client and bounded: a consumer that stops reading
never grows host memory past ``max_buffered_tokens``; the slow flow is
disconnected (policy ``"cancel"``, like an SSE server dropping a dead
client) while every other stream keeps flowing.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, Iterator, List, Optional

from repro_torch.core.requests import (Priority, ReqState, Request,
                                       TERMINAL_STATES)


class FrontendClosed(RuntimeError):
    """Submission after ``drain()``/``close()`` began (typed, so callers
    can shed load instead of crashing)."""


class FlowHandle:
    """One client's view of one streaming flow.

    Producer side (engine thread): ``_push`` appends generated tokens,
    ``_finish`` seals the stream with a terminal status.  Consumer side
    (any thread / asyncio task): iterate ``tokens()`` or ``async for`` the
    handle; ``next_token()`` blocks until a token or end-of-stream.
    """

    def __init__(self, req: Request, *, max_buffered_tokens: int,
                 frontend: "ServingFrontend"):
        self.req = req
        self.flow_id = req.id
        self._fe = frontend
        self._max_buf = max(int(max_buffered_tokens), 1)
        self._buf: Deque[int] = deque()
        self._cond = threading.Condition()
        self._status: Optional[str] = None  # terminal_status once sealed
        self.fault: Optional[str] = None
        self.cancel_requested = False
        self.overflowed = False
        # wall-clock SLO instrumentation (producer-side emit instants):
        # the loadgen derives TTFT from token_walls[0] and TBT from gaps
        self.submit_wall: Optional[float] = None
        self.token_walls: List[float] = []
        self.tokens_out: List[int] = []  # full stream, survives the buffer

    # -- producer side (engine worker thread) --------------------------------
    def _push(self, token: int) -> bool:
        """Buffer one generated token; False = bound exceeded (the worker
        applies the overflow policy)."""
        with self._cond:
            if self._status is not None:
                return True  # late replay after seal: drop silently
            self.token_walls.append(time.perf_counter())
            self.tokens_out.append(int(token))
            if len(self._buf) >= self._max_buf:
                self.overflowed = True
                return False
            self._buf.append(int(token))
            self._cond.notify_all()
            return True

    def _finish(self, status: str, fault: Optional[str] = None) -> bool:
        """Seal the stream; True only for the call that actually sealed it
        (the front-end's retired accounting keys off that)."""
        with self._cond:
            sealed = self._status is None
            if sealed:
                self._status = status
                self.fault = fault
            self._cond.notify_all()
            return sealed

    # -- consumer side --------------------------------------------------------
    @property
    def status(self) -> Optional[str]:
        """Terminal status, or None while in flight."""
        return self._status

    def next_token(self, timeout: Optional[float] = None) -> Optional[int]:
        """Block until the next token; None = end of stream (check
        ``status``/``fault`` for how it ended)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._buf:
                if self._status is not None:
                    return None
                left = None if deadline is None \
                    else deadline - time.monotonic()
                if left is not None and left <= 0:
                    raise TimeoutError(
                        f"flow {self.flow_id}: no token within {timeout}s")
                self._cond.wait(left)
            return self._buf.popleft()

    def tokens(self, timeout: Optional[float] = None) -> Iterator[int]:
        """Blocking stream of generated tokens until terminal."""
        while True:
            t = self.next_token(timeout)
            if t is None:
                return
            yield t

    def __aiter__(self):
        return self._aiter()

    async def _aiter(self):
        """Asyncio stream: each blocking wait hops to the default executor
        so hundreds of flows can be consumed from one event loop."""
        import asyncio
        loop = asyncio.get_event_loop()
        while True:
            t = await loop.run_in_executor(None, self.next_token)
            if t is None:
                return
            yield t

    def cancel(self) -> None:
        """Abandon the flow: the front-end files an engine cancel and the
        scheduler quarantines the flow at the next abort-segment boundary
        (slot + prefix pins released, survivors untouched)."""
        self.cancel_requested = True
        self._fe._file_cancel(self)

    def result(self, timeout: Optional[float] = None) -> dict:
        """Block until terminal; returns the flow's summary."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._status is None:
                left = None if deadline is None \
                    else deadline - time.monotonic()
                if left is not None and left <= 0:
                    raise TimeoutError(
                        f"flow {self.flow_id} not terminal within "
                        f"{timeout}s")
                self._cond.wait(left)
        r = self.req
        return {
            "flow_id": self.flow_id,
            "status": self._status,
            "fault": self.fault,
            "priority": r.priority.name.lower(),
            "tokens": list(self.tokens_out),
            "n_tokens": len(self.tokens_out),
            "submit_wall": self.submit_wall,
            "token_walls": list(self.token_walls),
            "overflowed": self.overflowed,
        }


class ServingFrontend:
    """Always-on asyncio-friendly submission API over one real engine.

    The worker thread loops: wait for arrivals -> seed a run with the
    backlog -> ``engine.run()`` with the inbox wired to the arrival-source
    seam (so flows submitted mid-run join the live event loop) -> seal the
    retired flows' handles -> back to waiting.  ``submit()`` /
    ``FlowHandle`` methods are safe from any thread and from asyncio
    (``asubmit``); the engine itself never leaves the worker thread.
    """

    _SCHED_COUNTERS = ("admission_deferrals", "admission_rejections",
                       "pressure_evictions", "horizon_shrinks",
                       "deadline_aborts", "cancelled_flows")

    def __init__(self, engine, *, max_buffered_tokens: int = 512,
                 run_max_time: float = 36_000.0):
        self.engine = engine
        self._tracer = engine.tracer  # core.tracing: frontend.* spans
        self.max_buffered_tokens = int(max_buffered_tokens)
        self.run_max_time = float(run_max_time)
        self._flows: Dict[int, FlowHandle] = {}
        self._inflight: Dict[int, FlowHandle] = {}
        # per-priority inbox: reactive arrivals are handed to the engine
        # before proactive ones queued earlier (the front-end mirror of the
        # scheduler's rt/be dual queues)
        self._inbox_rt: Deque[FlowHandle] = deque()
        self._inbox_be: Deque[FlowHandle] = deque()
        self._cancel_inbox: Deque[FlowHandle] = deque()
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._state = "new"  # new -> serving -> draining -> closed
        self._thread: Optional[threading.Thread] = None
        self._worker_error: Optional[BaseException] = None
        self._next_id = 0
        # service counters (surfaced by stats())
        self.flows_submitted = 0
        self.flows_retired = 0
        self.backpressure_disconnects = 0
        self.runs = 0
        # scheduler counters accumulate ACROSS runs: the engine builds a
        # fresh scheduler per run(), so a cancel retired in run N would
        # vanish from last_sched once run N+1 starts
        self._sched_totals = {k: 0 for k in self._SCHED_COUNTERS}
        self._folded_sched = None  # last scheduler already in the totals

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "ServingFrontend":
        if self._thread is not None:
            return self
        # counters from any pre-frontend engine use (warm-up serves) are
        # not this service's traffic: mark that scheduler already folded
        self._folded_sched = self.engine.last_sched
        self._state = "serving"
        self._thread = threading.Thread(
            target=self._serve_loop, name="repro-frontend", daemon=True)
        self._thread.start()
        return self

    def __enter__(self) -> "ServingFrontend":
        return self.start()

    def __exit__(self, *exc):
        self.close()

    def drain(self, timeout: Optional[float] = None) -> None:
        """Graceful drain: refuse new flows, then block until every
        accepted flow reached a terminal status."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._wake:
            if self._state == "serving":
                self._state = "draining"
            self._wake.notify_all()
        while True:
            with self._lock:
                if self._worker_error is not None:
                    raise RuntimeError(
                        "front-end worker died") from self._worker_error
                busy = (self._inflight or self._inbox_rt or self._inbox_be)
            if not busy:
                return
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"drain: {len(self._inflight)} flows still in flight "
                    f"after {timeout}s")
            time.sleep(0.001)

    def close(self, timeout: Optional[float] = None) -> None:
        """Drain, then stop the worker thread."""
        if self._thread is None:
            self._state = "closed"
            return
        self.drain(timeout)
        with self._wake:
            self._state = "closed"
            self._wake.notify_all()
        self._thread.join(timeout)
        self._thread = None

    # -- submission -----------------------------------------------------------
    def submit(self, tokens, *, priority: Priority = Priority.PROACTIVE,
               max_new_tokens: int = 16, deadline: Optional[float] = None,
               arrival_time: float = 0.0,
               flow_id: Optional[int] = None) -> FlowHandle:
        """Thread-safe submission; returns the flow's streaming handle.

        ``tokens`` is the prompt id row ((1, plen) array-like); ``deadline``
        is the per-flow SLO in seconds from arrival (DESIGN.md §12).
        Raises ``FrontendClosed`` once drain/close began."""
        import numpy as np
        toks = np.asarray(tokens)
        if toks.ndim == 1:
            toks = toks[None, :]
        with self._wake:
            if self._state not in ("new", "serving"):
                raise FrontendClosed(
                    f"front-end is {self._state}; no new flows")
            if self._worker_error is not None:
                raise RuntimeError(
                    "front-end worker died") from self._worker_error
            if flow_id is None:
                flow_id = self._next_id
            self._next_id = max(self._next_id, flow_id) + 1
            req = Request(id=flow_id, priority=priority,
                          prompt_len=int(toks.shape[1]),
                          max_new_tokens=int(max_new_tokens),
                          arrival_time=float(arrival_time),
                          deadline=deadline, tokens=toks)
            h = FlowHandle(req, max_buffered_tokens=self.max_buffered_tokens,
                           frontend=self)
            h.submit_wall = time.perf_counter()
            self._flows[flow_id] = h
            (self._inbox_rt if priority == Priority.REACTIVE
             else self._inbox_be).append(h)
            self.flows_submitted += 1
            self._wake.notify_all()
        return h

    async def asubmit(self, tokens, **kw) -> FlowHandle:
        """Asyncio counterpart of ``submit`` (the enqueue itself is cheap;
        the executor hop keeps the loop clean of lock waits)."""
        import asyncio
        import functools
        loop = asyncio.get_event_loop()
        return await loop.run_in_executor(
            None, functools.partial(self.submit, tokens, **kw))

    def _file_cancel(self, h: FlowHandle) -> None:
        with self._wake:
            self._cancel_inbox.append(h)
            self._wake.notify_all()

    # -- worker loop ----------------------------------------------------------
    def _pop_arrivals_locked(self) -> List[FlowHandle]:
        """Pop queued flows (reactive first) and mark them in flight in the
        SAME critical section, so ``drain()`` can never observe the gap
        between a flow leaving the inbox and entering the in-flight set.
        Caller holds ``self._lock``."""
        out: List[FlowHandle] = []
        while self._inbox_rt:
            out.append(self._inbox_rt.popleft())
        while self._inbox_be:
            out.append(self._inbox_be.popleft())
        for h in out:
            self._inflight[h.flow_id] = h
        return out

    def _drive_cancels(self) -> None:
        """File queued client cancels (worker thread only, so the engine's
        pending-list surgery races with nothing).  A flow still waiting in
        our own inbox is unqueued and sealed directly — it never touched
        the engine."""
        while True:
            with self._lock:
                if not self._cancel_inbox:
                    return
                h = self._cancel_inbox.popleft()
                inboxed = False
                for box in (self._inbox_rt, self._inbox_be):
                    try:
                        box.remove(h)
                        inboxed = True
                        break
                    except ValueError:
                        pass
            if h.status is not None:
                continue
            if inboxed:
                h.req.state = ReqState.CANCELLED
                h.req.fault = "client cancelled before dispatch"
            elif not self.engine.cancel(h.req.id) \
                    and h.req.state not in TERMINAL_STATES:
                # unknown to the engine (already released between runs):
                # seal directly — nothing holds execution state for it
                h.req.state = ReqState.CANCELLED
                h.req.fault = "client cancelled"
            self._seal_if_terminal(h)

    def _seal_if_terminal(self, h: FlowHandle) -> None:
        status = h.req.terminal_status
        if status is not None and h._finish(status, h.req.fault):
            with self._lock:
                self._inflight.pop(h.flow_id, None)
                self.flows_retired += 1

    def _on_token(self, req: Request, token: int) -> None:
        h = self._flows.get(req.id)
        if h is None:
            return
        if not h._push(token):
            # bounded per-client backpressure: the consumer stopped
            # draining — disconnect THIS flow at the next segment boundary
            # instead of growing its buffer or stalling the whole engine
            if not h.cancel_requested:
                h.cancel_requested = True
                self.backpressure_disconnects += 1
                self.engine.cancel(req.id)

    def _arrival_source(self, now: float):
        """Engine arrival-source seam: runs once per event-loop turn (i.e.
        between abortable decode segments).  Hands over newly inboxed
        flows, drives queued cancels, and seals freshly retired handles so
        consumers unblock within one segment of their flow ending."""
        tr = self._tracer
        sp = tr.open("frontend.poll") if tr.on else None
        self._drive_cancels()
        for h in list(self._inflight.values()):
            self._seal_if_terminal(h)
        with self._lock:
            fresh = self._pop_arrivals_locked()
        if sp is not None:
            self._trace_handoff(fresh)
            tr.close(sp, flows=len(fresh))
        return [(h.req, self._on_token) for h in fresh]

    def _trace_handoff(self, flows: List[FlowHandle]) -> None:
        """One ``frontend.handoff`` span a flow: submitted -> taken by the
        engine thread, now (tracer on)."""
        tr = self._tracer
        now = time.perf_counter_ns()
        for h in flows:
            tr.flow_begin(h.flow_id, "frontend.handoff",
                          round(h.submit_wall * 1e9),
                          reactive=int(h.req.priority == Priority.REACTIVE))
            tr.flow_mark(h.flow_id, "frontend.handoff", now)

    def _serve_loop(self) -> None:
        eng = self.engine
        try:
            while True:
                with self._wake:
                    while self._state == "serving" \
                            and not (self._inbox_rt or self._inbox_be
                                     or self._cancel_inbox):
                        self._wake.wait(0.05)
                    state = self._state
                # cancels first: a flow cancelled while still inboxed is
                # unqueued and sealed here, so it can never be seeded into
                # the engine as an already-sealed zombie
                self._drive_cancels()
                with self._wake:
                    seed = self._pop_arrivals_locked()
                if self._tracer.on:
                    self._trace_handoff(seed)
                if not seed:
                    if state == "closed":
                        return
                    if state == "draining":
                        # nothing queued and nothing in flight (run() only
                        # returns once every flow retires): park until
                        # close() flips the state or a late cancel lands
                        time.sleep(0.001)
                    continue
                for h in seed:
                    eng.submit(h.req, on_token=self._on_token)
                eng.set_arrival_source(self._arrival_source)
                try:
                    self.runs += 1
                    m = eng.run(max_time=self.run_max_time)
                finally:
                    eng.set_arrival_source(None)
                    self._fold_sched_counters()
                for r in m.completed:
                    h = self._flows.get(r.id)
                    if h is not None:
                        self._seal_if_terminal(h)
                # flows cut off by run_max_time were released by the
                # engine without a terminal state: seal them as failed so
                # drain() can never hang on a zombie handle
                for h in list(self._inflight.values()):
                    if h.req.terminal_status is None:
                        h.req.state = ReqState.FAILED
                        h.req.fault = "run hit max_time before the flow " \
                                      "finished"
                    self._seal_if_terminal(h)
        except BaseException as e:  # worker must never die silently
            self._worker_error = e
            for h in list(self._inflight.values()):
                h._finish("failed", f"front-end worker died: {e!r}")
            self._inflight.clear()
            raise

    # -- reporting ------------------------------------------------------------
    def _fold_sched_counters(self) -> None:
        """Accumulate the just-finished run's scheduler counters (worker
        thread, after every ``run()``)."""
        sched = self.engine.last_sched
        if sched is None or sched is self._folded_sched:
            return
        for k in self._SCHED_COUNTERS:
            self._sched_totals[k] += getattr(sched, k)
        self._folded_sched = sched

    def stats(self) -> dict:
        out = {
            "flows_submitted": self.flows_submitted,
            "flows_retired": self.flows_retired,
            "flows_in_flight": len(self._inflight),
            "backpressure_disconnects": self.backpressure_disconnects,
            "runs": self.runs,
        }
        out.update(self._sched_totals)
        # a run in progress has counters not yet folded: surface them live
        sched = self.engine.last_sched
        if sched is not None and sched is not self._folded_sched:
            for k in self._SCHED_COUNTERS:
                out[k] += getattr(sched, k)
        return out
