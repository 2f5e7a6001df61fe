"""In-program tracing of the serving loop: spans.

One ``Tracer`` belongs to each engine (``engine.tracer``); the engine hands
it to its backend, to every run's scheduler and simulator, and the serving
front end reads it through the engine.  It is off by default, and then
every call site costs one attribute test (``tracer.on``): no clock read, no
allocation, no record.

``enable()`` starts a recording: it clears the records and takes the
clock anchor.  While on, the call sites record spans: a name, start and end
in ``time.perf_counter_ns()`` (the clock of ``FlowHandle.submit_wall`` /
``token_walls``), the id of the span that caused it (the innermost span
open on the recording thread), the request id where there is one, and a
few integer attributes.  Spans opened with ``span()`` / ``open()`` nest on
a per-thread stack and carry the thread's id (``tid``); spans recorded
whole with ``record()`` (a flow's wait, whose start lies on another thread
or in an earlier turn) carry ``tid`` None.  A span's self time is its
duration less its children's.

The engine thread's spans, outermost first: ``engine.turn`` (one event-loop
turn), ``frontend.poll`` (the front end's arrival source; attribute
``flows``), ``sched.arrival`` / ``sched.complete`` / ``sched.dispatch``
(the scheduler's callbacks), ``backend.chunk`` (one prefill chunk; ``tokens``,
``pos``), ``backend.prefill_finish`` (a prefill's last step and first
token), ``backend.segment`` (one fused decode segment; ``steps``, ``live``,
``rows``, ``kv_limit``), ``backend.decode_step`` (one unfused decode step;
``live``, ``rows``, ``kv_limit``), ``backend.emit`` (the token callbacks of
one commit; ``rows``), ``backend.launch`` (the host's eager enqueue of one
device program) and ``backend.sync`` (one device-to-host fetch).

A request's way to its first token is three touching spans, recorded at
the boundaries where it crosses a layer (``FLOW``): ``frontend.handoff``
(submitted → the engine thread takes it), ``sched.queued`` (→ the start of
its first backend prefill work) and ``sched.prefill`` (→ its first token's
emit).

``anchor`` is one ``(time.time_ns(), time.perf_counter_ns())`` pair taken
back to back at ``enable()``: with it a reader maps the spans onto the wall
(epoch) clock of ``torch.profiler``'s events.  Spans are deliberately not
mirrored into ``record_function`` ranges, which the profiler would record
as device-side annotations.

Records live in memory, in a deque of at most ``LIMIT`` spans (the oldest
drop first); ``records()`` returns them, ordered by their end.  Nothing is
written anywhere.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

# the spans of a request's way to its first token, in order
FLOW = ("frontend.handoff", "sched.queued", "sched.prefill")
# spans kept (a traced minute of a busy engine records ~10^5)
LIMIT = 1 << 20


class Span:
    """One recorded span; ``start`` / ``end`` in ``perf_counter_ns``.  As
    a context manager (``with tracer.span(...)``) it closes on exit, an
    exception included."""

    __slots__ = ("id", "parent", "tid", "name", "rid", "start", "end",
                 "attrs", "_tr")

    def __init__(self, id_, parent, tid, name, rid, start, end, attrs,
                 tr=None):
        self.id = id_
        self.parent = parent
        self.tid = tid
        self.name = name
        self.rid = rid
        self.start = start
        self.end = end
        self.attrs = attrs
        self._tr = tr

    @property
    def dur(self) -> int:
        return self.end - self.start

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        self._tr.close(self)
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"rid={self.rid}, dur={self.dur} ns, attrs={self.attrs})")


class Tracer:
    """The spans of one engine; see the module's docstring."""

    def __init__(self):
        self.on = False
        self.anchor: Optional[Tuple[int, int]] = None
        self._records: deque = deque(maxlen=LIMIT)
        self._ids = itertools.count(1)
        self._local = threading.local()
        # rid -> [index in FLOW of the open span, its start, attributes]
        self._flows: Dict[int, list] = {}

    # -- switching ------------------------------------------------------------
    def enable(self) -> None:
        """Start a fresh recording (records and flows cleared)."""
        self._records.clear()
        self._flows.clear()
        self.anchor = (time.time_ns(), time.perf_counter_ns())
        self.on = True

    def disable(self) -> None:
        """Stop recording; the records stay readable."""
        self.on = False
        self._flows.clear()

    def records(self) -> List[Span]:
        return list(self._records)

    # -- spans ----------------------------------------------------------------
    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def open(self, name: str, rid: Optional[int] = None,
             start: Optional[int] = None, **attrs) -> Span:
        """Open a span on this thread's stack (``start`` defaults to now);
        ``with tracer.span(...)`` closes it on exit."""
        st = self._stack()
        sp = Span(next(self._ids), st[-1].id if st else None,
                  threading.get_ident(), name, rid,
                  time.perf_counter_ns() if start is None else start, None,
                  attrs or None, self)
        st.append(sp)
        return sp

    span = open

    def close(self, sp: Span, end: Optional[int] = None, **attrs) -> None:
        """Close ``sp`` (``end`` defaults to now), adding ``attrs``."""
        sp.end = time.perf_counter_ns() if end is None else end
        if attrs:
            sp.attrs = {**sp.attrs, **attrs} if sp.attrs else attrs
        st = self._stack()
        if st and st[-1] is sp:
            st.pop()
        elif sp in st:  # an inner span left open by a raise: drop it too
            del st[st.index(sp):]
        self._records.append(sp)

    def record(self, name: str, start: int, end: int,
               rid: Optional[int] = None, **attrs) -> None:
        """Record a finished span whose start lies outside this thread's
        stack; its parent is the span open here now."""
        st = self._stack()
        self._records.append(Span(next(self._ids), st[-1].id if st else None,
                                  None, name, rid, start, end,
                                  attrs or None))

    # -- a request's way to its first token (FLOW) ----------------------------
    def flow_begin(self, rid: int, phase: str, start: int, **attrs) -> None:
        """Open the flow of ``rid`` at ``phase`` (a name in ``FLOW``) at
        ``start``, unless an earlier layer opened it already."""
        if rid not in self._flows:
            self._flows[rid] = [FLOW.index(phase), start, attrs]

    def flow_mark(self, rid: int, phase: str, end: int) -> None:
        """If the flow of ``rid`` is in ``phase``, record that span up to
        ``end`` and start the next phase there."""
        f = self._flows.get(rid)
        i = FLOW.index(phase)
        if f is None or f[0] != i:
            return
        self.record(phase, f[1], end, rid=rid, **f[2])
        if i + 1 == len(FLOW):
            del self._flows[rid]
        else:
            f[0], f[1] = i + 1, end

    def flow_drop(self, rid: int) -> None:
        """Forget the flow of ``rid`` (it retired before its first token)."""
        self._flows.pop(rid, None)
