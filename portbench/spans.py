"""Readings of the program's own spans (``repro_torch.core.tracing``).

The library part, for metric readers and tests:

* ``profiler_offset_ns``: the nanoseconds that take a ``torch.profiler``
  event's start (microseconds from the trace's start) onto the program's
  ``perf_counter_ns`` clock, through the tracer's anchor;
* ``device_intervals``: the profile's kernel and copy intervals on that
  clock (the events ``tracing.reduce_profile`` counts as busy);
* ``innermost``: one thread's nested spans cut into segments, each with the
  innermost span open there (a span's self time is the length of its
  segments);
* ``idle_by_span``: the device's idle time in a span of time, split over
  the innermost engine-thread span open at each instant (self time, not
  the span open when a gap began), and the residual with no span open;
* ``ttft_parts``: the reactive flows' way to their first token
  (``frontend.handoff``, ``sched.queued``, ``sched.prefill``), as means
  over the flows whose whole way lies in a span of time;
* ``queue_overlap``: the share of those flows' queue wait during which
  another reactive flow's prefill was under way;
* ``self_shares``: the engine thread's self time in a span of time, by
  the same classes as the idle split (a cross-check of that split from
  outside the profiled span);
* ``step_figures``: decode step time, rows a step and prefill chunk time
  from the backend's spans.

Run alone, on the card, it is a traced run of one cell with the program's
tracer on, and prints those readings beside the cell's per-layer metrics:

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s>

It drives ``bench.serve`` with ``--trace 1``'s profiler and wrappers;
around it, it switches the engine's tracer on (through ``serve``'s
``hook``), notes each flow's submit instant and token walls as it is
submitted (``bench.submitter``), and keeps the profile's device intervals
(``tracing.reduce_profile``), which ``serve`` itself does not hand on.  It
checks no tokens.  It prints one JSON line, with every reactive flow's
parts (``reactive_ways``).  This runner, ``traced_serve`` and ``main``, is
for a cell whose ``--trace 1`` run does not yet hand the tracer's records
and the profile's device intervals to the metric readers.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from typing import Optional

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the spans whose self time is device-idle time charged to the host's
# launches and to its device-to-host fetches; every other span is the loop
LAUNCH, SYNC = "backend.launch", "backend.sync"
# ``repro_torch.core.tracing.FLOW``, by name: nothing of the program is
# imported here, so a program without the tracer reads as no spans
FLOW = ("frontend.handoff", "sched.queued", "sched.prefill")


def profiler_offset_ns(trace_start_ns: int, anchor) -> int:
    """Add to ``1000 * event.time_range.start`` (an event's microseconds
    from the trace's start) to read it in ``perf_counter_ns``: the trace
    starts at ``trace_start_ns`` of the wall (epoch) clock, and the anchor
    is one ``(time_ns, perf_counter_ns)`` pair taken back to back."""
    wall, perf = anchor
    return trace_start_ns - wall + perf


def trace_start_ns(prof) -> int:
    """The wall-clock instant a finished ``torch.profiler.profile``'s
    trace started, in ns."""
    kr = prof.profiler.kineto_results
    if hasattr(kr, "trace_start_ns"):
        return kr.trace_start_ns()
    return kr.trace_start_us() * 1000


def device_intervals(prof, offset_ns: int, ranges=()) -> list:
    """(start, end) ns of every kernel and copy on the device, on the
    program's clock; the events ``tracing.reduce_profile`` counts busy."""
    from torch.autograd import DeviceType
    from portbench.tracing import HOST_RANGES
    out = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name not in HOST_RANGES \
                and e.name not in ranges:
            tr = e.time_range
            out.append((offset_ns + round(tr.start * 1000),
                        offset_ns + round(tr.end * 1000)))
    return out


def engine_spans(spans) -> list:
    """The spans of the thread that ran ``engine.turn`` (the stacked
    spans of one thread; a record made whole has ``tid`` None)."""
    tids = {s.tid for s in spans if s.name == "engine.turn"}
    tid = tids.pop() if len(tids) == 1 else None
    return [s for s in spans if s.tid is not None
            and (tid is None or s.tid == tid)]


def innermost(spans) -> list:
    """Cut one thread's nested spans into (start, end, span) segments,
    ``span`` the innermost open over the segment, in time order.  At one
    instant ends go before starts, an inner span ends before its outer one
    and an outer span starts before its inner one."""
    ev = []
    for s in spans:
        ev.append((s.start, 1, -s.end, s))
        ev.append((s.end, 0, -s.start, s))
    ev.sort(key=lambda e: e[:3])
    out, stack, prev = [], [], None
    for t, opens, _, s in ev:
        if stack and t > prev:
            out.append((prev, t, stack[-1]))
        prev = t
        if opens:
            stack.append(s)
        elif stack and stack[-1] is s:
            stack.pop()
        else:
            stack.remove(s)
    return out


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_intervals(busy, lo: int, hi: int) -> list:
    """[lo, hi) less the union of the ``busy`` intervals."""
    out, cur = [], lo
    for s, e in _union(busy):
        if e <= cur:
            continue
        if s >= hi:
            break
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if cur < hi:
        out.append((cur, hi))
    return out


def idle_by_span(spans, busy, lo: int, hi: int):
    """Split the device's idle time in [lo, hi) over the innermost
    engine-thread span open at each instant.  Returns ({span name: idle
    ns}, residual ns: idle while no span was open)."""
    segs = innermost(engine_spans(spans))
    by_name: dict = {}
    total = 0
    j = 0
    for a, b in idle_intervals(busy, lo, hi):
        total += b - a
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            s, e, sp = segs[k]
            cut = min(b, e) - max(a, s)
            if cut > 0:
                by_name[sp.name] = by_name.get(sp.name, 0) + cut
            k += 1
    return by_name, total - sum(by_name.values())


def idle_shares(by_name: dict, residual: int, span_ns: int) -> dict:
    """The idle split as % of the span: under the host's launches, under
    its fetches, under the rest of the loop, and with no span open."""
    launch = by_name.get(LAUNCH, 0)
    sync = by_name.get(SYNC, 0)
    loop = sum(by_name.values()) - launch - sync
    return {k: 100.0 * v / span_ns for k, v in
            (("launch", launch), ("sync", sync), ("host_loop", loop),
             ("residual", residual))}


def reactive_flows(spans) -> dict:
    """rid -> {FLOW name: span} of every reactive flow's way to its first
    token (as far as it got)."""
    flows: dict = {}
    for s in spans:
        if s.name in FLOW and s.attrs and s.attrs.get("reactive"):
            flows.setdefault(s.rid, {})[s.name] = s
    return flows


def ttft_parts(spans, lo: int, hi: int):
    """Mean seconds of each FLOW part over the reactive flows whose whole
    way to their first token lies in [lo, hi) (a traced run's profiler
    stops the engine after its span: a flow caught by that pause is left
    out); and their rids."""
    chosen = {rid: f for rid, f in reactive_flows(spans).items()
              if len(f) == 3 and lo <= f[FLOW[0]].start
              and f[FLOW[2]].end < hi}
    if not chosen:
        return None, []
    return ({n: statistics.fmean(f[n].dur for f in chosen.values()) / 1e9
             for n in FLOW}, sorted(chosen))


def queue_overlap(spans, rids) -> Optional[float]:
    """Of the summed ``sched.queued`` time of the reactive flows ``rids``,
    the share during which another reactive flow's ``sched.prefill`` was
    open (the scheduler admits one reactive prefill at a time)."""
    flows = reactive_flows(spans)
    prefills = {rid: (f[FLOW[2]].start, f[FLOW[2]].end)
                for rid, f in flows.items() if FLOW[2] in f}
    queued = covered = 0
    for rid in rids:
        q = flows[rid][FLOW[1]]
        queued += q.dur
        for a, b in _union(iv for r, iv in prefills.items() if r != rid):
            covered += max(0, min(b, q.end) - max(a, q.start))
    return covered / queued if queued else None


def self_shares(spans, lo: int, hi: int) -> dict:
    """The engine thread's self time in [lo, hi), as % of it: in the
    host's launches, in its fetches, in the rest of the loop, and with no
    span open."""
    by_name: dict = {}
    for a, b, sp in innermost(engine_spans(spans)):
        cut = min(b, hi) - max(a, lo)
        if cut > 0:
            by_name[sp.name] = by_name.get(sp.name, 0) + cut
    return idle_shares(by_name, hi - lo - sum(by_name.values()), hi - lo)


def step_figures(spans, lo: int, hi: int) -> dict:
    """From the backend's spans starting in [lo, hi): decode wall a step
    (fused segments and unfused steps, each through its token fetch), live
    rows a step, and the prefill-chunk wall a call."""
    steps = rows = wall = 0
    chunks = []
    for s in spans:
        if not lo <= s.start < hi:
            continue
        if s.name in ("backend.segment", "backend.decode_step"):
            n = s.attrs.get("steps", 1)
            steps += n
            rows += n * s.attrs["live"]
            wall += s.dur
        elif s.name == "backend.chunk":
            chunks.append(s.dur)
    return {"decode_step_ms": wall / steps / 1e6 if steps else None,
            "decode_rows_mean": rows / steps if steps else None,
            "prefill_chunk_ms": statistics.fmean(chunks) / 1e6
            if chunks else None,
            "decode_steps": steps}


def longest(spans, lo: int, hi: int, k: int = 5) -> list:
    """The ``k`` engine-thread spans with the most self time among those
    starting in [lo, hi): (name, rid, self s, duration s)."""
    own: dict = {}
    for s, e, sp in innermost(engine_spans(spans)):
        own[sp.id] = own.get(sp.id, 0) + (e - s)
    top = sorted((s for s in engine_spans(spans) if lo <= s.start < hi),
                 key=lambda s: -own.get(s.id, 0))[:k]
    return [(s.name, s.rid, own.get(s.id, 0) / 1e9, s.dur / 1e9)
            for s in top]


def span_cost(n: int = 200_000) -> dict:
    """ns a call site costs with the tracer off (its one attribute test)
    and on (a span opened and closed), over an empty function's; and, off, a
    site that is a method of its own around the work (``_to_host``,
    ``_emit_first``, ``prefill_chunk`` over ``_prefill_piece``) over the
    work called directly."""
    from repro_torch.core.tracing import Tracer
    tr = Tracer()

    class Site:
        tracer = tr

        def work(self):
            pass

        def framed(self):
            if not self.tracer.on:
                return self.work()
            with self.tracer.span("x", 1):
                return self.work()

    def empty():
        pass

    def site():
        if tr.on:
            with tr.span("x", 1, rows=1):
                pass

    def timed(body) -> int:
        best = None
        for _ in range(3):
            t = time.perf_counter_ns()
            for _ in range(n):
                body()
            t = time.perf_counter_ns() - t
            best = t if best is None else min(best, t)
        return best

    s = Site()
    base, off = timed(empty), timed(site)
    direct, framed = timed(s.work), timed(s.framed)
    tr.enable()
    on = timed(site)
    return {"off_ns": (off - base) / n, "on_ns": (on - base) / n,
            "off_frame_ns": (framed - direct) / n}


def traced_serve(cell, seed: int, seconds: float, device,
                 t_start: float) -> dict:
    """One traced run of ``cell`` with the program's tracer on, and its
    readings (see the module's docstring)."""
    import torch
    from portbench import bench, tracing
    box: dict = {"flows": {}}

    def hook(backend):
        box["tracer"] = backend.tracer
        backend.tracer.enable()

    real_submitter, real_reduce = bench.submitter, tracing.reduce_profile

    def submitter(frontend, max_len):
        submit = real_submitter(frontend, max_len)

        def noted(job):
            h = submit(job)
            box["flows"][h.flow_id] = (h.submit_wall, h.token_walls)
            return h
        return noted

    def reduce_profile(prof, span_s, ranges=()):
        off = profiler_offset_ns(trace_start_ns(prof), box["tracer"].anchor)
        box["busy"] = device_intervals(prof, off, ranges)
        box["span"] = (off, span_s)  # the trace's start on the spans' clock
        return real_reduce(prof, span_s, ranges)

    bench.submitter, tracing.reduce_profile = submitter, reduce_profile
    try:
        r, done, _, peak = bench.serve(cell, seed, seconds, True, device,
                                       t_start, hook=hook)
    finally:
        bench.submitter, tracing.reduce_profile = (real_submitter,
                                                   real_reduce)
    tr = box["tracer"]
    tr.disable()
    spans = tr.records()
    metrics = bench.read_metrics(cell, r, True)
    # the window outside the profiled span, as the wrappers count it
    on = (round(r.t0 * 1e9), round((r.t0 + r.recorder.on_s) * 1e9))
    parts, rids = ttft_parts(spans, *on)
    walls = [box["flows"][rid][1][0] - box["flows"][rid][0] for rid in rids]
    # every reactive flow submitted in the window: its parts, as far as
    # it got before the run ended (s from the window's start, then s each)
    ways = [[rid, (f[FLOW[0]].start - on[0]) / 1e9]
            + [f[n].dur / 1e9 if n in f else None for n in FLOW]
            for rid, f in sorted(reactive_flows(spans).items())
            if FLOW[0] in f and on[0] <= f[FLOW[0]].start < on[1]]
    lo, span_s = box["span"]
    hi = lo + round(span_s * 1e9)
    by_name, residual = idle_by_span(spans, box["busy"], lo, hi)
    launch_s = sum(min(s.end, hi) - max(s.start, lo) for s in spans
                   if s.name == LAUNCH and s.start < hi and s.end > lo) / 1e9
    shares = idle_shares(by_name, residual, hi - lo)
    fig = step_figures(spans, *on)
    n_on = sum(1 for s in spans if on[0] <= s.start < on[1])
    # a flow cut from ``parts`` waited at least until the window's end
    cut = [on[1] - f[FLOW[0]].start for rid, f in reactive_flows(spans).items()
           if FLOW[0] in f and on[0] <= f[FLOW[0]].start < on[1]
           and rid not in rids]
    return {
        "cell": cell.name, "seed": seed,
        "device": torch.cuda.get_device_name(device)
        if torch.device(device).type == "cuda" else str(device),
        "reactive_flows": len(rids),
        "reactive_flows_cut": len(ways) - len(rids),
        "frontend.reactive_inbox_wait_s": parts and parts[FLOW[0]],
        "sched.reactive_queue_wait_s": parts and parts[FLOW[1]],
        "sched.reactive_prefill_s": parts and parts[FLOW[2]],
        "reactive_first_token_mean_s": statistics.fmean(walls)
        if walls else None,
        "reactive_cut_wait_at_least_s": statistics.fmean(cut) / 1e9
        if cut else None,
        "queue_share_beside_reactive_prefill": queue_overlap(spans, rids),
        "device.idle_launch_share": shares["launch"],
        "device.idle_host_loop_share": shares["host_loop"],
        "idle_sync_share": shares["sync"],
        "idle_residual_share": shares["residual"],
        "idle_s_by_span": {k: v / 1e9 for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])},
        "idle_s_spans": (sum(by_name.values()) + residual) / 1e9,
        "idle_s_profile": r.profile["window_s"] - r.profile["busy_s"],
        "span_s": span_s,
        "device_events": sum(1 for a, b in box["busy"] if lo <= a < hi),
        "launch_s": launch_s,
        "engine_self_shares_profiled": self_shares(spans, lo, hi),
        "engine_self_shares_unprofiled": self_shares(spans, *on),
        "in_program": fig,
        "spans_per_decode_step": n_on / fig["decode_steps"]
        if fig["decode_steps"] else None,
        "spans_recorded": len(spans),
        "longest_self": longest(spans, *on),
        "per_layer": {k: v["value"] for k, v in metrics.items()},
        "memory_peak_bytes": int(peak),
        "finished": len(done),
        "reactive_ways": ways,
    }


def main(argv=None) -> int:
    sys.path[:0] = [p for p in (os.path.join(ROOT, "src"), ROOT)
                    if p not in sys.path]
    from portbench import bench
    from portbench.run import _environment
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    _environment()
    import torch
    spec = bench.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = bench.load_cell(spec, args.workload)
    if not torch.cuda.is_available():
        print("spans: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.set_num_threads(1)
    cost = span_cost()
    out = {"span_cost_ns": cost,
           **traced_serve(cell, args.seed, args.seconds, device, T_START)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
