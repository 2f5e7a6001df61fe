"""The traced run's instrumentation, installed from the benchmark's own
files and only with ``--trace 1``: wrappers around the backend's calls
(decode segments, prefill chunks, the decode accounting that knows the
live rows), ``record_function`` ranges around the backend's calls and
around what the cell's metric files name (``RANGES``), the kernel-work
recorders at the ``ops.*`` boundary the metric files name (``WRAPS``), and
``torch.profiler`` over a steady sub-window of the measured window.

``Recorder`` collects; ``reduce_profile`` turns the profile into device
busy time, idle share, time by kernel and by range, and the breakdown.
"""
from __future__ import annotations

import contextlib
import importlib
import time

# the record_function ranges the benchmark opens around the backend's calls
HOST_RANGES = ("backend.decode_segment", "backend.decode_iteration",
               "backend.prefill_chunk", "backend.prefill_done",
               "frontend.arrivals")


class Recorder:
    """Counts and walls from the wrapped calls: only while ``on``, which is
    the window outside the profiled span (the profiler slows the host, so
    walls taken under it would read high); ``on_s`` is that time."""

    def __init__(self, wraps=None, ranges=None):
        self.wraps = wraps or {}  # metric -> {ops entry point: bound}
        self.ranges = ranges or {}  # label -> (module, function names)
        self.on = False
        self.on_s = 0.0
        self._since = None
        self.decode = []  # (live rows, steps, ctx pairs)
        self.segments = []  # (wall s, steps) of each decode device call
        self.prefill = []  # wall s of each prefill_chunk call
        self.prefill_tokens = []  # (start, n) of each forward bucket run
        self.work = {k: [] for k in self.wraps}  # 0-d bound tensors
        self.work_on = False
        # calls to run on the engine's thread at its next turn (the
        # profiler records the host ops of the thread that starts it)
        self.engine_calls = []


    def switch(self, on: bool) -> None:
        now = time.perf_counter()
        if self.on and self._since is not None:
            self.on_s += now - self._since
        self.on, self._since = on, now


@contextlib.contextmanager
def _patched(obj, name, make):
    real = getattr(obj, name)
    setattr(obj, name, make(real))
    try:
        yield real
    finally:
        setattr(obj, name, real)


def _ranged(label, fn):
    import torch

    def wrapped(*a, **kw):
        with torch.profiler.record_function(label):
            return fn(*a, **kw)
    return wrapped


@contextlib.contextmanager
def instrument(rec: Recorder, backend, frontend):
    """Install every wrapper of the traced run; ``rec.on`` gates the
    counting, ``rec.work_on`` the kernel-work recorders."""
    from repro_torch.kernels import ops

    def account(real):
        def wrapped(slots, n, rows, kvl):
            if rec.on:
                pos = [backend._slot_pos.get(s, 0) for s in slots]
                pairs = sum(n * (p + 1) + n * (n - 1) // 2 for p in pos)
                rec.decode.append((len(slots), n, pairs))
            return real(slots, n, rows, kvl)
        return wrapped

    def segment(real):
        def wrapped():
            t0 = time.perf_counter()
            steps0 = backend.fused_steps
            out = _ranged("backend.decode_segment", real)()
            if rec.on:
                rec.segments.append((time.perf_counter() - t0,
                                     backend.fused_steps - steps0))
            return out
        return wrapped

    def iteration(real):
        def wrapped(reqs, now):
            t0 = time.perf_counter()
            calls0 = backend.decode_device_calls
            segs0 = backend.decode_segments
            out = _ranged("backend.decode_iteration", real)(reqs, now)
            if rec.on and backend.decode_segments == segs0 \
                    and backend.decode_device_calls > calls0:
                # a single (unfused) step: one device call and its fetch
                rec.segments.append((time.perf_counter() - t0, 1))
            return out
        return wrapped

    def chunk(real):
        def wrapped(req, seq_start, tokens, now):
            t0 = time.perf_counter()
            out = _ranged("backend.prefill_chunk", real)(req, seq_start,
                                                         tokens, now)
            if rec.on:
                rec.prefill.append(time.perf_counter() - t0)
            return out
        return wrapped

    def forward_run(real):
        def wrapped(req, start, n):
            if rec.on and n > 0:
                rec.prefill_tokens.append((start, n))
            return real(req, start, n)
        return wrapped

    def work(kind, bound):
        def make(real):
            def wrapped(*a, **kw):
                out = real(*a, **kw)
                if rec.work_on:
                    rec.work[kind].append(bound(*a, **kw))
                return out
            return wrapped
        return make

    with contextlib.ExitStack() as stack:
        stack.enter_context(_patched(backend, "_account_decode", account))
        stack.enter_context(_patched(backend, "_run_segment", segment))
        stack.enter_context(_patched(backend, "prefill_chunk", chunk))
        stack.enter_context(_patched(backend, "decode_iteration", iteration))
        stack.enter_context(_patched(backend, "_run_bucketed_in_pool",
                                     forward_run))
        stack.enter_context(_patched(
            backend, "prefill_done",
            lambda real: _ranged("backend.prefill_done", real)))
        def arrivals(real):
            ranged = _ranged("frontend.arrivals", real)

            def wrapped(now):
                while rec.engine_calls:
                    rec.engine_calls.pop(0)()
                return ranged(now)
            return wrapped
        stack.enter_context(_patched(frontend, "_arrival_source", arrivals))
        for metric, wraps in rec.wraps.items():
            for name, bound in wraps.items():
                stack.enter_context(_patched(ops, name, work(metric, bound)))
        for label, (module, names) in rec.ranges.items():
            mod = importlib.import_module(module)
            for name in names:
                stack.enter_context(_patched(
                    mod, name, lambda real, label=label: _ranged(label, real)))
        yield


def _union(intervals):
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def reduce_profile(prof, span_s: float, ranges=()) -> dict:
    """From a finished ``torch.profiler.profile``: busy seconds (the union
    of the device's kernel and copy intervals), the traced span, device
    seconds by kernel name, by benchmark range (the device time of the
    kernels launched inside it), and the longest idle gaps by the host
    range that was open when each began."""
    from torch.autograd import DeviceType
    events = prof.events()
    dev, host = [], []
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if e.name in HOST_RANGES or e.name in ranges:
                continue
            dev.append((tr.start / 1e6, tr.end / 1e6, e.name))
        elif e.name in HOST_RANGES:
            host.append((tr.start / 1e6, tr.end / 1e6, e.name))
    by_name: dict = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    busy = _union([(s, e) for s, e, _ in dev])
    inside = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU and e.key in ranges:
            inside[e.key] = getattr(
                e, "device_time_total",
                getattr(e, "cuda_time_total", 0.0)) / 1e6
    # idle gaps between consecutive device intervals, labelled by the
    # innermost benchmark host range open at the gap's start
    gaps: dict = {}
    host.sort()
    j, last_end = 0, None
    for s, e, _ in sorted(dev):
        if last_end is not None and s > last_end:
            while j < len(host) and host[j][1] < last_end:
                j += 1
            label = "engine and scheduler (no range)"
            if j < len(host) and host[j][0] <= last_end:
                label = host[j][2]
            gaps[label] = gaps.get(label, 0.0) + (s - last_end)
        last_end = e if last_end is None else max(last_end, e)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": span_s, "by_name": by_name,
            "ranges": inside,
            "breakdown": {"device_ops": [[n, t] for n, t in top_ops],
                          "idle_gaps": [[n, t] for n, t in top_gaps]}}
