"""backend.decode_step_ms: wall of the backend's decode device calls in
the window, each through its token fetch (a fused segment, ``_run_segment``,
or an unfused step of ``decode_iteration``), over the steps they ran;
outside the profiled span."""


def read(r):
    rec = r.recorder
    if rec is None or not rec.segments:
        return None
    steps = sum(n for _, n in rec.segments)
    return 1e3 * sum(t for t, _ in rec.segments) / steps if steps else None
