"""backend.prefill_chunk_ms: wall of the backend's prefill-chunk calls
(the scheduler's ``prefill_chunk`` hook: prefix copy and forward pieces,
enqueued) over their count, in the window outside the profiled span."""


def read(r):
    rec = r.recorder
    if rec is None or not rec.prefill:
        return None
    return 1e3 * sum(rec.prefill) / len(rec.prefill)
