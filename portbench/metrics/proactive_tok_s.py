"""proactive_tok_s: every token streamed to a proactive client inside the
window (its producer-side wall instant, ``FlowHandle.token_walls``), over
the window's length."""


def read(r):
    n = sum(1 for s in r.sent if s.job.priority == "proactive"
            for t in s.handle.token_walls if r.t0 <= t < r.t1)
    return n / r.window_s
