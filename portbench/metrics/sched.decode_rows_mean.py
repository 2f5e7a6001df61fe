"""sched.decode_rows_mean: live rows a decode step, over the window: the
sum of live rows x steps of every decode dispatch the backend accounted
(its ``_account_decode``, wrapped), over the sum of steps; the window
outside the profiled span."""


def read(r):
    rec = r.recorder
    if rec is None or not rec.decode:
        return None
    steps = sum(n for _, n, _ in rec.decode)
    return sum(rows * n for rows, n, _ in rec.decode) / steps
