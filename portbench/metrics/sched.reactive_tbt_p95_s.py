"""sched.reactive_tbt_p95_s: the 95th percentile of the gaps between
consecutive tokens of reactive flows, both tokens inside the window
(producer-side wall instants)."""
import statistics


def read(r):
    gaps = []
    for s in r.sent:
        if s.job.priority != "reactive":
            continue
        w = [t for t in s.handle.token_walls if r.t0 <= t < r.t1]
        gaps += [b - a for a, b in zip(w, w[1:])]
    if len(gaps) < 20:
        return None
    return statistics.quantiles(gaps, n=20)[-1]
