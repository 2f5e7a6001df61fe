"""reactive_ttft_mean_s: mean, over every reactive request due inside the
window that streamed a token, of its first token's wall instant minus the
instant it was due (a late generator's lag counts)."""


def read(r):
    v = [s.handle.token_walls[0] - s.due for s in r.in_window("reactive")
         if s.handle.token_walls]
    return sum(v) / len(v) if v else None
