"""reactive_reply_mean_s: mean, over every reactive request due inside the
window that finished, of its last token's wall instant minus the instant
it was due: the whole reply a waiting agent needs.  The run serves on
after the window until each of them has finished."""


def read(r):
    v = [s.handle.token_walls[-1] - s.due for s in r.in_window("reactive")
         if s.handle.status == "completed" and s.handle.token_walls]
    return sum(v) / len(v) if v else None
