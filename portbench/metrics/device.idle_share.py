"""device.idle_share: the share of the profiled sub-window in which no
kernel or copy ran on the card (one minus the union of their intervals
over the span), in %."""


def read(r):
    p = r.profile
    if not p or p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
