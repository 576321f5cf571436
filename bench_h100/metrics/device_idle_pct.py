"""``device_idle_pct``: the share of the window in which no device operation
ran: one minus the traced span's device busy time (the union of the trace's
device intervals) over the wall of the same span run untraced, the window
of the traced run's per-layer metrics.  The trace slows the host, so the
traced span's own wall would count the tracer's cost as idle time."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["busy_s"] <= 0 or ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / ctx["window_s"])
