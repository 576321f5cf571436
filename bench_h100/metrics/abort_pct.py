"""``abort_pct``: the share of the window that the fused segments rolled back on an event took, by the
driver's own host walls (``GPLEDriver.phase_times["fused_abort"]``) summed over
the completed spans."""

KEYS = ("fused_abort",)


def read(ctx):
    return 100.0 * sum(ctx["phase_times"][k] for k in KEYS) / ctx["window_s"]
