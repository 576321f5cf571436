"""``reopt_pct``: the share of the window that the host reoptimizations of the chunked path took, by the
driver's own host walls (``GPLEDriver.phase_times["optimize"]``) summed over
the completed spans."""

KEYS = ("optimize",)


def read(ctx):
    return 100.0 * sum(ctx["phase_times"][k] for k in KEYS) / ctx["window_s"]
