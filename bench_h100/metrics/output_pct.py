"""``output_pct``: the share of the window that the outputs (observables, records, with writers the files) took, by the
driver's own host walls (``GPLEDriver.phase_times["output"]``) summed over
the completed spans."""

KEYS = ("output",)


def read(ctx):
    return 100.0 * sum(ctx["phase_times"][k] for k in KEYS) / ctx["window_s"]
