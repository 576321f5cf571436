"""``init_pct``: the share of the window that the initializations (Metropolis selection and tuning, the first fit) took, by the
driver's own host walls (``GPLEDriver.phase_times["init"]``) summed over
the completed spans."""

KEYS = ("init",)


def read(ctx):
    return 100.0 * sum(ctx["phase_times"][k] for k in KEYS) / ctx["window_s"]
