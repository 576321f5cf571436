"""``walk_pct``: the share of the window that the seeding walks of appearing elements and the re-selection walks (with their tests) took, by the
driver's own host walls (``GPLEDriver.phase_times["seed", "opt_reselect"]``) summed over
the completed spans."""

KEYS = ("seed", "opt_reselect",)


def read(ctx):
    return 100.0 * sum(ctx["phase_times"][k] for k in KEYS) / ctx["window_s"]
