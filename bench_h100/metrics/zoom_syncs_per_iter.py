"""``zoom_syncs_per_iter``: the device-to-host pulls of the ladder's zoom
L-BFGS for each of its iterations: the program's ``zoom.syncs`` counter over
its ``zoom.iterations``, both summed over the completed spans.  None where no
ladder ran."""


def read(ctx):
    iterations = ctx["zoom"]["iterations"]
    if not iterations:
        return None
    return ctx["zoom"]["syncs"] / iterations
