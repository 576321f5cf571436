"""``ladder_eval_ms``: the host milliseconds of the ladder for each loss
evaluation of its zoom line search: the program's ``stage`` spans (each a
ladder stage, to the pull of its results) over its ``zoom.evaluations``
counter (each value and gradient of the loss), both summed over the
completed spans.  None where no ladder ran."""


def read(ctx):
    evaluations = ctx["zoom"]["evaluations"]
    if not evaluations or not ctx["stage_s"]:
        return None
    return 1e3 * ctx["stage_s"] / evaluations
