"""``period_end_dev_ms``: the card's milliseconds a reoptimization period's
end in fused segments (the moment reopt, the refit, the extra clouds): the
CUDA-event time of the segments' period-end replays
(``GPLEDriver.phase_times["dev.fused_period_end"]``) summed over the
completed spans, over their periods (ticks over ``reopt_freq``).  None
where the program recorded no such event: on the CPU, with no fused
segment, or in a program without them."""


def read(ctx):
    seconds = ctx["phase_times"].get("dev.fused_period_end", 0.0)
    periods = ctx["ticks"] / ctx["cfg"].reopt_freq
    if not seconds or periods <= 0:
        return None
    return 1e3 * seconds / periods
