"""``tick_dev_ms``: the card's milliseconds a tick in fused segments: the
CUDA-event time of the segments' tick-graph replays
(``GPLEDriver.phase_times["dev.fused_tick"]``) summed over the completed
spans, over their ticks.  It counts whole ticks only where every tick of
the window is fused.  None where the program recorded no such event: on the
CPU, with no fused segment, or in a program without them."""


def read(ctx):
    seconds = ctx["phase_times"].get("dev.fused_tick", 0.0)
    if not seconds or ctx["ticks"] <= 0:
        return None
    return 1e3 * seconds / ctx["ticks"]
