"""``launch_pct``: the share of the window that the host spent launching
CUDA graph replays, by the program's ``launch`` spans
(``GPLEDriver.phase_times["launch"]``: each replay and its launch count)
summed over the completed spans.  Where the card is busy the launch queue
fills and a replay's launch waits for it, so the cells that list it are
those whose card waits for the host.  None where the program recorded no
replay: on the CPU, or in a program without the span."""


def read(ctx):
    seconds = ctx["phase_times"].get("launch", 0.0)
    if not seconds or ctx["window_s"] <= 0:
        return None
    return 100.0 * seconds / ctx["window_s"]
