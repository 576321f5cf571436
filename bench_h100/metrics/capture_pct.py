"""``capture_pct``: the share of the window that the CUDA graph captures
took, by the program's ``capture`` spans (``GPLEDriver.phase_times["capture"]``:
each span's fresh driver captures its tick, period-end and walk graphs again)
summed over the completed spans.  None where the program recorded no
capture: on the CPU, or in a program without the span."""


def read(ctx):
    seconds = ctx["phase_times"].get("capture", 0.0)
    if not seconds or ctx["window_s"] <= 0:
        return None
    return 100.0 * seconds / ctx["window_s"]
