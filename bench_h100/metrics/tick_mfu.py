"""``tick_mfu``: the trajectory's share of the card's FP64 peak: the
operations the ticks completed in the window need (``arith.tick_flops`` of
the configuration's sizes, from its initially active elements) over the
window's seconds times 67 TFLOP/s (H100 SXM, FP64 tensor cores)."""

from bench_h100 import arith


def read(ctx):
    cfg = ctx["cfg"]
    pops = cfg.initial_population
    active = (pops[0] > 0, pops[0] > 0 and pops[1] > 0, pops[1] > 0)
    flops = arith.tick_flops(cfg.num_points, cfg.num_extra_points, active, cfg.reopt_freq)
    return 100.0 * flops * ctx["ticks"] / (ctx["window_s"] * arith.FP64_PEAK_FLOPS)
