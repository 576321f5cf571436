"""``ladder_mfu``: the reference-parity trajectory's share of the card's
FP64 peak: the operations its completed ticks need with the cutoff evolve
(``arith.cutoff_tick_flops``) and those of the ladder's loss evaluations
(``arith.ladder_eval_flops`` for each ``zoom.evaluations``), over the
window's seconds times 67 TFLOP/s (H100 SXM, FP64 tensor cores).  The
ladder's other work (each solve's last constraint reading, a stage's end,
the global sweep, the magnitudes) is not counted.  None where no ladder
ran."""

from bench_h100 import arith


def read(ctx):
    evaluations = ctx["zoom"]["evaluations"]
    if not evaluations:
        return None
    cfg = ctx["cfg"]
    pops = cfg.initial_population
    active = (pops[0] > 0, pops[0] > 0 and pops[1] > 0, pops[1] > 0)
    n, n_extra = cfg.num_points, cfg.num_extra_points
    flops = (arith.cutoff_tick_flops(n, n_extra, active, cfg.reopt_freq) * ctx["ticks"]
             + arith.ladder_eval_flops(n, n_extra, active) * evaluations)
    return 100.0 * flops / (ctx["window_s"] * arith.FP64_PEAK_FLOPS)
