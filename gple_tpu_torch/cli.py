"""Command-line interface (counterpart of :mod:`gple_tpu.cli`).

    python -m gple_tpu_torch.cli gple --input input --outdir out [--model DAC]
        [--max-ticks N] [--device cuda|cpu] [--quiet]
        [--opt-mode moment|ladder] [--reference-parity]
        [--checkpoint FILE --checkpoint-every K] [--resume FILE]

Reads the reference's 8-field ``input`` file, runs the GPR-MQCLE trajectory
on ``--device`` (the CUDA card unless ``cpu`` is given) and writes the
reference's output files into ``--outdir``.  ``--opt-mode ladder`` takes the
constrained restart ladder; ``--reference-parity`` runs run-for-run
comparable to the reference (the ladder, the cutoff evolution, the initial
purity target, corr pinned to 1).  ``--checkpoint`` with
``--checkpoint-every K`` writes the state every K ticks; ``--resume``
continues from a checkpoint of either package.  The last stdout line is the
reference's: p0 (ln E for DAC) and the final populations.

Not ported yet, and refused with a message naming the ROADMAP item: the
exact-oracle subcommands ``se`` and ``le``.
"""

from __future__ import annotations

import argparse
import math
import sys

NOT_PORTED = {
    "oracles": "the exact oracles and their se / le subcommands (ROADMAP Queue A item 12)",
}


def _parser():
    ap = argparse.ArgumentParser(prog="gple_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("gple", help="GPR-MQCLE propagation (reference gple.x)")
    g.add_argument("--input", default="input", help="reference-format input file")
    g.add_argument("--outdir", default="output", help="output directory")
    g.add_argument("--model", default="DAC", choices=["SAC", "DAC", "ECR"],
                   help="Tully model (the reference's compile-time TestModel)")
    g.add_argument("--max-ticks", type=int, default=None)
    g.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    g.add_argument("--quiet", action="store_true")
    g.add_argument("--checkpoint", default=None, help="checkpoint file to write")
    g.add_argument("--checkpoint-every", type=int, default=0,
                   help="write --checkpoint every this many ticks")
    g.add_argument("--resume", default=None, help="checkpoint file to resume from")
    g.add_argument("--opt-mode", default=None, choices=["moment", "ladder"],
                   help="hyperparameter strategy (default: moment; see "
                   "GPLEConfig.opt_mode)")
    g.add_argument("--reference-parity", action="store_true",
                   help="run-for-run comparable to the reference: evolution cutoff on, "
                   "initial purity target, corr pinned to 1, constrained ladder")
    for name in ("se", "le"):
        sub.add_parser(name, help="exact oracle (not ported yet)")
    return ap


def main(argv=None):
    ap = _parser()
    opts = ap.parse_args(argv)
    if opts.cmd in ("se", "le"):
        ap.error(f"{opts.cmd}: not ported yet: {NOT_PORTED['oracles']}")

    from gple_tpu_torch.config import GPLEConfig
    from gple_tpu_torch.driver import GPLEDriver

    extra = {}
    if opts.opt_mode:
        extra["opt_mode"] = opts.opt_mode
    if opts.reference_parity:
        extra["reference_parity"] = True
    cfg = GPLEConfig.from_input_file(opts.input, model=opts.model, **extra)
    drv = GPLEDriver(cfg, outdir=opts.outdir, verbose=not opts.quiet, device=opts.device)
    last = drv.run(max_ticks=opts.max_ticks, checkpoint_path=opts.checkpoint,
                   checkpoint_every=opts.checkpoint_every, resume_from=opts.resume)[-1]
    lead = math.log(cfg.p0**2 / 2.0 / cfg.mass) if cfg.model == "DAC" else cfg.p0
    print(lead, *last.population_mci)
    return 0


if __name__ == "__main__":
    sys.exit(main())
