"""Command-line interface (counterpart of :mod:`gple_tpu.cli`).

    python -m gple_tpu_torch.cli gple --input input --outdir out [--model DAC]
        [--max-ticks N] [--device cuda|cpu] [--quiet]

Reads the reference's 8-field ``input`` file, runs the GPR-MQCLE trajectory
on ``--device`` (the CUDA card unless ``cpu`` is given) and writes the
reference's output files into ``--outdir``.  The last stdout line is the
reference's: p0 (ln E for DAC) and the final populations.

Not ported yet, and refused with a message naming the ROADMAP item: the
checkpoint flags (``--checkpoint``, ``--checkpoint-every``, ``--resume``), the
constrained ladder (``--opt-mode ladder``, ``--reference-parity``) and the
exact-oracle subcommands ``se`` and ``le``.
"""

from __future__ import annotations

import argparse
import math
import sys

NOT_PORTED = {
    "checkpoint": "io/checkpoint.py and the CLI's checkpoint flags (ROADMAP Queue A "
                  "item 10)",
    "ladder": "the constrained ladder (ROADMAP Queue A item 11)",
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
    g.add_argument("--checkpoint", default=None, help="not ported yet")
    g.add_argument("--checkpoint-every", type=int, default=0, help="not ported yet")
    g.add_argument("--resume", default=None, help="not ported yet")
    g.add_argument("--opt-mode", default="moment", choices=["moment", "ladder"],
                   help="hyperparameter strategy; only moment is ported")
    g.add_argument("--reference-parity", action="store_true", help="not ported yet")
    for name in ("se", "le"):
        sub.add_parser(name, help="exact oracle (not ported yet)")
    return ap


def main(argv=None):
    ap = _parser()
    opts = ap.parse_args(argv)
    if opts.cmd in ("se", "le"):
        ap.error(f"{opts.cmd}: not ported yet: {NOT_PORTED['oracles']}")
    if opts.checkpoint or opts.checkpoint_every or opts.resume:
        ap.error(f"checkpoints are not ported yet: {NOT_PORTED['checkpoint']}")
    if opts.opt_mode == "ladder" or opts.reference_parity:
        ap.error(f"--opt-mode ladder / --reference-parity are not ported yet: "
                 f"{NOT_PORTED['ladder']}")

    from gple_tpu_torch.config import GPLEConfig
    from gple_tpu_torch.driver import GPLEDriver

    cfg = GPLEConfig.from_input_file(opts.input, model=opts.model)
    drv = GPLEDriver(cfg, outdir=opts.outdir, verbose=not opts.quiet, device=opts.device)
    last = drv.run(max_ticks=opts.max_ticks)[-1]
    lead = math.log(cfg.p0**2 / 2.0 / cfg.mass) if cfg.model == "DAC" else cfg.p0
    print(lead, *last.population_mci)
    return 0


if __name__ == "__main__":
    sys.exit(main())
