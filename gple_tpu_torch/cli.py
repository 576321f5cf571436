"""Command-line interface (counterpart of :mod:`gple_tpu.cli`).

    python -m gple_tpu_torch.cli gple --input input --outdir out [--model DAC]
        [--max-ticks N] [--device cuda|cpu] [--quiet]
        [--opt-mode moment|ladder] [--reference-parity]
        [--checkpoint FILE --checkpoint-every K] [--resume FILE]
    python -m gple_tpu_torch.cli se --input input --outdir out [--model DAC]
        [--boundary reflective|periodic|absorbing] [--no-wigner]
        [--max-outputs N] [--device cuda|cpu]
    python -m gple_tpu_torch.cli le --input input --outdir out [--model DAC]
        [--max-outputs N] [--device cuda|cpu]

All three read the reference's 8-field ``input`` file, run on ``--device``
(the CUDA card unless ``cpu`` is given) and write the reference's output
files into ``--outdir``.

``gple`` runs the GPR-MQCLE trajectory.  ``--opt-mode ladder`` takes the
constrained restart ladder; ``--reference-parity`` runs run-for-run
comparable to the reference (the ladder, the cutoff evolution, the initial
purity target, corr pinned to 1).  ``--checkpoint`` with
``--checkpoint-every K`` writes the state every K ticks; ``--resume``
continues from a checkpoint of either package.

``se`` is the exact DVR Schroedinger oracle (the reference's ``dvr``) and
``le`` the exact grid-MQCLE oracle (its ``mqcl``), on the interaction region
+-2|x0| of the input.  ``--no-wigner`` leaves out the Wigner frames (the
``phase.txt`` of ``se``); ``--max-outputs`` stops an oracle after that many
outputs.

The last stdout line of every subcommand is the reference's: p0 (ln E for
DAC) and the final populations.
"""

from __future__ import annotations

import argparse
import math
import sys


def _common(ap):
    ap.add_argument("--input", default="input", help="reference-format input file")
    ap.add_argument("--outdir", default="output", help="output directory")
    ap.add_argument("--model", default="DAC", choices=["SAC", "DAC", "ECR"],
                    help="Tully model (the reference's compile-time TestModel)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")


def _parser():
    ap = argparse.ArgumentParser(prog="gple_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("gple", help="GPR-MQCLE propagation (reference gple.x)")
    _common(g)
    g.add_argument("--max-ticks", type=int, default=None)
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
    s = sub.add_parser("se", help="exact DVR Schroedinger solver (reference dvr)")
    _common(s)
    s.add_argument("--max-outputs", type=int, default=None)
    s.add_argument("--boundary", default="absorbing",
                   choices=["reflective", "periodic", "absorbing"])
    s.add_argument("--no-wigner", action="store_true")
    l = sub.add_parser("le", help="exact grid-MQCLE solver (reference mqcl)")
    _common(l)
    l.add_argument("--max-outputs", type=int, default=None)
    return ap


def main(argv=None):
    opts = _parser().parse_args(argv)

    from gple_tpu_torch.config import GPLEConfig

    extra = {}
    if getattr(opts, "opt_mode", None):
        extra["opt_mode"] = opts.opt_mode
    if getattr(opts, "reference_parity", False):
        extra["reference_parity"] = True
    cfg = GPLEConfig.from_input_file(opts.input, model=opts.model, **extra)
    lead = math.log(cfg.p0**2 / 2.0 / cfg.mass) if opts.model == "DAC" else cfg.p0

    if opts.cmd == "gple":
        from gple_tpu_torch.driver import GPLEDriver

        drv = GPLEDriver(cfg, outdir=opts.outdir, verbose=not opts.quiet, device=opts.device)
        last = drv.run(max_ticks=opts.max_ticks, checkpoint_path=opts.checkpoint,
                       checkpoint_every=opts.checkpoint_every, resume_from=opts.resume)[-1]
        print(lead, *last.population_mci)
        return 0

    # the oracles: the interaction region +-2|x0| (the GPLE grid convention)
    physics = dict(model=opts.model, mass=cfg.mass, x0=cfg.x0, p0=cfg.p0,
                   sigma_p=cfg.sigma_p0, xmin=cfg.xmin, xmax=cfg.xmax, dx_input=1.0,
                   output_time=cfg.output_time, dt_input=cfg.dt)
    if opts.cmd == "se":
        from gple_tpu_torch.oracles.schrodinger import DVRConfig, DVRSolver

        res = DVRSolver(DVRConfig(boundary=opts.boundary, **physics), opts.device).run(
            store_wigner=not opts.no_wigner, max_outputs=opts.max_outputs)
    else:
        from gple_tpu_torch.oracles.liouville import LiouvilleConfig, LiouvilleSolver

        res = LiouvilleSolver(LiouvilleConfig(**physics), opts.device).run(
            max_outputs=opts.max_outputs)
    res.save_txt(opts.outdir)
    print(lead, *res.populations[-1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
