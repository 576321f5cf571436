"""Text output writers matching the reference's file schema.

Counterpart of :mod:`gple_tpu.io.writers`: the same seven files with the
same layout (``gaussian_process_liouville_equation/output.cpp``):

* ``ave.txt``   -- per-surface and total population / <r> / energy by both the
  analytic GP integrals and the Monte-Carlo point sums, then elementwise and
  total purity both ways (output.cpp:41-118)
* ``param.txt`` -- lower bound / parameters / upper bound triples per element
  (output.cpp:120-133)
* ``coord.txt`` / ``value.txt`` -- all sampled + extra points (output.cpp:135-179)
* ``phase.txt`` / ``var.txt``   -- gridded GP prediction and variance per
  element (output.cpp:181-233)
* ``run.log``   -- time, wall time, MC parameters, optimization diagnostics
  (output.cpp:235-302)

Numbers are written with Python's ``repr`` (shortest round-trip form), the
JAX package's numpy fallback; its optional C++ formatter is not used, so the
files agree with the JAX package's numerically, not byte for byte.  Inputs are
host numpy arrays.
"""

from __future__ import annotations

import os
import time

import numpy as np


def _fmt_row(values) -> str:
    return " ".join(repr(float(v)) for v in np.asarray(values, dtype=np.float64).ravel())


class OutputWriters:
    """Owns the seven output streams of one run."""

    def __init__(self, outdir: str):
        os.makedirs(outdir, exist_ok=True)
        self.outdir = outdir
        self._files = {
            name: open(os.path.join(outdir, fname), "w")
            for name, fname in dict(
                average="ave.txt", param="param.txt", point="coord.txt",
                value="value.txt", phase="phase.txt", variance="var.txt",
                logging="run.log",
            ).items()
        }
        self._t_wall = time.time()

    def close(self):
        for f in self._files.values():
            f.close()

    # -- ave.txt ---------------------------------------------------------------
    def write_average(self, surface_rows, totals, purity_prm, purity_mci):
        """surface_rows: per surface (ppl_prm, r_prm(2), ppl_mci, r_mci(2),
        e_mci); totals: (ppl_prm, r_prm(2), e_prm, ppl_mci, r_mci(2), e_mci);
        purity_*: 2x2 matrices + their totals appended."""
        row = []
        for s in surface_rows:
            ppl_prm, r_prm, ppl_mci, r_mci, e_mci = s
            row += [ppl_prm, *r_prm, float("nan"), ppl_mci, *r_mci, e_mci]
        row += list(totals)
        row += list(np.asarray(purity_prm).ravel()) + [np.asarray(purity_prm).sum()]
        row += list(np.asarray(purity_mci).ravel()) + [np.asarray(purity_mci).sum()]
        self._files["average"].write(" " + _fmt_row(row) + "\n")
        self._files["average"].flush()

    # -- param.txt ---------------------------------------------------------------
    def write_param(self, triples):
        """triples: per element (lb, params, ub) 1-D arrays."""
        f = self._files["param"]
        for lb, params, ub in triples:
            f.write(_fmt_row(lb) + "\n")
            f.write(_fmt_row(params) + "\n")
            f.write(_fmt_row(ub) + "\n")
        f.write("\n")
        f.flush()

    # -- coord.txt / value.txt ------------------------------------------------------
    def write_points(self, density_points, density_rho, extra_points, extra_rho):
        """Each element contributes one line of coordinates (x..., p...) and one
        line of interleaved re/im values, density then extra (output.cpp:135-179)."""
        fc, fv = self._files["point"], self._files["value"]
        for k in range(density_points.shape[0]):
            pts = np.concatenate([density_points[k], extra_points[k]], axis=0)
            rho = np.concatenate([density_rho[k], extra_rho[k]], axis=0)
            fc.write(_fmt_row(pts.T.ravel()) + "\n")
            fv.write(_fmt_row(_interleave(rho)) + "\n")
        fc.write("\n")
        fv.write("\n")
        fc.flush()
        fv.flush()

    # -- phase.txt / var.txt -------------------------------------------------------
    def write_phase(self, predictions, variances):
        """predictions: (n_elem, n_grid) complex; variances: (n_elem, n_grid)."""
        fp, fv = self._files["phase"], self._files["variance"]
        for k in range(predictions.shape[0]):
            fp.write(_fmt_row(_interleave(predictions[k])) + "\n")
            fv.write(_fmt_row(variances[k]) + "\n")
        fp.write("\n")
        fv.write("\n")
        fp.flush()
        fv.flush()

    # -- run.log --------------------------------------------------------------------
    def write_log(self, t, error, mc_steps, displacements, opt_type,
                  rescales, opt_steps=0):
        """Reference field order (output.cpp:235-302): time, wall time since
        the previous output, MC steps per element, max displacement per
        element, per-element label rescale factor (NaN for absent elements),
        optimization error, number of optimization steps, optimization kind,
        wall-clock timestamp."""
        now = time.time()
        self._files["logging"].write(
            f"{t} {now - self._t_wall:.3f} "
            + " ".join(str(s) for s in mc_steps)
            + " "
            + " ".join(str(d) for d in displacements)
            + " " + " ".join(repr(float(r)) for r in rescales)
            + f" {error} {opt_steps} {opt_type} "
            + time.strftime("%F %T %Z", time.localtime(now))
            + "\n"
        )
        self._files["logging"].flush()
        self._t_wall = now


def _interleave(values) -> np.ndarray:
    """Complex values as re, im, re, im, ..."""
    values = np.asarray(values)
    out = np.empty(2 * values.shape[0])
    out[0::2] = values.real
    out[1::2] = values.imag
    return out
