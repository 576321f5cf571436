"""The flagship fit+evolve step (counterpart of :mod:`gple_tpu.parallel.sharding`).

Ported so far: :func:`make_step_fn` on one device.  The mesh plumbing
(point sharding over several GPUs with ``torch.distributed``) comes later.
"""

from __future__ import annotations

import torch

from gple_tpu_torch.driver import gp_dist_all
from gple_tpu_torch.dynamics.evolve import evolve_step
from gple_tpu_torch.storage import Density, GPStates, fit_gp_states


def make_step_fn(model: str, mass: float, dt: float, block_diag: bool = True):
    """The fit+evolve step: evolve all points one tick with the current GP
    surrogate (cutoff distribution), then refactorize the GPs from the moved
    points.  ``block_diag=True`` is the production structure (corr = 0).
    Returns a plain function ``step(density, gps) -> (density, gps)`` that
    runs under ``torch.inference_mode``."""

    @torch.inference_mode()
    def step(density: Density, gps: GPStates):
        new_density = evolve_step(model, mass, dt, density, gp_dist_all, gps)
        new_gps = fit_gp_states(gps.diag.params, gps.offdiag.params, new_density,
                                prev=gps, block_diag=block_diag)
        return new_density, new_gps

    return step
