"""The per-tick body of the GPR-MQCLE driver (counterpart of :mod:`gple_tpu.driver`).

Ported so far: the two distribution functions and :func:`_tick_core`, the
tick body every trajectory path of the JAX driver shares, with the default
settings ``track_moments="none"`` and ``coh_fit_extra=0``.  The rest of
``GPLEDriver`` (initialisation, moment optimizer, reoptimisation, relabel,
I/O) is host orchestration around this body and comes in later slices.
"""

from __future__ import annotations

import torch

from gple_tpu_torch.dynamics import evolve as EV
from gple_tpu_torch.storage import Density, GPStates, fit_gp_states, predict_all


def gp_dist_all(gps: GPStates, pts3):
    """(3, M, PhaseDim) -> (3, M, 2) cutoff GP predictions (with variance)."""
    return predict_all(gps, pts3, with_variance=True)


def gp_dist_all_nocut(gps: GPStates, pts3):
    """Raw-mean GP predictions, no cutoff: the default evolution distribution
    (the fused mean kernels, no variance)."""
    return predict_all(gps, pts3, with_variance=False)


@torch.inference_mode()
def _tick_core(model: str, mass: float, dt: float, density: Density,
               extra: Density, gps: GPStates, diag_params, off_params,
               evolve_dist, track_moments: str, coh_fit_extra: int,
               coh_len_div: float, block_diag: bool):
    """THE tick body: evolve density + extra points with ``evolve_dist``, run
    the is-very-small activation test with the cutoff distribution, and refit
    the GP states from the moved points.  Returns
    ``(density, extra, small (3,) bool, gps)``.

    Only ``track_moments="none"`` and ``coh_fit_extra=0`` are ported: with
    them the kernel parameters are held and the extra cloud does not join the
    fit (``coh_len_div`` is then unused)."""
    if track_moments != "none":
        raise NotImplementedError("_tick_core: per-tick moment tracking is not ported")
    if coh_fit_extra != 0:
        raise NotImplementedError("_tick_core: the coherence booster is not ported")
    del coh_len_div
    new_density = EV.evolve_step(model, mass, dt, density, evolve_dist, gps)
    new_extra = EV.evolve_step(model, mass, dt, extra, evolve_dist, gps)
    small = EV.is_very_small(model, mass, dt, new_density, gp_dist_all, gps)
    new_gps = fit_gp_states(diag_params, off_params, new_density, prev=gps,
                            block_diag=block_diag)
    return new_density, new_extra, small, new_gps
