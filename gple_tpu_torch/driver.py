"""The GPR-MQCLE driver: fit -> sample -> evolve -> refit (counterpart of
:mod:`gple_tpu.driver`).

The reference main loop (``gaussian_process_liouville_equation/main.cpp:19-212``):

1. seed N points per populated element at r0, Metropolis-select them from the
   initial Gaussian distribution (main.cpp:44-57)
2. record the conserved targets: total energy, purity = 1 (main.cpp:59-66)
3. jitter 5N extra points per element for fitting (main.cpp:69)
4. set the hyperparameters (main.cpp:71-73)
5. per tick: evolve density AND extra points with the branching evolver, check
   element appearance, re-optimize on schedule / on element change / on
   conservation drift, otherwise just refit the GP states from the moved
   points (main.cpp:135-202)
6. stop once <x> passes -x0 (main.cpp:195-200)

Every ``GPLEConfig`` setting is ported: the production
path -- the moment optimizer, the block-diagonal (corr = 0) complex fit, the
raw-mean evolution distribution, cloud tracking, Metropolis re-tuning and
the walk surrogate, element activation, the output files --; the
reference's own settings -- the constrained ladder (``opt_mode="ladder"``,
its inner solver optax's zoom line search), whose learnt correlation needs
the full (2N, 2N) coherence fit, the cutoff evolution distribution and
``reference_parity``; and the default-off flags: per-tick moment tracking
(``moment_per_tick``), the coherence booster (``coh_fit_extra`` carried
extra points join the coherence fit, with ``coh_len_div`` and the fit-health
backoff and eject), the coherence-only cutoff (``evolve_cutoff="coh"``), the
purity and population conservation rescales (``coh_boost_rescale``,
``pop_rescale``) and the relabel rules (``relabel_conserve``,
``relabel_mask_coh``, ``coh_reselect``); and ``init_cache``, which saves
the post-initialization state keyed by every other field and restores it on
a repeat run (:meth:`GPLEDriver._init_cache_path`).  Where the JAX package's
booster diverges, so does this one: the decisions are the same.
``GPLEDriver(profile_dir=...)`` traces a run with ``torch.profiler``, as the
JAX package's traces it with ``jax.profiler``, with the program's spans in
the trace.

The tick paths are the JAX package's one-dispatch programs, run on the
card as replays of captured CUDA graphs (:mod:`gple_tpu_torch.ops.graphs`)
and on the CPU as the same Python functions, eagerly: one definition of the
tick (:func:`_tick_program` around :func:`_tick_core`) and one of a
reoptimization period's end (:func:`_period_program`, with the device-side
moment reopt :func:`_moment_reopt_core`).  :meth:`GPLEDriver.step` is one
replay of the tick graph (``_tick_fused``), :meth:`GPLEDriver._advance_chunk`
a chunk of replays with one host pull (``_ticks_scan``), and
:meth:`GPLEDriver._advance_fused` a whole segment of periods, the scheduled
moment reopts included, with one host pull, rolled back bit for bit on an
event (``_ticks_scan_fused`` and ``_advance_fused``).  ``run``
(:meth:`GPLEDriver._advance`) takes fused segments where the JAX package
does -- the moment optimizer, ``fused_chunk > 0``, no writers, no
checkpoints, no ``coh_boost_rescale`` -- with its abort hysteresis and, with
``init_cache``, its event hints (:meth:`GPLEDriver._event_hints_path`);
elsewhere the boundary-chunked loop: a chunk ends at every scheduled reopt,
output and checkpoint (``run``'s ``checkpoint_path`` / ``checkpoint_every``
/ ``resume_from``, the JAX package's ``.npz`` schema,
:mod:`gple_tpu_torch.io.checkpoint`).  The draws a graph needs (the extra
clouds' jitter at a scheduled reopt) are made before its replay from keys
split in the host loop's order, so both paths consume one random stream.

Spans (:mod:`gple_tpu_torch.utils.spans`).  A run is the root span ``run``;
under it ``init`` (``mc_select``, ``extra``, ``optimize`` and ``refit`` of
:meth:`GPLEDriver.initialize`, or a checkpoint's ``restore``), ``fused``
(attributes ``tick``, ``n``, ``ok``) and ``chunk``, ``step`` (``evolve``,
``seed``, ``reopt``), ``reopt`` (``reselect``, ``tune``, ``fit``) and
``output`` (``observe``, ``write``); every host read of device values, every
synchronize and every copy of host data to the card is a ``wait`` span.  A
fused segment on the card times its tick replays and its period-end replays
with CUDA events, read after the segment's one pull, into the totals
``dev.fused_tick`` and ``dev.fused_period_end``.  The counter
``small.pairs`` is the activation test's (source, target) predictions with
variance, added by the host for every tick replay
(:meth:`GPLEDriver._replay`).
The run's spans and counters add to ``GPLEDriver.totals``; ``phase_times``
is a view of the spans (:data:`PHASE_SPANS`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
import os
import time
from functools import partial, wraps
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from gple_tpu_torch import observables as OBS
from gple_tpu_torch.config import GPLEConfig
from gple_tpu_torch.dynamics import evolve as EV
from gple_tpu_torch.gp.opt import (
    AVERAGE_TOLERANCE,
    CORR_BOUND,
    INITIAL_NOISE,
    Optimizer,
    _fit_once_diagnostics,
    _wstd,
    fit_data,
    moment_kernel_params,
    off_moments,
    pack_off,
    unpack_off,
)
from gple_tpu_torch.io import checkpoint as ckpt
from gple_tpu_torch.io.writers import OutputWriters
from gple_tpu_torch.ops import complex_kernels as CK
from gple_tpu_torch.ops import graphs as GR
from gple_tpu_torch.ops import kernels as RK
from gple_tpu_torch.sampler import mc
from gple_tpu_torch.sampler.keys import RandomKeys
from gple_tpu_torch.storage import (
    DIAG_INDICES,
    ELEMENTS,
    NUM_ELEMENTS,
    OFFDIAG_INDEX,
    Density,
    GPStates,
    diag_rows,
    fit_gp_states,
    predict_all,
    predict_element,
)
from gple_tpu_torch.utils import ri, spans
from gple_tpu_torch.utils.constants import purity_factor


# -- distribution functions ---------------------------------------------------------

def gp_dist_all(gps: GPStates, pts3, targets=None):
    """(3, M, PhaseDim) -> (3, M, 2) cutoff GP predictions (with variance) of
    the elements ``targets`` (:func:`predict_all`; None for all)."""
    return predict_all(gps, pts3, with_variance=True, targets=targets)


def gp_dist_all_nocut(gps: GPStates, pts3):
    """Raw-mean GP predictions, no cutoff: the default evolution distribution
    (the fused mean kernels, no variance)."""
    return predict_all(gps, pts3, with_variance=False)


def gp_dist_coh_cut(gps: GPStates, pts3):
    """Raw-mean diagonals + variance-cutoff coherence (``evolve_cutoff="coh"``):
    the cutoff suppresses the low-signal / high-variance region where a
    near-interpolating coherence fit extrapolates noise that the diagonals
    would read at their branch points."""
    return predict_all(gps, pts3, with_variance=False, off_with_variance=True)


def _evolve_dist_for(mode):
    """The evolution distribution for a ``GPLEConfig.evolve_cutoff`` setting:
    False = raw means, True = the cutoff predictions (the reference), "coh" =
    the cutoff on the coherence only."""
    if mode == "coh":
        return gp_dist_coh_cut
    return gp_dist_all if mode else gp_dist_all_nocut


def _gp_dist_elem(gps: GPStates, pts, *, elem: int, cutoff: bool = True):
    return predict_element(gps, elem, pts, with_variance=cutoff)


GP_DIST_ELEMS = tuple(partial(_gp_dist_elem, elem=k) for k in range(NUM_ELEMENTS))
GP_DIST_ELEMS_NOCUT = tuple(
    partial(_gp_dist_elem, elem=k, cutoff=False) for k in range(NUM_ELEMENTS))


def _new_point_dist(params, pts, *, model: str, mass: float, dt: float, elem: int,
                    evolve_dist):
    """The density of element ``elem`` predicted at points with no value
    (:func:`EV.predict_new_points` with the evolution distribution)."""
    return EV.predict_new_points(model, mass, dt, pts, elem, evolve_dist, params)


def _init_dist_elem(params, pts, *, elem: int):
    r0, sigma, pops, phases = params
    row, col = ELEMENTS[elem]
    return mc.initial_distribution(r0, sigma, pts, row, col, pops, phases)


INIT_DIST_ELEMS = tuple(partial(_init_dist_elem, elem=k) for k in range(NUM_ELEMENTS))


def init_dist_all(params, pts3):
    return torch.stack([INIT_DIST_ELEMS[k](params, pts3[k]) for k in range(NUM_ELEMENTS)])


def _off_extra_slice(extra: Density, k: int):
    """The first ``k`` off-diagonal extra points as (points, rho) for the
    coherence fit, or None when the booster is off."""
    if k <= 0:
        return None
    return extra.points[OFFDIAG_INDEX, :k], extra.rho[OFFDIAG_INDEX, :k]


# -- the tick and the reoptimization's device work -------------------------------------

@torch.inference_mode()
def _tick_core(model: str, mass: float, dt: float, density: Density,
               extra: Density, gps: GPStates, diag_params, off_params,
               evolve_dist, track_moments: str, coh_fit_extra: int,
               coh_len_div: float, block_diag: bool, active=None):
    """THE tick body: evolve density + extra points with ``evolve_dist``, run
    the is-very-small activation test with the cutoff distribution (on the
    pairs whose result the host tuple ``active`` reads, all nine with None:
    :func:`EV.is_very_small`), optionally track the moment parameters of the
    moved cloud (``track_moments`` "all" or "off", coherence lengths over
    ``coh_len_div``), and refit the GP states from the moved points, the
    coherence with the first ``coh_fit_extra`` extra points (the booster).
    Returns ``(density, extra, small (3,) bool, gps)``."""
    new_density = EV.evolve_step(model, mass, dt, density, evolve_dist, gps)
    new_extra = EV.evolve_step(model, mass, dt, extra, evolve_dist, gps)
    small = EV.is_very_small(model, mass, dt, new_density, gp_dist_all, gps,
                             active=active)
    off_extra = _off_extra_slice(new_extra, coh_fit_extra)
    if track_moments != "none":
        diag_params, off_params = moment_kernel_params(
            new_density, diag_params, off_params, off_extra=off_extra,
            off_len_div=coh_len_div, track_diag=track_moments == "all")
    new_gps = fit_gp_states(diag_params, off_params, new_density, prev=gps,
                            off_extra=off_extra, block_diag=block_diag)
    return new_density, new_extra, small, new_gps


def _fit_states_obs(coh_k: int, diag_params, off_params, density: Density,
                    extra: Density, block_diag: bool):
    """``fit_gp_states`` (the booster's ``coh_k`` extra points joining the
    coherence) plus its integral observables."""
    gps = fit_gp_states(diag_params, off_params, density,
                        off_extra=_off_extra_slice(extra, coh_k), block_diag=block_diag)
    return gps, gps.population(), gps.purity()


def _extra_noise(keys, n_extra: int, dim: int):
    """The standard normal draws (n_extra, dim) of :func:`mc.jitter_points`
    for each element's key, None where the key is None."""
    return [k.normal((n_extra, dim)) if k is not None else None for k in keys]


def _regen_extra_core(use_cutoff, coh_k: int, n_extra: int, density: Density,
                      prev_extra: Density, gps: GPStates, noise) -> Density:
    """Regenerate the extra clouds from a fresh fit (reference mc.cpp:59-120
    via main.cpp:165-172): each active element's points jittered with its
    draws ``noise[k]`` (:func:`_extra_noise`; None for an inactive element,
    whose cloud is its first point repeated with zero labels), and all three
    clouds labeled by one :func:`predict_all` with the cutoff of the
    ``GPLEConfig.evolve_cutoff`` mode ``use_cutoff`` -- one prediction for
    both diagonal elements and one for the coherence.  The booster's ``coh_k``
    coherence slots keep their carried points and evolved labels while the
    coherence was and is active.  The draws are inputs, made beforehand, so
    a CUDA graph can run this (:func:`_period_program`)."""
    pts = torch.stack([
        mc.jitter_with(noise[k], density.points[k]) if noise[k] is not None
        else density.points[k][:1].expand(n_extra, density.points.shape[-1])
        for k in range(NUM_ELEMENTS)])
    rho = predict_all(gps, pts, with_variance=use_cutoff is True,
                      off_with_variance=bool(use_cutoff))
    if coh_k > 0:
        carry = density.active[OFFDIAG_INDEX] & prev_extra.active[OFFDIAG_INDEX]
        pts[OFFDIAG_INDEX, :coh_k] = torch.where(
            carry, prev_extra.points[OFFDIAG_INDEX, :coh_k], pts[OFFDIAG_INDEX, :coh_k])
        rho[OFFDIAG_INDEX, :coh_k] = torch.where(
            carry, prev_extra.rho[OFFDIAG_INDEX, :coh_k], rho[OFFDIAG_INDEX, :coh_k])
    return Density(points=pts, rho=rho, active=density.active)


@torch.inference_mode()
def _reopt_epilogue(use_cutoff, coh_k: int, n_extra: int, density: Density,
                    prev_extra: Density, diag_params, off_params, keys,
                    block_diag: bool = False):
    """Everything after a reoptimization's parameter choice: refit the GP
    states from the (possibly re-selected) cloud and the booster slots of
    ``prev_extra``, regenerate the extra clouds labeled by the fresh fit (one
    key per element, None for an inactive one), and the fit-reference
    integrals for the drift check.  Returns ``(gps, extra, population,
    purity)``."""
    gps, pop, pur = _fit_states_obs(coh_k, diag_params, off_params, density, prev_extra,
                                    block_diag)
    noise = _extra_noise(keys, n_extra, density.points.shape[-1])
    extra = _regen_extra_core(use_cutoff, coh_k, n_extra, density, prev_extra, gps, noise)
    return gps, extra, pop, pur


def _moment_reopt_core(coh_k: int, off_len_div: float, density: Density, extra: Density,
                       diag_params, off_params, block_diag: bool = False):
    """The moment reoptimization on the device (``gple_tpu/driver.py:333-387``),
    the counterpart of the host's ``Optimizer._moment_impl`` + ``_finish`` +
    ``fitted_params``: the moment lengths of the current clouds (the booster's
    ``coh_k`` extra points joining the coherence's, its lengths over
    ``off_len_div``), one diagnostics fit for the analytic magnitudes, and the
    assembled parameters; an inactive element keeps its parameters.  A pure
    function of tensors, so the period-end graph can reoptimize on schedule
    without a host round trip.  Returns ``(diag KernelParams,
    ComplexKernelParams, error)``."""
    f64 = dict(dtype=density.points.dtype, device=density.points.device)
    dmask = diag_rows(density.active)
    dlens = torch.stack([_wstd(density.points[k], density.rho[k, :, 0])
                         for k in DIAG_INDICES]) / 2.0
    dlens = torch.where(dmask[:, None], dlens, diag_params.lengths)
    o_pts, o_rho = density.points[OFFDIAG_INDEX], density.rho[OFFDIAG_INDEX]
    oe = _off_extra_slice(extra, coh_k)
    if oe is not None:
        o_pts, o_rho = torch.cat([o_pts, oe[0]]), torch.cat([o_rho, oe[1]])
    mr, lr, mi, li = off_moments(o_pts, o_rho, off_len_div)
    new_flat = pack_off(mr, lr, mi, li, torch.zeros_like(mr))
    prev_flat = pack_off(off_params.real_magnitude, off_params.real_lengths,
                         off_params.imag_magnitude, off_params.imag_lengths, off_params.corr)
    act_o = density.active[OFFDIAG_INDEX]
    off_flat = torch.where(act_o, new_flat, prev_flat)
    err, mags, off_mag = _fit_once_diagnostics(dlens, off_flat, fit_data(density, extra),
                                               block_diag)
    diag_new = RK.KernelParams(magnitude=torch.where(dmask, mags, 1.0), lengths=dlens,
                               noise=torch.full((2,), INITIAL_NOISE, **f64))
    off_new = unpack_off(off_flat, torch.where(act_o, off_mag, 1.0),
                         torch.full((), INITIAL_NOISE, **f64))
    return diag_new, off_new, err


# -- the graphed tick and period end ---------------------------------------------------

#: the observables of one output (:func:`OBS.observe_all`) as a flat row: name, size
_OBS_FIELDS = (("energies", 2), ("ppl_mci", 2), ("ppl_prm_each", 2), ("pop_prm", 1),
               ("energy_prm", 1), ("energy_mci", 1), ("purity_prm", 1),
               ("purity_mci_raw", 1), ("x_average", 1))
_OBS_WIDTH = sum(size for _, size in _OBS_FIELDS)
#: a tick's row: small (3), drift, target purity, population, purity and MC
#: purity integrals, then the observables
_SMALL, _DRIFT, _TARGET, _POP, _PUR, _MC_PUR, _OBS = 0, 3, 4, 5, 6, 7, 8
_TICK_WIDTH = _OBS + _OBS_WIDTH
#: a period end's row: re-selection flag, reopt error, population rescale,
#: then the observables after the reopt
_RESEL, _ERR, _POP_S, _OBS_LAST = 0, 1, 2, 3
_PERIOD_WIDTH = _OBS_LAST + _OBS_WIDTH


def _pack_obs(obs: dict):
    return torch.cat([obs[name].reshape(-1).to(torch.float64) for name, _ in _OBS_FIELDS])


def _unpack_obs(row) -> dict:
    """:func:`_pack_obs`'s row (host) back to the dict of :meth:`GPLEDriver.observe`."""
    out, at = {}, 0
    for name, size in _OBS_FIELDS:
        out[name] = row[at: at + size] if size > 1 else row[at]
        at += size
    return out


class _Static(NamedTuple):
    """The static tensors the tick and period-end graphs read and write."""

    density: Density
    extra: Density
    gps: GPStates
    diag_params: RK.KernelParams
    off_params: CK.ComplexKernelParams
    #: (6,) drift reference population, purity and target purity; MC purity
    #: scale; fixed target purity; conserved population numerator
    scalars: torch.Tensor
    check: torch.Tensor      # (reopt_freq,) bool: the tick evaluates the drift trigger
    counter: torch.Tensor    # () int64: ticks since the counter was reset
    rows: torch.Tensor       # (reopt_freq, _TICK_WIDTH) the ticks' rows
    draws: torch.Tensor      # (3, n_extra, D) the period's jitter draws
    period: torch.Tensor     # (_PERIOD_WIDTH,) the period end's row


def _tick_program(S: _Static, model: str, mass: float, dt: float, evolve_dist,
                  track_moments: str, coh_k: int, coh_len_div: float, block_diag: bool,
                  measured_target: bool, active=None) -> None:
    """One tick on ``S`` in place, the body of the tick graph: :func:`_tick_core`
    (the one definition of the tick), the new fit's population and purity
    integrals, the MC purity, the target purity, the conservation-drift
    trigger where ``S.check[S.counter]`` asks for it (the form of
    :meth:`GPLEDriver._drift_detected`), and the observables, as row
    ``S.counter`` of ``S.rows``; then the counter moves on.  The counterpart
    of ``_tick_fused`` and of the tick of ``_ticks_scan_fused``
    (``gple_tpu/driver.py:167-187``, ``:463-482``).  ``active`` is the host's
    tuple of ``S.density.active`` (static: the graph's key); None tests all
    nine pairs."""
    density, extra, small, gps = _tick_core(
        model, mass, dt, S.density, S.extra, S.gps, S.diag_params, S.off_params,
        evolve_dist, track_moments, coh_k, coh_len_div, block_diag, active)
    obs = OBS.observe_all(model, density, gps, mass)
    pop, pur, mc_pur = obs["pop_prm"], obs["purity_prm"], obs["purity_mci_raw"]
    fpop, fpur, ftgt, pur_scale, fixed_target, _ = S.scalars
    target = mc_pur * pur_scale if measured_target else fixed_target
    tol = 2.0 * AVERAGE_TOLERANCE
    ratio = pop / fpop
    pop_ok = (ratio > 1.0 - tol) & (ratio < 1.0 + tol)
    pur_cap = (1.0 + tol) * target * (fpur / ftgt)
    index = S.counter.reshape(1)
    check = torch.index_select(S.check, 0, index)[0]
    drift = check & ((pur > pur_cap) | ~pop_ok)
    row = torch.cat([small.to(torch.float64),
                     torch.stack([drift.to(torch.float64), target, pop, pur, mc_pur]),
                     _pack_obs(obs)])
    S.rows.index_copy_(0, index, row[None])
    S.counter.add_(1)
    GR.copy_((S.density, S.extra, S.gps), (density, extra, gps))


def _period_program(S: _Static, model: str, mass: float, use_cutoff, coh_k: int,
                    coh_len_div: float, n_extra: int, measured_target: bool,
                    pop_rescale: bool, block_diag: bool, active: tuple) -> None:
    """The end of a reoptimization period on ``S`` in place, after its
    ``len(S.check)`` ticks, the body of the period-end graph (the period of
    ``_ticks_scan_fused``, ``gple_tpu/driver.py:484-504``): the cloud drift
    flags, the population rescale of the diagonal labels
    (``GPLEConfig.pop_rescale``), :func:`_moment_reopt_core`, the refit, the
    extra clouds regenerated with the draws ``S.draws`` of the elements
    ``active`` (static: a host tuple), the observables after the reopt, and
    the new drift reference, into ``S.period`` and the state."""
    density, extra = S.density, S.extra
    f64 = dict(dtype=torch.float64, device=density.points.device)
    resel = torch.any(_cloud_drift_flags(density))
    _, _, _, pur_scale, _, pop_sum0 = S.scalars
    target = S.rows[-1, _TARGET]
    pop_s = torch.ones((), **f64)
    if pop_rescale:
        tot = torch.sum(diag_rows(density.rho)[..., 0])
        s = pop_sum0 / torch.where(tot == 0.0, 1.0, tot)
        pop_s = torch.where((tot > 0.0) & (s >= 0.5) & (s <= 2.0), s, 1.0)
        factor = torch.stack([pop_s, torch.ones((), **f64), pop_s])
        density = density._replace(rho=torch.stack(
            [density.rho[..., 0] * factor[:, None], density.rho[..., 1]], dim=-1))
        if measured_target:
            target = torch.sum(OBS.purity_each_element(density)) * pur_scale
    diag_params, off_params, err = _moment_reopt_core(
        coh_k, coh_len_div, density, extra, S.diag_params, S.off_params, block_diag)
    gps = fit_gp_states(diag_params, off_params, density,
                        off_extra=_off_extra_slice(extra, coh_k), block_diag=block_diag)
    noise = [S.draws[k] if active[k] else None for k in range(NUM_ELEMENTS)]
    new_extra = _regen_extra_core(use_cutoff, coh_k, n_extra, density, extra, gps, noise)
    obs = OBS.observe_all(model, density, gps, mass)
    S.period.copy_(torch.cat([torch.stack([resel.to(torch.float64), err, pop_s]),
                              _pack_obs(obs)]))
    fit_ref = torch.stack([obs["pop_prm"], obs["purity_prm"], torch.clamp(target, min=1e-30)])
    GR.copy_((S.density, S.extra, S.gps, S.diag_params, S.off_params),
             (density, new_extra, gps, diag_params, off_params))
    S.scalars[:3].copy_(fit_ref)


#: walk-surrogate grid resolution per phase-space axis; 256 resolves the
#: coherence fringes (grid spacing ~0.05-0.1 in p over a doubled cloud box, an
#: order below the SAC fringe wavelength at p0 = 20)
_SURR_RES = 256


def _linspace(lo, hi, num: int):
    """``jnp.linspace`` of two 0-d tensors, formula for formula (the grid the
    JAX package walks on), without a host pull of the endpoints."""
    step = torch.arange(num - 1, dtype=lo.dtype, device=lo.device) / (num - 1)
    return torch.cat([lo * (1 - step) + hi * step, hi[None]])


@torch.inference_mode()
def _surrogate_grid(model: str, mass: float, dt: float, elem: int, gps, lo, hi,
                    dist=gp_dist_all_nocut):
    """|backward-branching prediction| of one element on a regular grid, in
    ONE batched predictor call of the evolution distribution ``dist`` (the
    Metropolis chains then interpolate it, see mc.element_monte_carlo
    ``walk``)."""
    xs = _linspace(lo[0], hi[0], _SURR_RES)
    ps = _linspace(lo[1], hi[1], _SURR_RES)
    gx, gp = torch.meshgrid(xs, ps, indexing="ij")
    pts = torch.stack([gx.reshape(-1), gp.reshape(-1)], dim=-1)
    vals = EV.predict_new_points(model, mass, dt, pts, elem, dist, gps)
    return ri.absval(vals).reshape(_SURR_RES, _SURR_RES)


def _surrogate_dist(params, pts):
    """Bilinear interpolation of a `_surrogate_grid`, zero outside the box.
    RI-shaped (imaginary part 0) so the Metropolis kernel's |.| contract
    holds; labels are NEVER taken from this (mc.element_monte_carlo)."""
    grid, lo, hi = params
    res = grid.shape[0]
    u = (pts - lo) / (hi - lo) * (res - 1)
    i = torch.clamp(torch.floor(u), 0, res - 2).long()
    f = u - i
    i0, i1 = i[:, 0], i[:, 1]
    f0, f1 = f[:, 0], f[:, 1]
    w = (grid[i0, i1] * (1 - f0) * (1 - f1)
         + grid[i0 + 1, i1] * f0 * (1 - f1)
         + grid[i0, i1 + 1] * (1 - f0) * f1
         + grid[i0 + 1, i1 + 1] * f0 * f1)
    inside = torch.all((pts >= lo) & (pts <= hi), dim=-1)
    w = torch.where(inside, w, 0.0)
    return torch.stack([w, torch.zeros_like(w)], dim=-1)


def _cloud_drift_flags(density: Density):
    """Per-element drift criterion of :meth:`GPLEDriver._track_clouds`: the
    |rho|-weighted label mean off the cloud mean by > half a cloud sigma in
    any phase-space dim.  (3,) bool on the device."""
    w = torch.sqrt(ri.abs2(density.rho))                         # (3, N)
    wsum = torch.sum(w, dim=1)                                   # (3,)
    com = torch.einsum("knd,kn->kd", density.points, w) / torch.clamp(
        wsum[:, None], min=1e-300)
    mean = torch.mean(density.points, dim=1)
    std = torch.clamp(torch.std(density.points, dim=1, correction=0), min=1e-10)
    drift = torch.amax(torch.abs(com - mean) / std, dim=1)
    return density.active & (wsum > 0.0) & (drift > 0.5)


@torch.inference_mode()
def _grid_predictions(gps: GPStates, grid_pts):
    """Cutoff prediction (3, G, 2) + variance (3, G) of every element on the
    output grid: one batched variance predict for both diagonal elements, one
    for the coherence."""
    _, var_d, cut_d = RK.predict_real(gps.diag, grid_pts.expand((2,) + grid_pts.shape))
    _, var_o, cut_o = CK.predict_complex(gps.offdiag, grid_pts)
    preds = torch.stack([ri.ri(cut_d[0]), cut_o, ri.ri(cut_d[1])])
    variances = torch.stack([var_d[0], var_o, var_d[1]])
    return (torch.where(gps.active[:, None, None], preds, 0.0),
            torch.where(gps.active[:, None], variances, 0.0))


def _pull(*tensors):
    """Host numpy copies of float tensors, through one device-to-host copy."""
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    with spans.span("wait"):
        flat = flat.cpu().numpy()
    out, at = [], 0
    for t in tensors:
        out.append(flat[at: at + t.numel()].reshape(tuple(t.shape)))
        at += t.numel()
    return out


@dataclasses.dataclass
class TickRecord:
    time: float
    population_prm: float
    #: per-surface populations by the analytic parameter integral, normalized
    population_prm_each: np.ndarray
    population_mci: np.ndarray
    energy_prm: float
    energy_mci: float
    purity_prm: float
    purity_mci: float
    x_average: float
    opt_type: str


def _unported(cfg: GPLEConfig) -> List[str]:
    """The settings of ``cfg`` that the port's driver does not implement."""
    checks = (
        (cfg.opt_mode not in ("moment", "ladder"), f"opt_mode={cfg.opt_mode!r}"),
    )
    return [what for bad, what in checks if bad]


def _collected(method):
    """``method`` of the driver with its spans adding to the driver's
    :attr:`GPLEDriver.totals`, also where it is called outside ``run``."""

    @wraps(method)
    def collected(self, *args, **kwargs):
        with spans.collect(self.totals):
            return method(self, *args, **kwargs)
    return collected


#: ``GPLEDriver.phase_times``: each key the seconds of the spans it names.
#: "evolve" is the ticks' host walls up to their pull (a chunk of replays
#: that ran clean, a step's replay), "seed" an activation's seeding walks,
#: "optimize" the host reoptimizations ("opt_reselect" their cloud
#: re-selection and rescales, "opt_tune" their parameters, "opt_fit" their
#: refit and extra clouds), "fused" the segments that ran clean (ticks and
#: scheduled reopts on the device) and "fused_abort" those rolled back;
#: "capture", "launch" and "wait" (graph captures, graph replays, host
#: waits) lie inside the others; "dev.fused_tick" and "dev.fused_period_end"
#: are the card's seconds of the fused segments' replays (CUDA events)
PHASE_SPANS = {
    "init": ("init",), "seed": ("seed",), "evolve": ("evolve", "chunk"),
    "optimize": ("reopt",), "output": ("output",), "opt_reselect": ("reselect",),
    "opt_tune": ("tune",), "opt_fit": ("fit",), "fused": ("fused",),
    "fused_abort": ("fused_abort",), "capture": ("capture",), "launch": ("launch",),
    "wait": ("wait",), "dev.fused_tick": ("dev.fused_tick",),
    "dev.fused_period_end": ("dev.fused_period_end",),
}


#: the init cache's directory (GPLEConfig.init_cache); the environment
#: variable of this name overrides it
INIT_CACHE_ENV = "GPLE_TORCH_CACHE_DIR"
_DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".gple_torch_cache")


class GPLEDriver:
    """The trajectory driver.  ``device`` defaults to the CUDA card and raises
    where there is none; pass ``device="cpu"`` for the plain-PyTorch path.
    ``rng`` is the root random key (default: ``RandomKeys(cfg.seed, device)``).
    ``profile_dir``: trace every :meth:`run` with ``torch.profiler`` (CPU
    activity, and the card's where the driver runs on one) into a chrome
    trace in that directory (``trace_path`` after the run; the profiler
    itself stays in ``profiler`` for ``key_averages()``), inside
    ``spans.timeline()``: the trace holds the program's spans as ranges,
    and ``spans`` holds the run's timeline after it (as after any run inside
    a timeline)."""

    def __init__(self, cfg: GPLEConfig, outdir: Optional[str] = None, verbose: bool = False,
                 device="cuda", rng=None, profile_dir: Optional[str] = None):
        missing = _unported(cfg)
        if missing:
            raise NotImplementedError("GPLEDriver: not ported yet: " + "; ".join(missing))
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("GPLEDriver: device 'cuda' requested but CUDA is not "
                               "available; pass device='cpu' for the CPU path")
        self.cfg = cfg
        self.verbose = verbose
        self.writers = OutputWriters(outdir) if outdir else None
        self.rng = rng if rng is not None else RandomKeys(cfg.seed, self.device)
        self.mc_params = [mc.MCParameters() for _ in range(NUM_ELEMENTS)]
        self.history: List[TickRecord] = []
        self._grid = None
        if outdir:
            with spans.span("wait"):
                self._grid = torch.tensor(cfg.phase_grids(), dtype=torch.float64,
                                          device=self.device)
        #: what the spans and counters of every run add up to (cumulative)
        self.totals = spans.Totals()
        #: the last run's timeline, when it ran inside one
        self.spans: Optional[spans.Timeline] = None
        #: event counters: activations, re-selections, and (once they fire)
        #: coh_rescales, pop_rescales, coh_len_backoffs, coh_boost_ejected,
        #: relabel_rescales, relabel_rejects, relabel_nascent
        self.stats = {"element_activations": 0, "cloud_reselections": 0}
        #: per-tick moment tracking: "none", "all" or "off" (the coherence
        #: only); moment mode only (GPLEConfig.moment_per_tick)
        if cfg.opt_mode != "moment" or not cfg.moment_per_tick:
            self._track_moments = "none"
        else:
            self._track_moments = "off" if cfg.moment_per_tick == "off" else "all"
        #: live booster size (GPLEConfig.coh_fit_extra, capped at the extra
        #: cloud; 0 after a fit-health eject)
        self._coh_k = min(int(cfg.coh_fit_extra), cfg.num_extra_points)
        #: effective coherence lengthscale divisor, stickily halved by the
        #: fit-health backoff (GPLEConfig.coh_fit_health_factor)
        self._coh_div_eff = float(cfg.coh_len_div)
        #: the evolution distribution (GPLEConfig.evolve_cutoff)
        self._evolve_dist = _evolve_dist_for(cfg.evolve_cutoff)
        #: each element's backward-branching predictor (the labels of seeding
        #: and re-selection); it holds no reference to the driver, whose
        #: walk graphs keep it, so a dropped driver frees its graphs at once
        self._new_pt_dists = tuple(
            partial(_new_point_dist, model=cfg.model, mass=cfg.mass, dt=cfg.dt, elem=k,
                    evolve_dist=self._evolve_dist) for k in range(NUM_ELEMENTS))
        self.profile_dir = profile_dir
        self.profiler = None
        self.trace_path: Optional[str] = None
        #: event ticks of this run (activations, drift reopts, aborted
        #: segments), kept as fusion hints with the init cache
        #: (:meth:`_event_hints_path`)
        self._event_ticks = set()
        #: (static arguments, _Static, tick graph, period-end graph) of the
        #: live static arguments (:meth:`_programs`)
        self._graphs = None
        #: (density.active tensor, its host copy) (:meth:`_host_active`)
        self._active_host = (None, None)
        #: the Metropolis chains' programs, kept for the run: a walk of the
        #: same distribution at the same shapes replays the graphs of the first
        self._chains = mc.Chains()

    @property
    def phase_times(self) -> dict:
        """The runs' phase walls in seconds, a view of :attr:`totals`: every
        key of :data:`PHASE_SPANS`, 0.0 for one that no span fed."""
        return {key: sum(self.totals.seconds(n) for n in names)
                for key, names in PHASE_SPANS.items()}

    def _init_cache_path(self) -> str:
        """Path of the cached initialization state (GPLEConfig.init_cache),
        keyed as the JAX package keys it: by EVERY config field but the cache
        knob itself (any field could change the init walk, the first fit or
        the random stream).  The device type joins the file name, because the
        port's draws from one key differ between the CPU and the card."""
        fields = dataclasses.asdict(self.cfg)
        fields.pop("init_cache", None)
        key = hashlib.sha1(repr(sorted(fields.items())).encode()).hexdigest()[:16]
        d = os.path.join(os.environ.get(INIT_CACHE_ENV, _DEFAULT_CACHE_DIR), "init_states")
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, f"init_{key}_{self.device.type}.npz")

    def _event_hints_path(self) -> str:
        """Beside :meth:`_init_cache_path`: the event ticks (activations, drift
        reopts, re-selections) a previous run of this config met.  A run is
        deterministic given its config, so the fused path replays the chunked
        path through a recorded event instead of paying for a segment it
        would roll back (``gple_tpu/driver.py:649-661``)."""
        d, base = os.path.split(self._init_cache_path())
        return os.path.join(d, base.replace("init_", "events_", 1).replace(".npz", ".json"))

    def _log(self, msg):
        if self.verbose:
            print(msg, flush=True)

    def _split(self):
        self.rng, sub = self.rng.split(2)
        return sub

    def _block_diag(self) -> bool:
        """True when the coherence fit may run block-diagonal (corr = 0): the
        moment optimizer never sets a nonzero Re-Im correlation, so its fits
        split into two (N, N) SPD solves.  Checked against the live
        parameter vector, so a resumed checkpoint with corr != 0 never drops
        its correlation; the ladder always fits the full (2N, 2N) embedding."""
        if self.cfg.opt_mode != "moment":
            return False
        opt = getattr(self, "optimizer", None)
        return opt is None or opt.corr == 0.0

    def _sync(self):
        if self.device.type == "cuda":
            with spans.span("wait"):
                torch.cuda.synchronize(self.device)

    # -- initialization (main.cpp:25-73) ------------------------------------------
    @_collected
    @torch.inference_mode()
    def initialize(self):
        cfg = self.cfg
        pops = cfg.initial_population
        active = np.array([pops[i] > 0 and pops[j] > 0 for (i, j) in ELEMENTS], dtype=bool)

        def f64(v):
            with spans.span("wait"):
                return torch.tensor(np.asarray(v, dtype=np.float64), device=self.device)

        with spans.span("mc_select") as select:
            init_params = (f64(cfg.r0), f64(cfg.sigma_r0), f64(pops),
                           f64(cfg.initial_phase_factor))
            n = cfg.num_points
            pts = f64(cfg.r0)[None, None, :].expand(NUM_ELEMENTS, n, 2)
            rho = init_dist_all(init_params, pts)
            # Metropolis selection of each active element (main.cpp:57)
            new_pts, new_rho = [], []
            for k in range(NUM_ELEMENTS):
                if active[k]:
                    p, r, self.mc_params[k] = mc.element_monte_carlo(
                        self._split(), INIT_DIST_ELEMS[k], init_params, pts[k],
                        self.mc_params[k], tune=True, chains=self._chains)
                else:
                    p, r = pts[k], rho[k]
                new_pts.append(p)
                new_rho.append(r)
            with spans.span("wait"):
                active_t = torch.tensor(active, device=self.device)
            density = Density(points=torch.stack(new_pts), rho=torch.stack(new_rho),
                              active=active_t)
            self._sync()
        with spans.span("extra") as make_extra:
            # conserved targets (main.cpp:59-66)
            energies = OBS.total_energy_each_surface(cfg.model, density, cfg.mass)
            e_host, mc_pur, pop_sum = _pull(
                energies, torch.sum(OBS.purity_each_element(density)),
                torch.sum(diag_rows(density.rho)[..., 0]))
            weights = np.asarray(pops) ** 2
            self.total_energy = float(np.sum(weights * e_host) / weights.sum())
            self.purity = 1.0
            self.purity_ratio = self.purity / (float(mc_pur) * purity_factor(cfg.dim))
            #: conserved total-population numerator (GPLEConfig.pop_rescale)
            self._pop_sum0 = float(pop_sum)
            extra = self._make_extra(density, active, INIT_DIST_ELEMS, init_params)
            self.extra = extra
            self._sync()
        with spans.span("optimize") as optimize:
            self.optimizer = Optimizer(
                model=cfg.model, mass=cfg.mass, total_energy=self.total_energy,
                purity=self.purity, sigma_r0=np.asarray(cfg.sigma_r0),
                lbfgs_steps=cfg.opt_steps_initial, opt_mode=cfg.opt_mode,
                corr_bounds=self._corr_bounds(), off_len_div=cfg.coh_len_div,
                coh_fit_extra=self._coh_k, device=self.device)
            self.opt_result = self.optimizer.optimize(density, extra, energies)
        with spans.span("refit") as refit:
            self.optimizer.lbfgs_steps = cfg.opt_steps_reopt
            self.gps = self._refit(density)
            self._record_fit_ref(self.purity)
            self.density = density
        self._log("init phases: " + ", ".join(
            f"{s.name}={s.seconds:.1f}s" for s in (select, make_extra, optimize, refit)))
        return density

    def _make_extra(self, density: Density, active, dist_elems, dist_params) -> Density:
        """Generate the extra clouds (reference mc.cpp:59-120), one key per
        active element.  With the booster on and an earlier extra cloud whose
        coherence was active, the first ``_coh_k`` coherence points keep their
        carried points and labels."""
        n_extra = self.cfg.num_extra_points
        prev = getattr(self, "extra", None)
        pts, rho = [], []
        for k in range(NUM_ELEMENTS):
            if active[k]:
                p, r = mc.generate_extra_points_element(
                    self._split(), density.points[k], n_extra, dist_elems[k], dist_params)
                if (k == OFFDIAG_INDEX and self._coh_k > 0 and prev is not None
                        and _pull(prev.active[k])[0] > 0):
                    kk = self._coh_k
                    p = torch.cat([prev.points[k, :kk], p[kk:]])
                    r = torch.cat([prev.rho[k, :kk], r[kk:]])
            else:
                p = density.points[k][:1].expand(n_extra, density.points.shape[-1])
                r = torch.zeros((n_extra, 2), dtype=p.dtype, device=p.device)
            pts.append(p)
            rho.append(r)
        return Density(points=torch.stack(pts), rho=torch.stack(rho), active=density.active)

    def _corr_bounds(self) -> tuple:
        """The optimizer's Re-Im correlation box: pinned to 1 (the reference
        kernel) under ``reference_parity``."""
        return (1.0, 1.0) if self.cfg.reference_parity else (-CORR_BOUND, CORR_BOUND)

    def _refit(self, density: Density) -> GPStates:
        diag_params, off_params = self.optimizer.fitted_params()
        gps, pop, pur = _fit_states_obs(self._coh_k, diag_params, off_params, density,
                                        self.extra, self._block_diag())
        # kept for the following _record_fit_ref
        self._fit_obs = (pop, pur)
        return gps

    def _record_fit_ref(self, target_purity: float) -> None:
        """Snapshot the freshly fitted GP's integral observables: the drift
        checks compare against these reference values, not the ideal targets
        (the moment-mode fit carries a small-N integral bias)."""
        pop, pur = self.__dict__.pop("_fit_obs", (None, None))
        if pop is None:
            pop, pur = self.gps.population(), self.gps.purity()
        pop, pur = _pull(pop, pur)
        self._fit_ref = {"pop": float(pop), "pur": float(pur),
                         "target": max(float(target_purity), 1e-30)}

    def _drift_detected(self, pop: float, pur: float, target_purity: float) -> bool:
        """Conservation-drift trigger (main.cpp:174-189), relative form."""
        ref = self._fit_ref
        tol = 2.0 * AVERAGE_TOLERANCE
        pop_ok = (1.0 - tol) < pop / ref["pop"] < (1.0 + tol)
        pur_cap = (1.0 + tol) * target_purity * (ref["pur"] / ref["target"])
        return pur > pur_cap or not pop_ok

    def _target_purity(self, mc_pur: float) -> float:
        measured = mc_pur * purity_factor(self.cfg.dim) * self.purity_ratio
        return measured if self.cfg.purity_target == "measured" else self.purity

    # -- the graphed tick -----------------------------------------------------------
    def _programs(self, active, period: bool = False):
        """``(S, tick, period_end)``: the static state and the graphs of
        :func:`_tick_program` and (with ``period``) :func:`_period_program`
        for the live static arguments -- the config's, the booster size, the
        coherence divisor, the block-diagonal fit, the host's ``active``
        tuple and every state shape.  When they change, the old graphs and
        their memory are dropped and new ones are captured at their first
        call (on the CPU they run eagerly)."""
        cfg = self.cfg
        active = tuple(bool(a) for a in active)
        block_diag = self._block_diag()
        measured = cfg.purity_target == "measured"
        shapes = tuple(tuple(t.shape) for t in GR.leaves((self.density, self.extra, self.gps)))
        key = (cfg.model, cfg.mass, cfg.dt, cfg.evolve_cutoff, self._track_moments,
               self._coh_k, self._coh_div_eff, block_diag, measured, cfg.reopt_freq,
               cfg.num_extra_points, bool(cfg.pop_rescale), active, shapes)
        if self._graphs is None or self._graphs[0] != key:
            self._graphs = None
            dp, op = self.optimizer.fitted_params()
            f64 = dict(dtype=torch.float64, device=self.device)
            S = _Static(
                *GR.clone((self.density, self.extra, self.gps, dp, op)),
                scalars=torch.zeros(6, **f64),
                check=torch.zeros(cfg.reopt_freq, dtype=torch.bool, device=self.device),
                counter=torch.zeros((), dtype=torch.int64, device=self.device),
                rows=torch.zeros((cfg.reopt_freq, _TICK_WIDTH), **f64),
                draws=torch.zeros((NUM_ELEMENTS, cfg.num_extra_points,
                                   self.density.points.shape[-1]), **f64),
                period=torch.zeros(_PERIOD_WIDTH, **f64))
            tick = GR.Graph(partial(
                _tick_program, S, cfg.model, cfg.mass, cfg.dt, self._evolve_dist,
                self._track_moments, self._coh_k, self._coh_div_eff, block_diag, measured,
                active), S, "tick")
            self._graphs = [key, S, tick, None]
        S = self._graphs[1]
        if period and self._graphs[3] is None:
            self._graphs[3] = GR.Graph(partial(
                _period_program, S, cfg.model, cfg.mass, cfg.evolve_cutoff, self._coh_k,
                self._coh_div_eff, cfg.num_extra_points, measured, bool(cfg.pop_rescale),
                block_diag, active), S, "period_end")
        return S, self._graphs[2], self._graphs[3]

    def _host_active(self) -> np.ndarray:
        """``density.active`` on the host, pulled only when the tensor changed."""
        cached, host = self._active_host
        if cached is not self.density.active:
            with spans.span("wait"):
                host = self.density.active.cpu().numpy()
            self._active_host = (self.density.active, host)
        return host

    def _load(self, S: _Static) -> None:
        """Copy the driver's state, the optimizer's parameters and the drift
        reference into ``S``; the counter and the drift checks start at 0."""
        ref = self._fit_ref
        GR.copy_((S.density, S.extra, S.gps, S.diag_params, S.off_params),
                 (self.density, self.extra, self.gps, *self.optimizer.fitted_params()))
        with spans.span("wait"):
            S.scalars.copy_(torch.tensor(
                [ref["pop"], ref["pur"], ref["target"],
                 purity_factor(self.cfg.dim) * self.purity_ratio, self.purity,
                 getattr(self, "_pop_sum0", 0.0)], dtype=torch.float64))
        S.check.zero_()
        S.counter.zero_()

    def _replay(self, n_ticks: int, periods=None, span=None):
        """The tick replays of :meth:`step`, :meth:`_advance_chunk` and
        :meth:`_advance_fused`: ``n_ticks`` replays of the tick graph of the
        host's ``density.active`` tuple (:meth:`_programs`) from the
        driver's state (:meth:`_load`), counted into ``small.pairs`` on the
        host (a count inside the graph would run at its capture only), then
        one pull.  Returns ``(active, S, pulled)``, ``pulled`` = ``[rows
        (n_ticks, _TICK_WIDTH)]``.

        ``periods = (checks, draws)``, each period's drift checks and jitter
        draws, makes the ticks whole reopt periods, each followed by a replay
        of the period-end graph; ``pulled`` is then ``[rows (periods, ...),
        drift reference (3,), *the last period end's parameter leaves]``.
        On the card each period's tick replays and its period-end replay lie
        between CUDA events, whose seconds go to ``dev.fused_tick`` and
        ``dev.fused_period_end`` and onto ``span``."""
        active = self._host_active()
        S, tick, period_end = self._programs(active, period=periods is not None)
        self._load(S)
        spans.count("small.pairs", n_ticks * EV.variance_pairs(active))
        if periods is None:
            for _ in range(n_ticks):
                tick()
            return active, S, _pull(S.rows[:n_ticks])
        checks, draws = periods
        # both graphs are captured first, so that no capture lies between two
        # events
        events = None
        if self.device.type == "cuda":
            tick.capture()
            period_end.capture()
            events = [[torch.cuda.Event(enable_timing=True) for _ in range(3)]
                      for _ in range(len(checks))]
        rows = []
        for p in range(len(checks)):
            S.check.copy_(checks[p])
            S.counter.zero_()
            S.draws.copy_(draws[p])
            if events:
                events[p][0].record()
            for _ in range(self.cfg.reopt_freq):
                tick()
            if events:
                events[p][1].record()
            period_end()
            if events:
                events[p][2].record()
            rows.append(torch.cat([S.rows.reshape(-1), S.period]))
        pulled = _pull(torch.stack(rows), S.scalars[:3],
                       *GR.leaves((S.diag_params, S.off_params)))
        if events:
            # the pull waited for the stream, so every event has completed
            dev_tick = sum(a.elapsed_time(b) for a, b, _ in events) * 1e-3
            dev_end = sum(b.elapsed_time(c) for _, b, c in events) * 1e-3
            spans.add("dev.fused_tick", dev_tick)
            spans.add("dev.fused_period_end", dev_end)
            span.set(dev_tick_s=dev_tick, dev_period_end_s=dev_end)
        return active, S, pulled

    def _clone_out(self, S: _Static, active):
        """The replays' density, extra clouds and fits, cloned out of the
        static state ``S``, with ``active`` their host tuple."""
        density, extra, gps = GR.clone((S.density, S.extra, S.gps))
        self._active_host = (density.active, active)
        return density, extra, gps

    def _snapshot(self) -> dict:
        """What a fused segment changes besides the optimizer (each replaced,
        never written into): the clouds, the fits, the random key, the drift
        reference and the last optimizer result."""
        return dict(density=self.density, extra=self.extra, gps=self.gps, rng=self.rng,
                    _fit_ref=dict(self._fit_ref), opt_result=self.opt_result)

    def _restore(self, snap: dict) -> None:
        for name, value in snap.items():
            setattr(self, name, value)

    @_collected
    @torch.inference_mode()
    def _advance_chunk(self, n_ticks: int) -> bool:
        """Advance ``n_ticks`` ticks -- ``n_ticks`` replays of the tick graph
        (``_ticks_scan``'s chunk, ``gple_tpu/driver.py:190-219``) -- and pull
        the chunk's flags and boundary scalars to the host once.

        Returns False (state untouched) if an element activated mid-chunk --
        the caller then replays the chunk tick-by-tick through :meth:`step`.
        A conservation-drift check runs at the chunk end."""
        with spans.span("chunk", n=n_ticks) as chunk:
            active, S, (rows,) = self._replay(n_ticks)
            smalls = rows[:, _SMALL:_SMALL + NUM_ELEMENTS] > 0
            if np.any(~smalls != active[None, :]):
                chunk.set(ok=False)
                return False
            self.density, self.extra, self.gps = self._clone_out(S, active)
            chunk.set(ok=True)
        target_purity = self._target_purity(float(rows[-1, _MC_PUR]))
        if self._drift_detected(float(rows[-1, _POP]), float(rows[-1, _PUR]), target_purity):
            self._reoptimize(target_purity)
        return True

    @torch.inference_mode()
    def _coh_purity_rescale(self) -> float:
        """Scalar purity-conservation rescale of the coherence labels (main
        cloud and booster slots) against the run's initial purity
        (GPLEConfig.coh_boost_rescale); the factor applied, 1.0 for none."""
        pf = purity_factor(self.cfg.dim) * self.purity_ratio
        (m,) = _pull(OBS.purity_each_element(self.density))
        p_diag = float(m[0, 0] + m[1, 1]) * pf
        p_off = float(m[0, 1] + m[1, 0]) * pf     # the coherence counted twice
        if p_off <= 0.0:
            return 1.0
        s = math.sqrt(max(self.purity - p_diag, 0.0) / p_off)
        if s >= 1.0:
            return 1.0
        rho = self.density.rho.clone()
        rho[OFFDIAG_INDEX] *= s
        self.density = self.density._replace(rho=rho)
        if self._coh_k > 0:
            e_rho = self.extra.rho.clone()
            e_rho[OFFDIAG_INDEX, :self._coh_k] *= s
            self.extra = self.extra._replace(rho=e_rho)
        self.stats["coh_rescales"] = self.stats.get("coh_rescales", 0) + 1
        return s

    @torch.inference_mode()
    def _pop_conservation_rescale(self) -> float:
        """Scalar population-conservation rescale of the diagonal labels
        against the run's initial total population numerator
        (GPLEConfig.pop_rescale); the factor applied, 1.0 for none or for an
        out-of-band factor outside [0.5, 2]."""
        (tot,) = _pull(torch.sum(diag_rows(self.density.rho)[..., 0]))
        tot = float(tot)
        if not np.isfinite(tot) or tot <= 0.0:
            return 1.0
        s = self._pop_sum0 / tot
        if not (0.5 <= s <= 2.0):
            self._log(f"population rescale out of band (s={s:.3f}): skipped")
            return 1.0
        rho = self.density.rho.clone()
        for k in DIAG_INDICES:
            rho[k, :, 0] *= s
        self.density = self.density._replace(rho=rho)
        if abs(s - 1.0) > 1e-6:
            self.stats["pop_rescales"] = self.stats.get("pop_rescales", 0) + 1
        return s

    @_collected
    @torch.inference_mode()
    def _reoptimize(self, target_purity: float) -> str:
        cfg = self.cfg
        with spans.span("reopt"):
            with spans.span("reselect"):
                density = self._track_clouds(self.density)
                self.density = density
                rescaled = False
                if cfg.pop_rescale:
                    rescaled = self._pop_conservation_rescale() != 1.0
                    density = self.density
                if cfg.coh_boost_rescale:
                    rescaled |= self._coh_purity_rescale() < 1.0
                    density = self.density
                if rescaled and cfg.purity_target == "measured":
                    # the caller's target came from the pre-rescale MC purity
                    (mc_pur,) = _pull(torch.sum(OBS.purity_each_element(density)))
                    target_purity = float(mc_pur) * purity_factor(cfg.dim) * self.purity_ratio
            with spans.span("tune"):
                energies = OBS.total_energy_each_surface(cfg.model, density, cfg.mass)
                self.optimizer.purity = target_purity
                self.optimizer.off_len_div = self._coh_div_eff
                self.opt_result = self.optimizer.optimize(density, self.extra, energies)
            with spans.span("fit"):
                diag_params, off_params = self.optimizer.fitted_params()
                # one RNG split per ACTIVE element, in element order
                active = _pull(density.active)[0] > 0
                keys = [self._split() if active[k] else None for k in range(NUM_ELEMENTS)]
                self.gps, self.extra, pop, pur = _reopt_epilogue(
                    cfg.evolve_cutoff, self._coh_k, cfg.num_extra_points, density, self.extra,
                    diag_params, off_params, keys, self._block_diag())
                pop, pur = _pull(pop, pur)
                # coherence fit-health backoff (GPLEConfig.coh_fit_health_factor):
                # while the purity integral is detached from its target, stickily
                # halve the coherence divisor (floor 2), then eject the booster; the
                # retry refits from the extra cloud the previous try regenerated,
                # with the same keys, as the JAX package does
                hf = float(cfg.coh_fit_health_factor)
                while (hf > 0.0 and active[OFFDIAG_INDEX]
                       and (self._coh_div_eff > 2.0 or self._coh_k > 0)
                       and float(pur) > hf * max(float(target_purity), 1e-30)):
                    if self._coh_div_eff > 2.0:
                        self._coh_div_eff = max(2.0, self._coh_div_eff / 2.0)
                        self.optimizer.off_len_div = self._coh_div_eff
                        self.stats["coh_len_backoffs"] = self.stats.get("coh_len_backoffs", 0) + 1
                        self._log(f"coherence fit unhealthy (purity {float(pur):.3f} vs target "
                                  f"{target_purity:.3f}): len_div -> {self._coh_div_eff}")
                    else:
                        self._coh_k = 0
                        self.optimizer.coh_fit_extra = 0
                        self.stats["coh_boost_ejected"] = self.stats.get("coh_boost_ejected", 0) + 1
                        self._log(f"coherence fit unhealthy at div-2 floor (purity "
                                  f"{float(pur):.3f}): booster EJECTED")
                    self.opt_result = self.optimizer.optimize(density, self.extra, energies)
                    diag_params, off_params = self.optimizer.fitted_params()
                    self.gps, self.extra, pop, pur = _reopt_epilogue(
                        cfg.evolve_cutoff, self._coh_k, cfg.num_extra_points, density, self.extra,
                        diag_params, off_params, keys, self._block_diag())
                    pop, pur = _pull(pop, pur)
                self._fit_ref = {"pop": float(pop), "pur": float(pur),
                                 "target": max(float(target_purity), 1e-30)}
                self._sync()
        return self.opt_result.opt_type

    # -- one tick (main.cpp:135-202) ------------------------------------------------
    @_collected
    @torch.inference_mode()
    def step(self, tick_no: int) -> str:
        """Tick ``tick_no``: one replay of the tick graph, then the host's
        decisions -- a new or vanished element (seeded or zeroed), the
        scheduled reoptimization, the conservation-drift trigger."""
        cfg = self.cfg
        with spans.span("step", tick=tick_no):
            with spans.span("evolve"):
                old_active, S, (rows,) = self._replay(1)
                density, extra, new_gps = self._clone_out(S, old_active)
                row = rows[0]
                pop, pur, mc_pur = row[_POP], row[_PUR], row[_MC_PUR]
            new_active = row[_SMALL:_SMALL + NUM_ELEMENTS] == 0
            opt_type = "none"
            changed = bool(np.any(new_active != old_active))
            if changed:
                self._event_ticks.add(tick_no)
                self.stats["element_activations"] += int(np.sum(new_active & ~old_active))
                with spans.span("seed"):
                    density, extra = self._element_change(density, extra, old_active,
                                                          new_active)
                # the tick's MC purity predates the reseeding
                (mc_pur,) = _pull(torch.sum(OBS.purity_each_element(density)))
            target_purity = self._target_purity(float(mc_pur))
            needs_opt = changed or (tick_no % cfg.reopt_freq == 0)
            if not needs_opt:
                # drift check with the refitted states (main.cpp:174-189)
                self.density, self.extra, self.gps = density, extra, new_gps
                if self._drift_detected(float(pop), float(pur), target_purity):
                    needs_opt = True
                    opt_type = "drift"
                    self._event_ticks.add(tick_no)
            if needs_opt:
                self.density, self.extra = density, extra
                reopt_type = self._reoptimize(target_purity)
                opt_type = reopt_type if opt_type == "none" else opt_type
        return opt_type

    def _relabel_gps(self, density: Density, extra: Density) -> GPStates:
        """GP states for RELABELING walks only (re-selection / new-element
        seeding): at a coherence divisor above 2 the live fit is near-
        interpolating, so the same coherence data (with the booster points)
        is refit at the smooth div-2 lengthscale for the relabel queries.  At
        the default divisor 2 these are the live states."""
        if self._coh_div_eff <= 2.0:
            return self.gps
        live = self.gps.offdiag.params
        scale = self._coh_div_eff / 2.0
        safe = live._replace(real_lengths=live.real_lengths * scale,
                             imag_lengths=live.imag_lengths * scale)
        off_pts, off_rho = density.points[OFFDIAG_INDEX], density.rho[OFFDIAG_INDEX]
        if self._coh_k > 0:
            oe_pts, oe_rho = _off_extra_slice(extra, self._coh_k)
            off_pts, off_rho = torch.cat([off_pts, oe_pts]), torch.cat([off_rho, oe_rho])
        off = CK.fit_complex(safe, off_pts, off_rho, block_diag=self._block_diag())
        return GPStates(diag=self.gps.diag, offdiag=off, active=self.gps.active)

    #: relabel-continuity factors outside this band mean the relabel query
    #: itself is corrupt: the re-selection is rejected instead
    RELABEL_SCALE_BAND = (0.2, 5.0)
    #: an element whose own integral is below this fraction of the total
    #: diagonal population numerator is nascent: its relabel is taken unscaled
    RELABEL_NASCENT_FRAC = 0.05

    def _relabel_scale(self, k: int, rho_old, rho_new, nascent_ref=None):
        """Continuity factor for a re-selected element's fresh labels, or None
        to reject the relabel (GPLEConfig.relabel_conserve): the diagonal
        point sum (sum Re rho) or the coherence's sum |rho|^2 is kept across
        the re-selection; factors outside :attr:`RELABEL_SCALE_BAND`, sign
        flips and zero sums reject.  A nascent element (integral -- the L1
        sum of |rho| for the coherence -- below RELABEL_NASCENT_FRAC of
        ``nascent_ref``) takes the fresh labels unscaled while they stay
        within twice that threshold (and, for a diagonal, positive), else it
        rejects.  ``rho_old`` / ``rho_new``: (N, 2) host arrays or tensors."""
        old = _pull(rho_old)[0] if isinstance(rho_old, torch.Tensor) else np.asarray(rho_old)
        new = _pull(rho_new)[0] if isinstance(rho_new, torch.Tensor) else np.asarray(rho_new)
        thresh = (self.RELABEL_NASCENT_FRAC * nascent_ref
                  if nascent_ref is not None else None)
        if k == OFFDIAG_INDEX:
            pre = float(np.sum(old[:, 0] ** 2 + old[:, 1] ** 2))
            post = float(np.sum(new[:, 0] ** 2 + new[:, 1] ** 2))
            pre_l1 = float(np.sum(np.sqrt(old[:, 0] ** 2 + old[:, 1] ** 2)))
            post_l1 = float(np.sum(np.sqrt(new[:, 0] ** 2 + new[:, 1] ** 2)))
            if thresh is not None and pre_l1 < thresh:
                if post_l1 <= 2.0 * thresh:
                    self.stats["relabel_nascent"] = self.stats.get("relabel_nascent", 0) + 1
                    return 1.0
                self._log("nascent relabel REJECTED (post integral "
                          f"{post_l1:.3g} beyond 2x nascent band)")
                return None
            if post <= 0.0 or pre <= 0.0:
                return None
            s = float(np.sqrt(pre / post))
        else:
            pre = float(np.sum(old[:, 0]))
            post = float(np.sum(new[:, 0]))
            if thresh is not None and abs(pre) < thresh:
                if post > 0.0 and post <= 2.0 * thresh:
                    self.stats["relabel_nascent"] = self.stats.get("relabel_nascent", 0) + 1
                    return 1.0
                self._log("nascent relabel REJECTED (post integral "
                          f"{post:.3g} outside (0, 2x nascent band])")
                return None
            if post == 0.0 or pre == 0.0 or (pre > 0) != (post > 0):
                return None     # a sign flip: the relabel query is corrupt
            s = pre / post
        lo, hi = self.RELABEL_SCALE_BAND
        if not (lo <= s <= hi) or not np.isfinite(s):
            return None
        return s

    def _walk_surrogate(self, gps, elem: int, density: Density, extra: Density):
        """(walk_fn, walk_params) Metropolis target for ``elem``'s chains (see
        GPLEConfig.mc_walk_surrogate), or None for exact walks.  The grid box
        doubles the union cloud's bounding box; the surrogate is zero outside,
        which simply rejects proposals there."""
        cfg = self.cfg
        if not cfg.mc_walk_surrogate or density.points.shape[-1] != 2:
            return None
        pts = torch.cat([density.points.reshape(-1, 2), extra.points.reshape(-1, 2)])
        lo = torch.amin(pts, dim=0)
        hi = torch.amax(pts, dim=0)
        span = hi - lo
        lo = lo - 0.5 * span
        hi = hi + 0.5 * span
        grid = _surrogate_grid(cfg.model, cfg.mass, cfg.dt, elem, gps, lo, hi,
                               self._evolve_dist)
        return (_surrogate_dist, (grid, lo, hi))

    def _track_clouds(self, density: Density) -> Density:
        """Re-select an element's points from its CURRENT predicted density
        when the cloud has drifted off its own mass: walk them with the tuned
        Metropolis kernel to the backward-branching predictor's density, which
        has support where transferred mass lands (the reference's mid-run
        seeding machinery, mc.cpp:407-537, applied on drift)."""
        cfg = self.cfg
        if not cfg.track_clouds:
            return density
        flags = _pull(_cloud_drift_flags(density))[0] > 0
        if self._coh_k > 0 and not cfg.coh_reselect:
            # a live booster keeps its coherence cloud: its points follow
            # their characteristics and its labels are carried
            flags[OFFDIAG_INDEX] = False
        if not flags.any():
            return density
        pts = density.points.clone()
        rho = density.rho.clone()
        changed = False
        relabel_gps = self._relabel_gps(density, self.extra)
        for k in np.nonzero(flags)[0]:
            self._log(f"element {ELEMENTS[k]} cloud re-selected")
            self.stats["cloud_reselections"] += 1
            gps_k = relabel_gps
            if cfg.relabel_mask_coh and k != OFFDIAG_INDEX:
                # a diagonal relabel with the coherence masked out of the predictor
                active = relabel_gps.active.clone()
                active[OFFDIAG_INDEX] = False
                gps_k = relabel_gps._replace(active=active)
            walk = self._walk_surrogate(gps_k, k, density, self.extra)
            p, r, self.mc_params[k] = mc.element_monte_carlo(
                self._split(), self._new_pt_dists[k], gps_k, density.points[k],
                self.mc_params[k], tune=cfg.mc_retune, walk=walk, chains=self._chains)
            s = 1.0
            if cfg.relabel_conserve:
                # the nascent reference: the diagonal point sums as relabeled so far
                (sums,) = _pull(diag_rows(rho)[..., 0].sum(dim=-1))
                s = self._relabel_scale(k, density.rho[k], r, float(np.sum(np.abs(sums))))
                if s is None:
                    # a corrupt relabel: the element keeps its points and labels
                    self._log(f"element {ELEMENTS[k]} relabel REJECTED "
                              f"(integral jump outside band)")
                    self.stats["relabel_rejects"] = self.stats.get("relabel_rejects", 0) + 1
                    continue
                r = r * s
                self.stats["relabel_rescales"] = self.stats.get("relabel_rescales", 0) + 1
            pts[k], rho[k] = p, r
            if k == OFFDIAG_INDEX and self._coh_k > 0:
                # the booster slots take the same walk and the same factor
                kk = self._coh_k
                bp, br, _ = mc.element_monte_carlo(
                    self._split(), self._new_pt_dists[k], relabel_gps,
                    self.extra.points[k, :kk], self.mc_params[k], tune=False, walk=walk,
                    chains=self._chains)
                e_pts, e_rho = self.extra.points.clone(), self.extra.rho.clone()
                e_pts[k, :kk], e_rho[k, :kk] = bp, br * s
                self.extra = Density(points=e_pts, rho=e_rho, active=self.extra.active)
            changed = True
        if not changed:
            return density
        return Density(points=pts, rho=rho, active=density.active)

    def _element_change(self, density, extra, old_active, new_active):
        """new_element_point_selection (mc.cpp:407-537): seed each new element
        from the best-scoring existing coordinates; zero a vanished one."""
        candidates = torch.cat([density.points.reshape(-1, density.points.shape[-1]),
                                extra.points.reshape(-1, 2)])
        gps = self._relabel_gps(density, extra)
        pts, rho = density.points.clone(), density.rho.clone()
        e_pts, e_rho = extra.points.clone(), extra.rho.clone()
        for k in range(NUM_ELEMENTS):
            if new_active[k] and not old_active[k]:
                self._log(f"element {ELEMENTS[k]} appears")
                walk = self._walk_surrogate(gps, k, density, extra)
                pts[k], rho[k], self.mc_params[k] = mc.seed_new_element(
                    self._split(), candidates, self.cfg.num_points,
                    self._new_pt_dists[k], gps, self.mc_params[k], walk=walk,
                    chains=self._chains)
                if k == OFFDIAG_INDEX and self._coh_k > 0:
                    # seed the booster slots the same way
                    e_pts[k, :self._coh_k], e_rho[k, :self._coh_k], _ = mc.seed_new_element(
                        self._split(), candidates, self._coh_k, self._new_pt_dists[k], gps,
                        self.mc_params[k], walk=walk, chains=self._chains)
            elif old_active[k] and not new_active[k]:
                self._log(f"element {ELEMENTS[k]} vanishes")
                rho[k] = 0.0
                if k == OFFDIAG_INDEX and self._coh_k > 0:
                    e_rho[k, :self._coh_k] = 0.0
        with spans.span("wait"):
            active = torch.tensor(new_active, device=self.device)
        return (Density(points=pts, rho=rho, active=active),
                Density(points=e_pts, rho=e_rho, active=active))

    # -- a fused segment (scheduled reopts on the device) ------------------------------
    @_collected
    @torch.inference_mode()
    def _advance_fused(self, start_tick: int, n: int, callback=None):
        """Advance ``n`` ticks -- whole reoptimization periods, the first right
        after a scheduled reopt -- on the device with no host decision: per
        period ``reopt_freq`` replays of the tick graph and one of the
        period-end graph, the scheduled moment reopt included; then ONE host
        pull of every tick's flags and observables (``_advance_fused`` of
        ``gple_tpu/driver.py:1354-1476``).

        Returns ``(ok, stopped)``.  ``ok`` is False when an event fired in the
        segment -- an element activated or vanished, the conservation drift
        triggered where the chunked path checks it, or a cloud asks for
        re-selection -- and then every state the segment touched (density,
        extra clouds, fits, random key, optimizer, drift reference) is rolled
        back, bit for bit, and ``stopped`` is the first event's tick, up to
        which the caller replays the chunked path.  Otherwise the records and
        callbacks of the segment's outputs are made and ``stopped`` says
        whether the packet left the interaction region.  The scheduled
        reopts' keys are split in the order :meth:`_reoptimize` would take
        them, and their jitter draws made before the first replay."""
        cfg = self.cfg
        opt = self.optimizer
        rf = cfg.reopt_freq
        n_periods = n // rf
        with spans.span("fused", tick=start_tick, n=n) as fused:
            snap, opt_snap = self._snapshot(), opt.snapshot()
            ticks = np.arange(start_tick, start_tick + n)
            reopt_mask = ticks % rf == 0
            # the chunked path's drift checks: chunk ends and non-reopt boundaries
            # (the period end reopts unconditionally)
            in_b = (ticks % cfg.output_freq == 0) | reopt_mask
            next_in_b = ((ticks + 1) % cfg.output_freq == 0) | ((ticks + 1) % rf == 0)
            check_mask = (next_in_b | (in_b & ~reopt_mask)) & ~reopt_mask
            active = self._host_active()
            n_extra, dim = cfg.num_extra_points, self.density.points.shape[-1]
            draws = torch.zeros((n_periods, NUM_ELEMENTS, n_extra, dim), dtype=torch.float64,
                                device=self.device)
            for p in range(n_periods):
                for k in np.nonzero(active)[0]:
                    draws[p, k] = self._split().normal((n_extra, dim))
            with spans.span("wait"):
                checks = torch.tensor(check_mask.reshape(n_periods, rf), device=self.device)
            active, S, (host, fit_ref, *params) = self._replay(n, (checks, draws), fused)
            tick_rows = host[:, :rf * _TICK_WIDTH].reshape(n, _TICK_WIDTH)
            period_rows = host[:, rf * _TICK_WIDTH:]
            small = tick_rows[:, _SMALL:_SMALL + NUM_ELEMENTS] > 0
            event = (~small != active[None, :]).any(axis=1) | (tick_rows[:, _DRIFT] > 0)
            if cfg.track_clouds:
                # the re-selection flags of the period ends (scheduled reopt ticks)
                event[rf - 1::rf] |= period_rows[:, _RESEL] > 0
            if event.any():
                self._restore(snap)
                opt.restore(opt_snap)
                fused.set(ok=False)
                return False, int(ticks[np.argmax(event)])
            self.density, self.extra, self.gps = self._clone_out(S, active)
            # the optimizer takes the last reopt's parameters, as the host reopt
            # leaves them
            self.opt_result = opt.adopt(RK.KernelParams(*params[:3]),
                                        CK.ComplexKernelParams(*params[3:]),
                                        period_rows[-1, _ERR])
            self._fit_ref = dict(zip(("pop", "pur", "target"), map(float, fit_ref)))
            if cfg.pop_rescale:
                applied = int(np.sum(np.abs(period_rows[:, _POP_S] - 1.0) > 1e-6))
                if applied:
                    self.stats["pop_rescales"] = self.stats.get("pop_rescales", 0) + applied
            fused.set(ok=True)
        # the records of the segment's outputs; a period's last tick reports
        # the observables after its reopt
        with spans.span("output"):
            stopped = False
            for i in np.nonzero(ticks % cfg.output_freq == 0)[0]:
                obs = (period_rows[i // rf, _OBS_LAST:] if reopt_mask[i]
                       else tick_rows[i, _OBS:])
                rec = self._record_from_obs(int(ticks[i]), _unpack_obs(obs),
                                            "moment" if reopt_mask[i] else "none")
                if callback is not None:
                    callback(rec)
                if rec.x_average > -cfg.x0:
                    self._log("wavepacket has left the interaction region")
                    stopped = True
                    break
        return True, stopped

    # -- observation / output ---------------------------------------------------------
    @_collected
    @torch.inference_mode()
    def observe(self, tick: int, opt_type: str) -> TickRecord:
        cfg = self.cfg
        with spans.span("observe"):
            obs = OBS.observe_all(cfg.model, self.density, self.gps, cfg.mass)
            host = dict(zip(list(obs), _pull(*obs.values())))
        return self._record_from_obs(tick, host, opt_type)

    def _record_from_obs(self, tick: int, obs, opt_type: str) -> TickRecord:
        cfg = self.cfg
        ppl_prm = obs["ppl_prm_each"]
        ppl_prm = ppl_prm / max(ppl_prm.sum(), 1e-30)
        rec = TickRecord(
            time=tick * cfg.dt,
            population_prm=float(obs["pop_prm"]),
            population_prm_each=ppl_prm,
            population_mci=obs["ppl_mci"],
            energy_prm=float(obs["energy_prm"]),
            energy_mci=float(obs["energy_mci"]),
            purity_prm=float(obs["purity_prm"]),
            purity_mci=float(obs["purity_mci_raw"]) * purity_factor(cfg.dim)
            * self.purity_ratio,
            x_average=float(obs["x_average"]),
            opt_type=opt_type,
        )
        self.history.append(rec)
        if self.writers:
            with spans.span("write"):
                self._write_outputs(rec, obs["energies"])
        self._log(
            f"t={rec.time:8.2f} pop={rec.population_prm:.4f} "
            f"E={rec.energy_prm:.6f} purity={rec.purity_prm:.4f} "
            f"<x>={rec.x_average:8.3f} ppl={np.asarray(obs['ppl_mci']).round(4)} "
            f"opt={opt_type}")
        return rec

    def _write_outputs(self, rec: TickRecord, energies):
        cfg = self.cfg
        density, extra, gps = self.density, self.extra, self.gps
        preds, variances = _grid_predictions(gps, self._grid)
        (pops_prm, r_prm, r_mci0, r_mci1, r_all_prm, r_all_mci, pur_diag, pur_off,
         purity_mci, points, rho, e_points, e_rho, preds, variances, diag_rescale,
         off_rescale, active) = _pull(
            gps.population_each(), RK.r_average(gps.diag),
            OBS.r_average_one_element(density.points[0], density.rho[0]),
            OBS.r_average_one_element(density.points[2], density.rho[2]),
            gps.r_average(), OBS.r_average_all_surfaces(density), RK.purity(gps.diag),
            CK.purity_complex(gps.offdiag), OBS.purity_each_element(density),
            density.points, density.rho, extra.points, extra.rho, preds, variances,
            gps.diag.rescale, gps.offdiag.rescale, gps.active)
        active = active > 0
        r_mci = (r_mci0, r_mci1)
        surface_rows = [(pops_prm[s], r_prm[s], rec.population_mci[s], r_mci[s],
                         float(energies[s])) for s in range(2)]
        pop = max(rec.population_prm, 1e-300)
        totals = [rec.population_prm, *(r_all_prm / pop), rec.energy_prm / pop,
                  rec.population_mci.sum(), *r_all_mci, rec.energy_mci]
        pur_off = float(pur_off) if active[OFFDIAG_INDEX] else 0.0
        purity_prm = np.array([[pur_diag[0], pur_off], [pur_off, pur_diag[1]]])
        self.writers.write_average(surface_rows, totals, purity_prm,
                                   purity_mci * purity_factor(cfg.dim))
        self.writers.write_param(self.optimizer.param_rows(points))
        self.writers.write_points(points, rho[..., 0] + 1.0j * rho[..., 1],
                                  e_points, e_rho[..., 0] + 1.0j * e_rho[..., 1])
        self.writers.write_phase(preds[..., 0] + 1.0j * preds[..., 1], variances)
        # label rescale factors in triangular order (00), (10), (11); NaN for
        # absent elements like the reference (output.cpp:264-292)
        rescales = np.where(active, [diag_rescale[0], float(off_rescale), diag_rescale[1]],
                            np.nan)
        steps = self.opt_result.steps
        self.writers.write_log(
            rec.time, self.opt_result.error, [p.num_steps for p in self.mc_params],
            [p.displacement for p in self.mc_params], rec.opt_type, rescales=rescales,
            opt_steps=sum(steps) if isinstance(steps, (list, tuple)) else steps)

    # -- full run (main.cpp:132-202) ----------------------------------------------------
    def run(self, max_ticks: Optional[int] = None, callback: Optional[Callable] = None,
            checkpoint_path: Optional[str] = None, checkpoint_every: int = 0,
            resume_from: Optional[str] = None) -> List[TickRecord]:
        """Initialize (or restore ``resume_from``, a checkpoint of either
        package), then advance to ``max_ticks`` (:meth:`_advance`): fused
        segments where they may run, else boundary-aligned chunks.  With
        ``checkpoint_path`` and ``checkpoint_every``, the state is written to
        ``checkpoint_path`` after every multiple of ``checkpoint_every``.  With
        ``GPLEConfig.init_cache``, the event ticks go to the hints file
        beside the cache (:meth:`_event_hints_path`)."""
        cfg = self.cfg
        with contextlib.ExitStack() as profiling:
            if self.profile_dir:
                self._start_profiler()
                profiling.callback(self._stop_profiler)
                profiling.enter_context(spans.timeline())
            timeline = spans.current_timeline()
            with spans.collect(self.totals), spans.span("run", max_ticks=max_ticks) as root:
                with spans.span("init"):
                    if resume_from:
                        start = ckpt.load_checkpoint(resume_from, self) + 1
                    else:
                        self._initialize_or_restore()
                        start = 1
                if resume_from:
                    self._log(f"resumed from {resume_from} at tick {start}")
                else:
                    with spans.span("output"):
                        self.observe(0, self.opt_result.opt_type)
                total = (cfg.total_ticks if max_ticks is None
                         else min(cfg.total_ticks, max_ticks))
                every = checkpoint_every if checkpoint_path else 0
                hints = (self._event_hints_path() if cfg.init_cache and not resume_from
                         else None)
                self._advance(start, total, callback, checkpoint_path, every, hints)
            if timeline is not None:
                self.spans = timeline.under(root)
        self._log(f"phase wall times: {self.phase_times}")
        if self.writers:
            self.writers.close()
        return self.history

    def _initialize_or_restore(self) -> None:
        """:meth:`initialize`, or with ``GPLEConfig.init_cache`` the restore
        of the state a cold run of the same config saved after it (written
        here on a miss).  The restore refits from the saved clouds and
        parameters, as the cold run did, so the run goes on bit for bit."""
        path = self._init_cache_path() if self.cfg.init_cache else None
        if path and os.path.exists(path):
            ckpt.load_checkpoint(path, self)
            # the cold run took its drift reference against the initial
            # purity itself, not against the measured one a resume takes
            self._fit_ref["target"] = max(float(self.purity), 1e-30)
            self._log(f"init restored from cache {path}")
            return
        self.initialize()
        if path:
            ckpt.save_checkpoint(path, self, 0)

    def _start_profiler(self) -> None:
        os.makedirs(self.profile_dir, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.profiler = torch.profiler.profile(activities=activities)
        self.profiler.start()

    def _stop_profiler(self) -> None:
        self._sync()
        self.profiler.stop()
        self.trace_path = os.path.join(
            self.profile_dir, f"gple_trace_{os.getpid()}_{time.time_ns()}.json")
        self.profiler.export_chrome_trace(self.trace_path)
        self._log(f"profile trace written to {self.trace_path}")

    @_collected
    def _advance(self, tick: int, total: int, callback=None,
                 checkpoint_path: Optional[str] = None, checkpoint_every: int = 0,
                 hints_path: Optional[str] = None):
        """The loop of :meth:`run` from ``tick`` to ``total`` (inclusive),
        ``gple_tpu/driver.py:1629-1749``.

        Fused segments (:meth:`_advance_fused`) run where they may: the moment
        optimizer, ``fused_chunk > 0``, no writers, no checkpoints and no
        ``coh_boost_rescale`` (its rescale is not in the period end).  A
        segment is ``fused_chunk`` ticks rounded down to whole reopt periods
        and starts right after a scheduled reopt.  After an aborted segment,
        segments are one period long until two in a row run clean (the abort
        hysteresis), and the chunked path replays through the event.  Event
        ticks recorded in ``hints_path`` (:meth:`_event_hints_path`) by an
        earlier run block the segments that hold them; this run's event ticks
        are added to the file at the end.

        The chunked path: every tick up to the next scheduled reopt, output or
        checkpoint is one :meth:`_advance_chunk` (replayed through
        :meth:`step` when an element activates inside it), and the boundary
        tick itself goes through :meth:`step`."""
        cfg = self.cfg
        rf = cfg.reopt_freq

        def next_multiple(t: int, k: int) -> int:
            return ((t + k - 1) // k) * k if k else total

        use_fused = (cfg.opt_mode == "moment" and cfg.fused_chunk > 0
                     and self.writers is None and not checkpoint_every
                     and not cfg.coh_boost_rescale)
        n_fused = max(1, cfg.fused_chunk // rf) * rf
        seg_len, clean_streak = n_fused, 0
        event_hints = set()
        if hints_path and os.path.exists(hints_path):
            try:
                with open(hints_path) as f:
                    event_hints = set(json.load(f))
                self._log(f"fusion event hints: {sorted(event_hints)}")
            except (OSError, ValueError):
                event_hints = set()
        fused_block_until = 0    # the chunked path replays up to this event tick
        try:
            while tick <= total:
                if (use_fused and tick > fused_block_until and (tick - 1) % rf == 0
                        and tick + seg_len - 1 <= total):
                    hinted = [h for h in event_hints if tick <= h < tick + seg_len]
                    if hinted:
                        fused_block_until = min(hinted)
                    else:
                        ok, res = self._advance_fused(tick, seg_len, callback)
                        if ok:
                            tick += seg_len
                            clean_streak += 1
                            if clean_streak >= 2:
                                seg_len = n_fused
                            if res:
                                break
                            continue
                        fused_block_until = res
                        self._event_ticks.add(res)
                        seg_len, clean_streak = rf, 0
                # the next tick where the host must intervene: scheduled
                # reopt, output or checkpoint; everything before it is one chunk
                boundary = min(next_multiple(tick, rf), next_multiple(tick, cfg.output_freq),
                               next_multiple(tick, checkpoint_every), total)
                n_pre = boundary - tick
                # only the steady-state chunk length is chunked, as in the JAX
                # package; odd remainders go tick by tick
                canonical = n_pre == min(cfg.output_freq, rf) - 1
                if not (n_pre > 0 and canonical and self._advance_chunk(n_pre)):
                    for t in range(tick, boundary):
                        self.step(t)
                tick = boundary
                opt_type = self.step(tick)
                if checkpoint_every and tick % checkpoint_every == 0:
                    ckpt.save_checkpoint(checkpoint_path, self, tick)
                if tick % cfg.output_freq == 0:
                    with spans.span("output"):
                        rec = self.observe(tick, opt_type)
                    if callback is not None:
                        callback(rec)
                    if rec.x_average > -cfg.x0:
                        self._log("wavepacket has left the interaction region")
                        break
                tick += 1
        finally:
            if hints_path and self._event_ticks:
                try:
                    with open(hints_path, "w") as f:
                        json.dump(sorted({int(t) for t in event_hints | self._event_ticks}), f)
                except OSError:
                    pass
