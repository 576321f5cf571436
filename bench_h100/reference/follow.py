"""A trajectory state followed tick by tick, its moment reoptimization and its
observables: the reference the benchmark's check holds the program's
trajectory to.

A state is the sampled points (3, N, 2), their density values (3, N, 2) and
the active mask (3,); the hyperparameters are the moment optimizer's: the
diagonal lengths (2, 2) and magnitudes (2,), the coherence's (m_R, l_R (2),
m_I, l_I (2), corr) and magnitude.  The fits are always made again here from
the points, labels and hyperparameters: the coherence's block-diagonal fit
(:mod:`.gp`) at corr = 0, the coupled one (:mod:`.coupled`) otherwise."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from bench_h100.reference import coupled as CP
from bench_h100.reference import evolve as EV
from bench_h100.reference import gp as GP
from bench_h100.reference import physics as PH

DIAG = (0, 2)
MIN_LENGTH = 1.0 / 100.0


class Params(NamedTuple):
    diag_lengths: torch.Tensor   # (2, 2)
    diag_mags: torch.Tensor      # (2,)
    off: torch.Tensor            # (7,) m_R, l_R, m_I, l_I, corr
    off_mag: torch.Tensor        # ()


class Fits(NamedTuple):
    diag: tuple      # RealGP or None, for elements 0 and 2
    off: object      # ComplexGP or None
    active: tuple    # host bools


def fit(params: Params, points, rho, active) -> Fits:
    diag = tuple(GP.fit_real(params.diag_mags[d], params.diag_lengths[d], points[k],
                             rho[k, :, 0]) if active[k] else None
                 for d, k in enumerate(DIAG))
    off = None
    if active[1]:
        o = params.off
        if float(o[6]) != 0.0:
            off = CP.fit(params.off_mag, o, points[1], rho[1])
        else:
            off = GP.fit_complex(params.off_mag, o[0], o[1:3], o[3], o[4:6], points[1], rho[1])
    return Fits(diag, off, tuple(active))


def _coupled(off) -> bool:
    return isinstance(off, CP.CoupledGP)


def dist(fits: Fits, with_variance: bool):
    """pts (3, M, 2) -> every element's prediction (3, M, 2); 0 where inactive."""
    def predict(pts):
        out = torch.zeros(pts.shape[:2] + (2,), dtype=pts.dtype, device=pts.device)
        for d, k in enumerate(DIAG):
            if fits.diag[d] is not None:
                out[k, :, 0] = GP.predict_real(fits.diag[d], pts[k], with_variance)
        if _coupled(fits.off):
            out[1] = CP.predict(fits.off, pts[1], with_variance)
        elif fits.off is not None:
            out[1] = GP.predict_complex(fits.off, pts[1], with_variance)
        return out
    return predict


def wstd(points, weights):
    """|weight|-weighted per-axis standard deviation, at least MIN_LENGTH."""
    w = torch.clamp(torch.abs(weights), min=1e-30)
    mu = (points.T @ w) / torch.sum(w)
    var = (((points - mu) ** 2).T @ w) / torch.sum(w)
    return torch.sqrt(torch.clamp(var, min=MIN_LENGTH ** 2))


def moment(points, rho, active, prev: Params, off_div: float) -> Params:
    """The moment reoptimization: diagonal lengths the weighted cloud std / 2,
    coherence lengths the std of each part over ``off_div`` and magnitudes the
    RMS labels, then each GP's maximum-likelihood magnitude at unit
    magnitude; an inactive element keeps its lengths, magnitude 1."""
    lengths = prev.diag_lengths.clone()
    for d, k in enumerate(DIAG):
        if active[k]:
            lengths[d] = wstd(points[k], rho[k, :, 0]) / 2.0
    off = prev.off.clone()
    if active[1]:
        re, im = rho[1, :, 0], rho[1, :, 1]
        off = torch.cat([(torch.sqrt(torch.mean(re ** 2)) + 1e-30)[None],
                         wstd(points[1], re) / off_div,
                         (torch.sqrt(torch.mean(im ** 2)) + 1e-30)[None],
                         wstd(points[1], im) / off_div, torch.zeros_like(re[:1])])
    one = torch.ones((), dtype=points.dtype, device=points.device)
    mags = torch.stack([GP.magnitude_real(GP.fit_real(one, lengths[d], points[k], rho[k, :, 0]))
                        if active[k] else one for d, k in enumerate(DIAG)])
    off_mag = (GP.magnitude_complex(GP.fit_complex(one, off[0], off[1:3], off[3], off[4:6],
                                                   points[1], rho[1]))
               if active[1] else one)
    return Params(lengths, mags, off, off_mag)


def observe(model: str, mass: float, points, rho, active, fits: Fits) -> dict:
    """The observables of one output: populations by the GP integrals
    (``population_prm``, each surface's share ``population_prm_each``) and by
    the point sums (``population_mci``), energies both ways, the purity by
    the integrals, and <x> of the (0,0) element's points."""
    f64 = dict(dtype=points.dtype, device=points.device)
    zero = torch.zeros((), **f64)
    e_surf, w_sum, ew_sum, prm = [], [], [], []
    for d, k in enumerate(DIAG):
        x, p, w = points[k, :, 0], points[k, :, 1], rho[k, :, 0]
        e = p ** 2 / (2.0 * mass) + PH.energies(model, x)[:, d]
        on = bool(active[k])
        e_surf.append(torch.sum(e * w) / torch.sum(w) if on else zero)
        w_sum.append(torch.sum(w) if on else zero)
        ew_sum.append(torch.sum(e * w) if on else zero)
        prm.append(GP.population_real(fits.diag[d]) if on else zero)
    e_surf, w_sum, prm = torch.stack(e_surf), torch.stack(w_sum), torch.stack(prm)
    purity = sum(GP.purity_real(g) for g in fits.diag if g is not None)
    if fits.off is not None:
        purity = purity + 2.0 * (CP.purity if _coupled(fits.off) else GP.purity_complex)(fits.off)
    pop = torch.sum(prm)
    w0 = rho[0, :, 0]
    return dict(population_prm=pop,
                population_prm_each=prm / torch.clamp(pop, min=1e-30),
                population_mci=w_sum / torch.sum(w_sum),
                energy_prm=torch.sum(prm * e_surf),
                energy_mci=sum(ew_sum) / torch.sum(w_sum),
                purity_prm=purity,
                x_average=torch.sum(points[0, :, 0] * w0) / torch.sum(w0))


def drift_ratios(points, rho, active):
    """Each element's re-selection test over its threshold: the |rho|-weighted
    mean's distance from the cloud's mean, in cloud standard deviations, over
    1/2; an element whose ratio passes 1 is re-selected (0 where inactive)."""
    w = torch.sqrt(rho[..., 0] ** 2 + rho[..., 1] ** 2)
    wsum = torch.sum(w, dim=1)
    com = torch.einsum("knd,kn->kd", points, w) / torch.clamp(wsum[:, None], min=1e-300)
    mean = torch.mean(points, dim=1)
    std = torch.clamp(torch.std(points, dim=1, correction=0), min=1e-10)
    ratio = torch.amax(torch.abs(com - mean) / std, dim=1) / 0.5
    on = torch.tensor(active, device=points.device) & (wsum > 0.0)
    return torch.where(on, ratio, 0.0)


def follow(model: str, mass: float, dt: float, points, rho, active, params: Params,
           ticks: int, cutoff: bool = False, extra=None):
    """``ticks`` ticks from a state just after a fit with ``params``, each
    evolving with the raw means or, with ``cutoff``, the cutoff means (the
    extra cloud ``extra = (points, rho)``, if given, with them).  Returns the
    state after them, the fit of the state one tick before the last
    (:func:`fit` of it), each tick's activation ratios (ticks, 3) and the
    extra cloud after them (None without one)."""
    fits = fit(params, points, rho, active)
    inactive = [k for k in range(3) if not active[k]]
    ratios, before = [], fits
    for _ in range(ticks):
        moved = dist(fits, cutoff)
        new_points, new_rho = EV.evolve(model, mass, dt, points, rho, moved)
        if extra is not None:
            extra = EV.evolve(model, mass, dt, extra[0], extra[1], moved)
        r = torch.zeros(3, dtype=points.dtype, device=points.device)
        if inactive:
            r = EV.small_ratios(model, mass, dt, new_points, active, dist(fits, True))
        ratios.append(torch.where(torch.tensor(active, device=r.device), 0.0, r))
        before, points, rho = fits, new_points, new_rho
        fits = fit(params, points, rho, active)
    return points, rho, before, torch.stack(ratios), extra


def relabel(model: str, mass: float, dt: float, pts, elem: int, fits: Fits,
            cutoff: bool = False):
    """The density of a re-selected element at its new points (M, 2): the
    backward prediction with the raw-mean (or, with ``cutoff``, the cutoff)
    distribution of ``fits``."""
    return EV.backward(model, mass, dt, pts, elem, dist(fits, cutoff))


def written_row(model: str, mass: float, points, rho, active, fits: Fits) -> dict:
    """The fields of a line of ``ave.txt`` the reference computes, by column:
    per active surface its population by the integral, <x> and <p> by the
    integral, population by the point sums, <x> and <p> and energy by the
    point sums; then the totals (population, <x>, <p>, energy by the
    integrals over the population; by the point sums) and the purities (by
    the integrals; by the point sums times 2 pi hbar)."""
    obs = observe(model, mass, points, rho, active, fits)
    f = lambda t: float(t)
    row = {}
    r_tot = torch.zeros(2, dtype=points.dtype, device=points.device)
    for d, k in enumerate(DIAG):
        if not active[k]:
            continue
        g = fits.diag[d]
        w = rho[k, :, 0]
        r_prm = GP.r_average_real(g)
        r_tot = r_tot + r_prm
        r_mci = (points[k].T @ w) / torch.sum(w)
        x, p = points[k, :, 0], points[k, :, 1]
        e = p ** 2 / (2.0 * mass) + PH.energies(model, x)[:, d]
        base = 8 * d
        row.update({base: f(GP.population_real(g)), base + 1: f(r_prm[0]),
                    base + 2: f(r_prm[1]), base + 4: f(obs["population_mci"][d]),
                    base + 5: f(r_mci[0]), base + 6: f(r_mci[1]),
                    base + 7: f(torch.sum(e * w) / torch.sum(w))})
    pop = obs["population_prm"]
    w_all = torch.cat([rho[k, :, 0] for k in DIAG if active[k]])
    p_all = torch.cat([points[k] for k in DIAG if active[k]])
    r_mci_all = (p_all.T @ w_all) / torch.sum(w_all)
    mci_pur = sum(torch.sum(rho[k] ** 2) for k in DIAG if active[k])
    if active[1]:
        mci_pur = mci_pur + 2.0 * torch.sum(rho[1] ** 2)
    row.update({16: f(pop), 17: f(r_tot[0] / pop), 18: f(r_tot[1] / pop),
                19: f(obs["energy_prm"] / pop), 20: 1.0, 21: f(r_mci_all[0]),
                22: f(r_mci_all[1]), 23: f(obs["energy_mci"]), 28: f(obs["purity_prm"]),
                33: f(mci_pur) * 2.0 * math.pi})
    return row
