"""The constrained restart ladder's objective, constraints and optimality
conditions, written again from the reference program's equations
(``opt.cpp:1019-1392``): what the check holds a ladder's result to.

For each active diagonal element the ladder fits a GP at unit magnitude and
noise 1e-2 (:func:`gp.fit_real`) and scores its lengths by the element's
leave-one-out error, sum((alpha_i / [K^-1]_ii)^2), plus its extra-set error,
the squared error of the mean at the element's extra points, both in rescaled
label units.  The averages are the GP integrals summed over the active
elements: population, energy (each element's population times its surface's
point-sum energy) and purity.  The constraints are the averages' relative
violations of their targets, (average - target) / max(|target|, 1e-3), with
the targets 1, E0 (the initial point-sum energy of the populated surfaces)
and P0 = 1 (the initial state is a pure wave packet).  The lengths are
optimized in sigmoid coordinates z inside per-axis bounds,
l = lb + (ub - lb) sigmoid(z), so a gradient in z is the gradient in l times
(l - lb) (ub - l) / (ub - lb).

With the coherence active the ladder's last pass is the full pass: the
coherence's parameters (m_R, l_R, m_I, l_I) join the lengths, its coupled
fit at unit magnitude (:mod:`.coupled`, corr = 1: the reference kernel,
whose zero-width box gives it no coordinate) adds its leave-one-out and
extra-set errors to the loss and twice its purity integral to the purity.
Its magnitudes lie in [0.1, 10] (opt.cpp:86-87), its lengths in the bounds
of the coherence's cloud."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from bench_h100.reference import coupled as CP
from bench_h100.reference import gp as GP
from bench_h100.reference import physics as PH

DIAG = (0, 2)
#: relative tolerance of the averages' acceptance rule (opt.h:13)
TOLERANCE = 0.05
#: floor of the lengths and of a cloud's standard deviation (opt.cpp:397)
MIN_LENGTH = 1.0 / 100.0
#: floor of a constraint's scale
CONS_FLOOR = 1e-3
#: floor of the KKT residual's scale
KKT_FLOOR = 1e-12
#: bounds of the coherence's sub-kernel magnitudes (opt.cpp:86-87)
COH_MAG_BOUNDS = (0.1, 10.0)
#: the reference kernel's correlation of the coherence's real and imaginary parts
CORR = 1.0


class Problem(NamedTuple):
    """One ladder's data: for each active diagonal element (``surfaces``, 0 or
    1) its points (N, D), real labels (N,), extra points (M, D) and labels
    (M,), its surface's energy, and its length bounds (D,); with the
    coherence active its points (N, D), RI labels (N, 2), extra points and
    labels, and the bounds of its free parameters (2 D + 2,), else None."""

    surfaces: tuple
    x: list
    y: list
    xe: list
    ye: list
    energies: torch.Tensor
    lb: torch.Tensor           # (k, D)
    ub: torch.Tensor           # (k, D)
    targets: torch.Tensor      # (3,) population, energy, purity
    xo: torch.Tensor = None
    yo: torch.Tensor = None
    xoe: torch.Tensor = None
    yoe: torch.Tensor = None
    olb: torch.Tensor = None   # (2 D + 2,) m_R, l_R, m_I, l_I
    oub: torch.Tensor = None


def surface_energy(model: str, mass: float, points, labels, surface: int):
    """The label-weighted mean of p^2 / 2m + E_surface(x) over an element's points."""
    e = points[:, 1] ** 2 / (2.0 * mass) + PH.energies(model, points[:, 0])[:, surface]
    return torch.sum(e * labels) / torch.sum(labels)


def length_bounds(points):
    """(lower, upper) bounds of the lengths from a cloud (N, D): its standard
    deviation s (at least MIN_LENGTH) over sqrt(N), at least MIN_LENGTH, and 2 s."""
    n = points.shape[0]
    mean = torch.mean(points, dim=0)
    std = torch.sqrt(torch.clamp(torch.mean(points ** 2, dim=0) - mean ** 2, min=0.0))
    std = torch.clamp(std, min=MIN_LENGTH)
    return torch.clamp(std / math.sqrt(n), min=MIN_LENGTH), 2.0 * std


def targets(model: str, mass: float, populations, points, rho):
    """(1, E0, P0) from the state at tick 0: E0 the populations' squares
    weighting each populated surface's point-sum energy, P0 = 1."""
    w = torch.tensor([p * p for p in populations], dtype=points.dtype, device=points.device)
    e = torch.stack([surface_energy(model, mass, points[k], rho[k, :, 0], d)
                     if populations[d] > 0 else torch.zeros((), dtype=points.dtype,
                                                            device=points.device)
                     for d, k in enumerate(DIAG)])
    one = torch.ones((), dtype=points.dtype, device=points.device)
    return torch.stack([one, torch.sum(w * e) / torch.sum(w), one])


def problem(model: str, mass: float, points, rho, active, extra_points, extra_rho,
            goal) -> Problem:
    surfaces = tuple(d for d, k in enumerate(DIAG) if active[k])
    if not surfaces:
        raise ValueError("a ladder needs an active diagonal element")
    ks = [DIAG[d] for d in surfaces]
    # copies: autograd cannot save a program's inference-mode tensors
    points, rho = points.clone(), rho.clone()
    extra_points, extra_rho = extra_points.clone(), extra_rho.clone()
    bounds = [length_bounds(points[k]) for k in ks]
    coherence = {}
    if active[1]:
        lb, ub = length_bounds(points[1])
        mag = lambda v: torch.full((1,), v, dtype=lb.dtype, device=lb.device)
        lo, hi = COH_MAG_BOUNDS
        coherence = dict(xo=points[1], yo=rho[1], xoe=extra_points[1], yoe=extra_rho[1],
                         olb=torch.cat([mag(lo), lb, mag(lo), lb]),
                         oub=torch.cat([mag(hi), ub, mag(hi), ub]))
    return Problem(
        surfaces=surfaces, x=[points[k] for k in ks], y=[rho[k, :, 0] for k in ks],
        xe=[extra_points[k] for k in ks], ye=[extra_rho[k, :, 0] for k in ks],
        energies=torch.stack([surface_energy(model, mass, points[k], rho[k, :, 0], d)
                              for d, k in zip(surfaces, ks)]),
        lb=torch.stack([b[0] for b in bounds]), ub=torch.stack([b[1] for b in bounds]),
        targets=goal, **coherence)


def _extra_error(g: GP.RealGP, xe, ye):
    """Squared error of the unit-magnitude mean at the extra points, rescaled units."""
    err = torch.zeros((), dtype=xe.dtype, device=xe.device)
    for xb, yb in zip(torch.split(xe, GP.BLOCK), torch.split(ye, GP.BLOCK)):
        mean = GP.unit_gram(g.lengths, xb, g.x) @ g.alpha
        err = err + torch.sum((mean - yb * g.rescale) ** 2)
    return err


def coherence_fit(off, prob: Problem) -> CP.CoupledGP:
    """The coherence's coupled fit at unit magnitude at its parameters ``off``
    (m_R, l_R, m_I, l_I; a correlation after them is not read: corr = 1)."""
    one = torch.ones((), dtype=off.dtype, device=off.device)
    free = off[:prob.olb.shape[0]]
    return CP.fit(one, torch.cat([free, one[None] * CORR]), prob.xo, prob.yo)


def evaluate(lengths, prob: Problem, off=None):
    """(loss, averages (3,)) at the active elements' lengths (k, D) and, with
    the coherence active, its parameters ``off``: the full pass's."""
    one = torch.ones((), dtype=lengths.dtype, device=lengths.device)
    fits = [GP.fit_real(one, lengths[i], x, y) for i, (x, y) in enumerate(zip(prob.x, prob.y))]
    loss = sum(torch.sum((g.alpha / torch.diagonal(g.kinv)) ** 2)
               + _extra_error(g, xe, ye) for g, xe, ye in zip(fits, prob.xe, prob.ye))
    pops = torch.stack([GP.population_real(g) for g in fits])
    purity = sum(GP.purity_real(g) for g in fits)
    if prob.xo is not None:
        g = coherence_fit(off, prob)
        loss = loss + CP.loocv(g) + CP.extra_error(g, prob.xoe, prob.yoe)
        purity = purity + 2.0 * CP.purity(g)
    return loss, torch.stack([torch.sum(pops), torch.sum(pops * prob.energies), purity])


def constraints(averages, prob: Problem):
    """The relative violations (average - target) / max(|target|, CONS_FLOOR)."""
    return (averages - prob.targets) / torch.clamp(torch.abs(prob.targets), min=CONS_FLOOR)


def violations(averages, prob: Problem):
    """|average / target - 1|, the acceptance rule's reading."""
    return torch.abs(averages / prob.targets - 1.0)


def magnitudes(lengths, xs, ys):
    """The analytic magnitudes sqrt(|y . alpha| / N) of the unit-magnitude fits
    of the points ``xs`` and labels ``ys`` of each element at its lengths."""
    one = torch.ones((), dtype=lengths.dtype, device=lengths.device)
    return torch.stack([GP.magnitude_real(GP.fit_real(one, lengths[i], x, y))
                        for i, (x, y) in enumerate(zip(xs, ys))])


def gradients(lengths, lam, prob: Problem, off=None):
    """(grad f, sum_i lam_i grad c_i) in the sigmoid coordinates by autograd
    through the plain fits: at the lengths alone, each (k, D); with the
    coherence active at the lengths and its parameters ``off``, each the
    flat (k D + 2 D + 2,) of the full pass."""
    sig = lambda v, lb, ub: (v - lb) * (ub - v) / (ub - lb)
    with torch.enable_grad():
        at = [lengths.detach().clone().requires_grad_(True)]
        if prob.xo is not None:
            at.append(off[:prob.olb.shape[0]].detach().clone().requires_grad_(True))
        loss, averages = evaluate(at[0], prob, at[1] if len(at) > 1 else None)
        cons = constraints(averages, prob)
        g_f = torch.autograd.grad(loss, at, retain_graph=True)
        g_c = [torch.zeros_like(g) for g in g_f]
        for i in range(lam.shape[0]):
            g_i = torch.autograd.grad(cons[i], at, retain_graph=True)
            g_c = [g + lam[i] * gi for g, gi in zip(g_c, g_i)]
    jac = [sig(at[0].detach(), prob.lb, prob.ub)]
    if prob.xo is None:
        return g_f[0] * jac[0], g_c[0] * jac[0]
    jac.append(sig(at[1].detach(), prob.olb, prob.oub))
    flat = lambda gs: torch.cat([(g * j).reshape(-1) for g, j in zip(gs, jac)])
    return flat(g_f), flat(g_c)


def kkt(lengths, lam, prob: Problem, off=None):
    """The stationarity of loss + lam . c at a result with multipliers
    ``lam``: |grad f + sum_i lam_i grad c_i| over max(|grad f|,
    |sum_i lam_i grad c_i|, KKT_FLOOR), in the sigmoid coordinates."""
    g_f, g_c = gradients(lengths, lam, prob, off)
    norm = lambda g: float(torch.linalg.norm(g.reshape(-1)))
    return norm(g_f + g_c) / max(norm(g_f), norm(g_c), KKT_FLOOR)
