"""Monte-Carlo-estimate observables over sampled phase-space points.

Counterpart of :mod:`gple_tpu.observables`: population, <r>, energy and
purity as point sums (the reference's ``predict.cpp:65-244``), the second
estimator beside the analytic GP integrals of :mod:`gple_tpu_torch.storage`.
Every function stays on the tensors' device; :func:`observe_all` returns one
dict of tensors, which the driver pulls to the host once per output.
"""

from __future__ import annotations

import torch

from gple_tpu_torch.models import tully
from gple_tpu_torch.storage import DIAG_INDICES, OFFDIAG_INDEX, Density
from gple_tpu_torch.utils import ri

_DIAG = list(DIAG_INDICES)


def population_each_surface(density: Density):
    """Normalized per-surface populations (predict.cpp:65-87)."""
    sums = torch.sum(density.rho[_DIAG, :, 0], dim=1)
    sums = torch.where(density.active[_DIAG], sums, 0.0)
    return sums / torch.sum(sums)


def r_average_one_element(points, rho):
    """<r> over one element's points, population-weighted (predict.cpp:89-107)."""
    w = rho[..., 0]
    return (points.T @ w) / torch.sum(w)


def standard_deviation_one_element(points):
    """Per-dimension std dev of the point cloud (predict.cpp:109-126)."""
    mean = torch.mean(points, dim=0)
    mean_sq = torch.mean(points**2, dim=0)
    return torch.sqrt(torch.clamp(mean_sq - mean**2, min=0.0))


def r_average_all_surfaces(density: Density):
    w = density.rho[_DIAG, :, 0]
    w = torch.where(density.active[_DIAG][:, None], w, 0.0)
    num = torch.einsum("end,en->d", density.points[_DIAG], w)
    return num / torch.sum(w)


def _surface_energy_terms(model: str, density: Density, mass):
    """(e (2, N), w (2, N)): per-point total energy on each surface and the
    point's population weight."""
    pts = density.points[_DIAG]
    v = tully.adiabatic_potential(model, pts[..., 0])               # (2, N, 2)
    pot = torch.stack([v[0, :, 0], v[1, :, 1]])
    e = pts[..., 1] ** 2 / (2.0 * mass) + pot
    return e, density.rho[_DIAG, :, 0]


def total_energy_each_surface(model: str, density: Density, mass):
    """Population-weighted mean total energy per surface (predict.cpp:157-190)."""
    e, w = _surface_energy_terms(model, density, mass)
    energies = torch.sum(e * w, dim=1) / torch.sum(w, dim=1)
    return torch.where(density.active[_DIAG], energies, 0.0)


def total_energy_all_surfaces(model: str, density: Density, mass):
    """Single population-weighted energy over all surfaces (predict.cpp:192-220)."""
    e, w = _surface_energy_terms(model, density, mass)
    w = torch.where(density.active[_DIAG][:, None], w, 0.0)
    return torch.sum(e * w) / torch.sum(w)


def observe_all(model: str, density: Density, gps, mass):
    """Every per-output observable (the quantities the reference writes per
    output, output.cpp:41-118), as one dict of tensors on the device."""
    energies = total_energy_each_surface(model, density, mass)
    return dict(
        energies=energies,
        ppl_mci=population_each_surface(density),
        ppl_prm_each=gps.population_each(),
        pop_prm=gps.population(),
        energy_prm=gps.total_energy(energies),
        energy_mci=total_energy_all_surfaces(model, density, mass),
        purity_prm=gps.purity(),
        purity_mci_raw=torch.sum(purity_each_element(density)),
        x_average=r_average_one_element(density.points[0], density.rho[0])[0],
    )


def purity_each_element(density: Density):
    """Sum |rho|^2 per element, as a (2, 2) matrix with the off-diagonal value
    mirrored (predict.cpp:222-244); ``.sum()`` of this matrix therefore counts
    the off-diagonal twice like the reference."""
    sums = torch.sum(ri.abs2(density.rho), dim=1)
    sums = torch.where(density.active, sums, 0.0)
    return torch.stack([sums[[0, OFFDIAG_INDEX]], sums[[OFFDIAG_INDEX, 2]]])
