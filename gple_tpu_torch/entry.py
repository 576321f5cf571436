"""Example state of the flagship workload (counterpart of ``__graft_entry__``).

:func:`example_state` builds the state that ``__graft_entry__._example_state``
builds: a Tully-A Gaussian cloud at r0 = (-10, 30) with widths (1/3, 1.5)
sampled once and shared by all three elements, the initial density on it,
and the block-diagonal GP fit.  :func:`example_extra` builds the driver's
extra cloud (5N points per element) the same way.

Random points are drawn on the CPU from ``generator`` and then moved to
``device``, so one seed gives the same state on every device.  ``pts0``
replaces the draw (the tests pass the JAX package's points).
"""

from __future__ import annotations

import torch

from gple_tpu_torch.ops import complex_kernels as CK
from gple_tpu_torch.ops import kernels as RK
from gple_tpu_torch.sampler import mc
from gple_tpu_torch.storage import Density, fit_gp_states

R0 = (-10.0, 30.0)
SIGMA = (1.0 / 3.0, 1.5)


def _cloud(n_points: int, device, generator, pts0) -> Density:
    r0 = torch.tensor(R0, dtype=torch.float64, device=device)
    sigma = torch.tensor(SIGMA, dtype=torch.float64, device=device)
    if pts0 is None:
        draw = torch.randn((n_points, 2), generator=generator, dtype=torch.float64)
        pts0 = r0 + draw.to(device) * sigma
    elif isinstance(pts0, torch.Tensor):
        pts0 = pts0.to(device=device, dtype=torch.float64)
    else:
        pts0 = torch.tensor(pts0, dtype=torch.float64, device=device)
    rho0 = mc.initial_distribution(r0, sigma, pts0, 0, 0, (1.0, 0.0), (0.0, 0.0))
    small = 1e-3 * rho0
    off = torch.stack([torch.zeros_like(small[:, 0]), small[:, 0]], dim=-1)  # imaginary
    return Density(
        points=torch.stack([pts0, pts0, pts0]),
        rho=torch.stack([rho0, off, small]),
        active=torch.ones(3, dtype=torch.bool, device=device),
    )


def example_params(device):
    """The example's (diagonal KernelParams (batched over 2), ComplexKernelParams)."""
    def f64(v):
        return torch.as_tensor(v, dtype=torch.float64, device=device)

    sigma = f64(SIGMA)
    diag_params = RK.KernelParams(
        magnitude=f64([1.0, 1.0]), lengths=sigma.expand(2, 2).clone(),
        noise=f64([1e-2, 1e-2]),
    )
    off_params = CK.ComplexKernelParams(
        magnitude=f64(1.0), real_magnitude=f64(1.0), real_lengths=sigma.clone(),
        imag_magnitude=f64(1.0), imag_lengths=sigma.clone(), noise=f64(1e-2),
        # corr = 0 is the production (moment-optimizer) structure that the
        # block-diagonal fit requires
        corr=f64(0.0),
    )
    return diag_params, off_params


def example_state(n_points: int, device, generator=None, pts0=None):
    """(Density, GPStates) of the flagship Tully-A example with ``n_points``
    points per element, on ``device``."""
    density = _cloud(n_points, device, generator, pts0)
    diag_params, off_params = example_params(device)
    with torch.inference_mode():
        gps = fit_gp_states(diag_params, off_params, density, block_diag=True)
    return density, gps


def example_extra(n_extra: int, device, generator=None, pts0=None) -> Density:
    """An extra cloud of ``n_extra`` points per element (the driver uses 5N),
    built like :func:`example_state`'s density."""
    return _cloud(n_extra, device, generator, pts0)
