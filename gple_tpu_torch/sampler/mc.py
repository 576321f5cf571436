"""Initial phase-space distribution (counterpart of :mod:`gple_tpu.sampler.mc`).

Ported so far: :func:`initial_distribution`.  The Metropolis sampler and its
tuning come with the driver.
"""

from __future__ import annotations

import math

import torch

from gple_tpu_torch.utils import ri


def initial_distribution(r0, sigma_r0, pts, row, col, populations, phase_factors):
    """Initial Gaussian phase-space density of element (row, col) at ``pts``
    (M, PhaseDim), returned as an RI tensor (M, 2)."""
    r0 = torch.as_tensor(r0, dtype=pts.dtype, device=pts.device)
    sig = torch.as_tensor(sigma_r0, dtype=pts.dtype, device=pts.device)
    dim = r0.shape[0] // 2
    gauss = torch.exp(-0.5 * torch.sum(((pts - r0) / sig) ** 2, dim=-1)) / (
        (2.0 * math.pi) ** dim * torch.prod(sig)
    )
    pops = torch.as_tensor(populations, dtype=pts.dtype, device=pts.device)
    phases = torch.as_tensor(phase_factors, dtype=pts.dtype, device=pts.device)
    weight = pops[row] * pops[col] / torch.sum(pops**2)
    return ri.phase_mul(ri.ri(gauss * weight), phases[row] - phases[col])
