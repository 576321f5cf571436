"""Tully's three one-dimensional two-surface models (Tully, J. Chem. Phys. 93,
1061 (1990)) in the adiabatic representation: energies, forces and the
non-adiabatic coupling, batched over positions of any shape."""

from __future__ import annotations

import torch

SAC = (0.01, 1.6, 0.005, 1.0)
DAC = (0.10, 0.28, 0.015, 0.06, 0.05)
ECR = (6e-4, 0.10, 0.90)


def diabatic(model: str, x):
    """(V00, V01, V11) and (F00, F01, F11) = -dV/dx at ``x``."""
    s = torch.sign(x)
    if model == "SAC":
        a, b, c, d = SAC
        v00 = s * a * (1.0 - torch.exp(-s * b * x))
        v01 = c * torch.exp(-d * x * x)
        f00 = -a * b * torch.exp(-s * b * x)
        f01 = 2.0 * c * d * x * torch.exp(-d * x * x)
        return (v00, v01, -v00), (f00, f01, -f00)
    if model == "DAC":
        a, b, c, d, e = DAC
        zero = torch.zeros_like(x)
        v11 = e - a * torch.exp(-b * x * x)
        v01 = c * torch.exp(-d * x * x)
        f11 = -2.0 * a * b * x * torch.exp(-b * x * x)
        f01 = 2.0 * c * d * x * torch.exp(-d * x * x)
        return (zero, v01, v11), (zero, f01, f11)
    if model == "ECR":
        a, b, c = ECR
        v01 = b * (1.0 - s * (torch.exp(-s * c * x) - 1.0))
        f01 = -b * c * torch.exp(-s * c * x)
        zero = torch.zeros_like(x)
        return (torch.full_like(x, a), v01, torch.full_like(x, -a)), (zero, f01, zero)
    raise ValueError(f"unknown model {model!r}")


def _rotation(v00, v01, v11):
    """cos and sin of the half-angle rotation that diagonalizes the symmetric
    2x2 matrix, eigenvalues ascending (stable where v01 underflows)."""
    theta = 0.5 * torch.atan2(2.0 * v01, v00 - v11)
    return torch.cos(theta), torch.sin(theta)


def energies(model: str, x):
    """Adiabatic energies (E0, E1), (..., 2)."""
    (v00, v01, v11), _ = diabatic(model, x)
    mean = 0.5 * (v00 + v11)
    r = torch.hypot(0.5 * (v00 - v11), v01)
    return torch.stack([mean - r, mean + r], dim=-1)


def forces(model: str, x):
    """Adiabatic force matrix C^T F C as (F00, F01, F11); the columns of C are
    the ascending eigenvectors (-sin, cos) and (cos, sin)."""
    (v00, v01, v11), (f00, f01, f11) = diabatic(model, x)
    c, s = _rotation(v00, v01, v11)
    # u = (-s, c), w = (c, s): F_uu, F_uw, F_ww
    fuu = s * s * f00 - 2.0 * s * c * f01 + c * c * f11
    fww = c * c * f00 + 2.0 * s * c * f01 + s * s * f11
    fuw = -s * c * f00 + (c * c - s * s) * f01 + s * c * f11
    return fuu, fuw, fww


def coupling01(model: str, x):
    """d01 = -F10 / (E1 - E0)."""
    e = energies(model, x)
    _, f01, _ = forces(model, x)
    return -f01 / (e[..., 1] - e[..., 0])
