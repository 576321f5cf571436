"""Tully scattering models and basis transforms, batched in PyTorch.

Counterpart of :mod:`gple_tpu.models.tully`, function for function: the three
one-dimensional two-surface scattering models (SAC, DAC, ECR), their analytic
derivatives, the closed-form 2x2 diabatic -> adiabatic transform, the
non-adiabatic coupling, and the Manolopoulos absorbing potential.

All functions accept arbitrarily-batched scalar positions ``x`` of shape
``(...,)`` and return tensors with trailing quantum axes ``(..., 2, 2)`` /
``(..., 2)``.  Python numbers are taken as float64.
"""

from __future__ import annotations

import math

import torch

from gple_tpu_torch.utils.constants import HBAR, PLANCK_H

# -- model constants (Tully, J. Chem. Phys. 93, 1061 (1990)) ------------------
SAC_A, SAC_B, SAC_C, SAC_D = 0.01, 1.6, 0.005, 1.0
DAC_A, DAC_B, DAC_C, DAC_D, DAC_E = 0.10, 0.28, 0.015, 0.06, 0.05
ECR_A, ECR_B, ECR_C = 6e-4, 0.10, 0.90

MODELS = ("SAC", "DAC", "ECR")


def _as_tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x, dtype=torch.float64)


def _pack22(v00, v01, v11):
    """Stack batched scalars into a symmetric (..., 2, 2) matrix."""
    row0 = torch.stack([v00, v01], dim=-1)
    row1 = torch.stack([v01, v11], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def diabatic_potential(model: str, x):
    """Diabatic potential matrix V(x), shape ``(..., 2, 2)``."""
    x = _as_tensor(x)
    s = torch.sign(x)
    if model == "SAC":
        v00 = s * SAC_A * (1.0 - torch.exp(-s * SAC_B * x))
        v11 = -v00
        v01 = SAC_C * torch.exp(-SAC_D * x * x)
    elif model == "DAC":
        v00 = torch.zeros_like(x)
        v11 = DAC_E - DAC_A * torch.exp(-DAC_B * x * x)
        v01 = DAC_C * torch.exp(-DAC_D * x * x)
    elif model == "ECR":
        v00 = torch.full_like(x, ECR_A)
        v11 = torch.full_like(x, -ECR_A)
        v01 = ECR_B * (1.0 - s * (torch.exp(-s * ECR_C * x) - 1.0))
    else:
        raise ValueError(f"unknown model {model!r}; expected one of {MODELS}")
    return _pack22(v00, v01, v11)


def diabatic_force(model: str, x):
    """Diabatic force matrix F(x) = -dV/dx, shape ``(..., 2, 2)``."""
    x = _as_tensor(x)
    s = torch.sign(x)
    if model == "SAC":
        f00 = -SAC_A * SAC_B * torch.exp(-s * SAC_B * x)
        f11 = -f00
        f01 = 2.0 * SAC_C * SAC_D * x * torch.exp(-SAC_D * x * x)
    elif model == "DAC":
        f00 = torch.zeros_like(x)
        f11 = -2.0 * DAC_A * DAC_B * x * torch.exp(-DAC_B * x * x)
        f01 = 2.0 * DAC_C * DAC_D * x * torch.exp(-DAC_D * x * x)
    elif model == "ECR":
        f00 = torch.zeros_like(x)
        f11 = torch.zeros_like(x)
        f01 = -ECR_B * ECR_C * torch.exp(-s * ECR_C * x)
    else:
        raise ValueError(f"unknown model {model!r}; expected one of {MODELS}")
    return _pack22(f00, f01, f11)


def diabatic_hesse(model: str, x):
    """Diabatic Hessian d2V/dx2 = -dF/dx, shape ``(..., 2, 2)``."""
    x = _as_tensor(x)
    s = torch.sign(x)
    if model == "SAC":
        h00 = -s * SAC_A * SAC_B * SAC_B * torch.exp(-s * SAC_B * x)
        h11 = -h00
        h01 = 2.0 * SAC_C * SAC_D * (2.0 * SAC_D * x * x - 1.0) * torch.exp(-SAC_D * x * x)
    elif model == "DAC":
        h00 = torch.zeros_like(x)
        h11 = -2.0 * DAC_A * DAC_B * (2.0 * DAC_B * x * x - 1.0) * torch.exp(-DAC_B * x * x)
        h01 = 2.0 * DAC_C * DAC_D * (2.0 * DAC_D * x * x - 1.0) * torch.exp(-DAC_D * x * x)
    elif model == "ECR":
        h00 = torch.zeros_like(x)
        h11 = torch.zeros_like(x)
        h01 = -s * ECR_B * ECR_C * ECR_C * torch.exp(-s * ECR_C * x)
    else:
        raise ValueError(f"unknown model {model!r}; expected one of {MODELS}")
    return _pack22(h00, h01, h11)


# -- adiabatic representation (closed form for 2 surfaces) ---------------------

def _gap(v):
    """sqrt((V00-V11)^2 + 4 V01^2): the adiabatic energy gap."""
    return torch.sqrt((v[..., 0, 0] - v[..., 1, 1]) ** 2 + 4.0 * v[..., 0, 1] ** 2)


def adiabatic_potential(model: str, x):
    """Adiabatic energies (E0, E1) sorted ascending, shape ``(..., 2)``."""
    v = diabatic_potential(model, x)
    mean = 0.5 * (v[..., 0, 0] + v[..., 1, 1])
    half_gap = 0.5 * _gap(v)
    return torch.stack([mean - half_gap, mean + half_gap], dim=-1)


def adiabatic_transform(model: str, x):
    """Orthogonal C(x) with C^T V_dia C = diag(E0, E1), shape ``(..., 2, 2)``:
    the half-angle rotation of :func:`sym2x2_eigh`, stable where the
    Gaussian coupling V01 underflows far from the crossing."""
    _, c = sym2x2_eigh(diabatic_potential(model, x))
    return c


def adiabatic_force(model: str, x):
    """Adiabatic force matrix C^T F_dia C, shape ``(..., 2, 2)``."""
    c = adiabatic_transform(model, x)
    f = diabatic_force(model, x)
    return c.transpose(-1, -2) @ f @ c


#: representation bases of the reference's 3x3 transform table
BASES = ("diabatic", "adiabatic", "force")


def basis_matrix(model: str, x, basis: str):
    """Orthogonal ``C(x)`` whose columns express the ``basis`` states in the
    diabatic frame, shape ``(..., 2, 2)``."""
    if basis == "diabatic":
        x = _as_tensor(x)
        eye = torch.eye(2, dtype=x.dtype, device=x.device)
        return eye.expand(x.shape + (2, 2))
    if basis == "adiabatic":
        return adiabatic_transform(model, x)
    if basis == "force":
        _, c = sym2x2_eigh(diabatic_force(model, x))
        return c
    raise ValueError(f"unknown basis {basis!r}; expected one of {BASES}")


def basis_transform(model: str, x, rho, frm: str, to: str):
    """Transform a 2x2 density/operator matrix field between two bases:
    ``rho_to = M rho_frm M^T`` with ``M = C_to^T C_frm`` (see
    :func:`gple_tpu.models.tully.basis_transform`).  ``x`` must broadcast
    against ``rho[..., 0, 0]``; ``rho`` may be real or complex."""
    if frm == to:
        return rho
    c_frm = basis_matrix(model, x, frm)
    c_to = basis_matrix(model, x, to)
    m = (c_to.transpose(-1, -2) @ c_frm).to(rho.dtype)
    return torch.einsum("...ab,...bc,...dc->...ad", m, rho, m)


def adiabatic_coupling(model: str, x):
    """First-order non-adiabatic coupling d_jk = F_adia[j,k] / (E_j - E_k).

    Antisymmetric with zero diagonal, shape ``(..., 2, 2)``.
    """
    e = adiabatic_potential(model, x)
    f = adiabatic_force(model, x)
    d10 = f[..., 1, 0] / (e[..., 1] - e[..., 0])
    zero = torch.zeros_like(d10)
    row0 = torch.stack([zero, -d10], dim=-1)
    row1 = torch.stack([d10, zero], dim=-1)
    return torch.stack([row0, row1], dim=-2)


# -- absorbing potential -------------------------------------------------------

def _agm(a: float, b: float, iters: int = 12) -> float:
    for _ in range(iters):
        a, b = 0.5 * (a + b), math.sqrt(a * b)
    return a


#: c = sqrt(2) * K(1/sqrt(2)), K the complete elliptic integral of the 1st kind
#: (Manolopoulos, J. Chem. Phys. 120, 2247 (2004)).
MANOLOPOULOS_C: float = math.sqrt(2.0) * math.pi / (2.0 * _agm(1.0, math.sqrt(0.5)))


def absorbing_potential(mass: float, xmin, xmax, absorb_length, x):
    """Manolopoulos transmission-free absorbing potential E(x), shape ``(...,)``:
    zero inside (xmin, xmax), E(x) = (h/L)^2 (2/m) [1/(c-u)^2 + 1/(c+u)^2 -
    2/c^2] with u = c (x - edge) / L in the skirts."""
    x = _as_tensor(x)
    c = MANOLOPOULOS_C
    edge = torch.where(x <= xmin, x - xmin, x - xmax)
    u = c * edge / absorb_length
    # clamp |u| away from c to avoid inf inside the masked-out region
    u = torch.clamp(u, -c * (1.0 - 1e-12), c * (1.0 - 1e-12))
    val = (PLANCK_H / absorb_length) ** 2 * (2.0 / mass) * (
        1.0 / (c - u) ** 2 + 1.0 / (c + u) ** 2 - 2.0 / c ** 2
    )
    inside = (x > xmin) & (x < xmax)
    return torch.where(inside, 0.0, val)


# -- generic symmetric 2x2 eigendecomposition ----------------------------------

def sym2x2_eigh(a):
    """Closed-form eigendecomposition of symmetric ``(..., 2, 2)`` matrices:
    eigenvalues ascending, orthonormal eigenvector columns, stable in the
    b -> 0 limit (half-angle rotation rather than ratio forms)."""
    a00, a01, a11 = a[..., 0, 0], a[..., 0, 1], a[..., 1, 1]
    mean = 0.5 * (a00 + a11)
    half_diff = 0.5 * (a00 - a11)
    r = torch.hypot(half_diff, a01)
    w = torch.stack([mean - r, mean + r], dim=-1)
    theta = 0.5 * torch.atan2(2.0 * a01, a00 - a11)
    cth, sth = torch.cos(theta), torch.sin(theta)
    # v_plus = [cth, sth] is the eigenvector of mean + r; v_minus = [-sth, cth]
    col_minus = torch.stack([-sth, cth], dim=-1)
    col_plus = torch.stack([cth, sth], dim=-1)
    v = torch.stack([col_minus, col_plus], dim=-1)  # columns ascending
    return w, v


def kinetic_energy(mass, p):
    """Classical kinetic energy p^2 / (2 m) summed over classical dimensions."""
    p = _as_tensor(p)
    return torch.sum(p * p / (2.0 * mass), dim=-1)


def hbar() -> float:
    return HBAR
