"""One time step of every sampled point by the backward-branching evolver of
the mixed quantum-classical Liouville equation (the reference code's
``evolve.cpp``): two forward half-step leapfrogs of each point with the
element's mean diagonal force, then the density at the moved point predicted
backwards through three momentum branches of the off-diagonal force, each
branch split towards every target element, with the adiabatic phase and two
off-diagonal rotations by the non-adiabatic coupling; a point's own element
takes its carried value plus the branch differences.  The adiabatic
alternative (one full leapfrog, the old density times the phase) is blended
in by the coupling test, which is true everywhere at the criterion 0.

Densities are (3, N, 2): elements (0,0), (1,0), (1,1), real and imaginary
parts.  ``dist(pts (3, M, 2)) -> (3, M, 2)`` predicts every target element."""

from __future__ import annotations

import torch

from bench_h100.reference import physics as PH

ELEMENTS = ((0, 0), (1, 0), (1, 1))
OFF = 1
BRANCHES = (-1.0, 0.0, 1.0)
FORCE_W = ((2.0, 0.0), (1.0, 1.0), (0.0, 2.0))   # F_ii + F_jj
GAP_W = ((0.0, 0.0), (-1.0, 1.0), (0.0, 0.0))    # E_i - E_j
SMALL_EPS = 1e-10


def _phase(z, theta):
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([z[..., 0] * c - z[..., 1] * s, z[..., 0] * s + z[..., 1] * c], dim=-1)


def _diag_forces(model, x):
    f00, _, f11 = PH.forces(model, x)
    return torch.stack([f00, f11], dim=-1)


def _table(values, like):
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def _leapfrog(model, x, p, mass, dt, sign):
    """Per-source (leading axis 3) leapfrog with force (F_ii + F_jj) / 2 x 2."""
    x = x + sign * dt / 2.0 * p / mass
    f = torch.einsum("sd,s...d->s...", _table(FORCE_W, x), _diag_forces(model, x))
    p = p + sign * dt / 2.0 * f
    return x + sign * dt / 2.0 * p / mass, p


def _leapfrog_pair(model, x, p, mass, dt, sign, i, j):
    x = x + sign * dt / 2.0 * p / mass
    f = _diag_forces(model, x)
    p = p + sign * dt / 2.0 * (f[..., i] + f[..., j])
    return x + sign * dt / 2.0 * p / mass, p


def _omega(model, xa, xb):
    """(E0 - E1)(xa) + (E0 - E1)(xb), over 2 hbar (hbar = 1)."""
    ea, eb = PH.energies(model, xa), PH.energies(model, xb)
    return (ea[..., 0] - ea[..., 1] + eb[..., 0] - eb[..., 1]) / 2.0


def _rotate(model, rho3, x, p, mass, dt):
    """Rotate the triangle (rho00, rho10, rho11), (3, ..., 2), by the coupling
    angle (p / m) d01(x) dt."""
    phi = (p / mass) * PH.coupling01(model, x)
    c, s = torch.cos(2.0 * phi * dt), torch.sin(2.0 * phi * dt)
    r00, r10, r11 = rho3[0], rho3[1], rho3[2]
    hp, hm = (1.0 + c) / 2.0, (1.0 - c) / 2.0
    re10 = r10[..., 0]
    n00 = torch.stack([hp * r00[..., 0] - s * re10 + hm * r11[..., 0],
                       hp * r00[..., 1] + hm * r11[..., 1]], dim=-1)
    n10 = torch.stack([s / 2.0 * r00[..., 0] + c * re10 - s / 2.0 * r11[..., 0],
                       s / 2.0 * r00[..., 1] + r10[..., 1] - s / 2.0 * r11[..., 1]], dim=-1)
    n11 = torch.stack([hm * r00[..., 0] + s * re10 + hp * r11[..., 0],
                       hm * r00[..., 1] + hp * r11[..., 1]], dim=-1)
    return torch.stack([n00, n10, n11])


def _recombine(rot):
    """Branches (3t, ..., 3b, 2) -> (3t, ..., 2)."""
    m, z, p = rot[..., 0, :], rot[..., 1, :], rot[..., 2, :]
    v_m = torch.stack([(m[0, ..., 0] + 2.0 * m[1, ..., 0] + m[2, ..., 0]) / 4.0,
                       (m[0, ..., 1] + m[2, ..., 1]) / 4.0], dim=-1)
    v_z = (z[0] - z[2]) / 2.0
    v_p = torch.stack([(p[0, ..., 0] - 2.0 * p[1, ..., 0] + p[2, ..., 0]) / 4.0,
                       (p[0, ..., 1] + p[2, ..., 1]) / 4.0], dim=-1)
    mid = v_m - v_p
    mid = torch.stack([mid[..., 0], mid[..., 1] + z[1, ..., 1]], dim=-1)
    return torch.stack([v_m + v_z + v_p, mid, v_m - v_z + v_p])


def evolve(model, mass, dt, points, rho, dist):
    """One step of every point of every element: (points, rho) at t + dt."""
    n = points.shape[1]
    x0, p0 = points[..., 0], points[..., 1]
    xa, pa = _leapfrog(model, x0, p0, mass, dt / 2.0, 1.0)
    xb, pb = _leapfrog(model, xa, pa, mass, dt / 2.0, 1.0)
    x2, p1 = _leapfrog(model, xb, pb, mass, dt / 2.0, -1.0)
    f01 = PH.forces(model, x2)[1]
    p2 = p1[..., None] - dt * _table(BRANCHES, x0) * f01[..., None]        # (3s, N, 3b)
    x3 = x2[..., None] - dt / 4.0 * p2 / mass
    p3 = p2[:, None] - dt / 4.0 * torch.einsum(
        "td,snbd->stnb", _table(FORCE_W, x0), _diag_forces(model, x3))    # (3s, 3t, N, 3b)
    x4 = x3[:, None] - dt / 4.0 * p3 / mass
    query = torch.stack([x4.transpose(0, 1), p3.transpose(0, 1)], dim=-1).reshape(3, -1, 2)
    pred = dist(query).reshape(3, 3, n, 3, 2).clone()                     # (3t, 3s, N, 3b, 2)
    for s in range(3):
        pred[s, s] = rho[s][:, None, :] + pred[s, s] - pred[s, s, :, 1:2, :]
    pred[OFF] = _phase(pred[OFF], _omega(model, x2[:, :, None], x4[:, OFF]) * dt / 2.0)
    rot = torch.stack([_rotate(model, pred[:, :, :, b], x2, p2[:, :, b], mass, dt / 2.0)
                       for b in range(3)], dim=3)
    comb = _rotate(model, _recombine(rot), x2, p1, mass, dt / 2.0)         # (3t, 3s, N, 2)
    own = torch.stack([comb[s, s] for s in range(3)])
    e_b, e_2 = PH.energies(model, xb), PH.energies(model, x2)
    gap = _table(GAP_W, x0)
    theta = (torch.einsum("sd,snd->sn", gap, e_b) + torch.einsum("sd,snd->sn", gap, e_2)) / 2.0
    return torch.stack([xb, pb], dim=-1), _phase(own, -theta * dt / 2.0)


def backward(model, mass, dt, pts, elem: int, dist):
    """The density of element ``elem`` at points (M, 2) with no carried value."""
    i, j = ELEMENTS[elem]
    x0, p0 = pts[:, 0], pts[:, 1]
    x2, p1 = _leapfrog_pair(model, x0, p0, mass, dt / 2.0, -1.0, i, j)
    f01 = PH.forces(model, x2)[1]
    p2 = p1[:, None] - dt * _table(BRANCHES, x0)[None, :] * f01[:, None]   # (M, 3b)
    x3 = x2[:, None] - dt / 4.0 * p2 / mass
    fd = _diag_forces(model, x3)
    p3 = torch.stack([p2 - dt / 4.0 * (fd[..., a] + fd[..., b]) for (a, b) in
                      ((0, 0), (0, 1), (1, 1))])                          # (3t, M, 3b)
    x4 = x3[None] - dt / 4.0 * p3 / mass
    pred = dist(torch.stack([x4, p3], dim=-1).reshape(3, -1, 2)).reshape(3, -1, 3, 2).clone()
    pred[OFF] = _phase(pred[OFF], _omega(model, x2[:, None], x4[OFF]) * dt / 2.0)
    rot = torch.stack([_rotate(model, pred[:, :, b], x2, p2[:, b], mass, dt / 2.0)
                       for b in range(3)], dim=2)
    out = _rotate(model, _recombine(rot), x2, p1, mass, dt / 2.0)[elem]
    if i != j:
        out = _phase(out, _omega(model, x0, x2) * dt / 2.0)
    return out


def small_ratios(model, mass, dt, points, active, dist):
    """Each element's largest |rho|^2 over every element's points, over the
    activation threshold: an inactive element whose ratio reaches 1 appears."""
    test = points.reshape(-1, 2)
    return torch.stack([torch.max(torch.sum(backward(model, mass, dt, test, k, dist) ** 2,
                                            dim=-1)) / SMALL_EPS
                        for k in range(3)])
