"""MQCLE trajectory dynamics: the backward-branching evolver, in PyTorch.

Counterpart of :mod:`gple_tpu.dynamics.evolve`, function for function:

* coupling-region test, adiabatic leapfrogs, phase factor omega0
* the 17-step backward-branching non-adiabatic density prediction
* the forward evolve of all points (:func:`evolve_step`)
* new-point prediction and the is-very-small activation test

All points of all three source elements advance together, and their 3x3
branch queries plus the adiabatic old-coordinate queries collapse into ONE
batched GP prediction of 10N points per target element.  Both the adiabatic
and the non-adiabatic paths are computed and blended by the coupling mask.

Distribution access follows the ``dist_fn(dist_params, pts (3, M, PhaseDim))
-> (3, M, 2)`` RI convention, one row per lower-triangular element.  The
weight tables are built on the device and in the dtype of the points.
"""

from __future__ import annotations

import torch

from gple_tpu_torch.models import tully
from gple_tpu_torch.storage import ELEMENTS, NUM_ELEMENTS, OFFDIAG_INDEX, Density
from gple_tpu_torch.utils import ri
from gple_tpu_torch.utils.constants import HBAR

#: off-diagonal-force branches
BRANCHES = (-1.0, 0.0, 1.0)
#: element considered absent when all test predictions have |rho|^2 below this
VERY_SMALL_EPSILON = 1e-10
#: per-element diagonal-force weights: F_ii + F_jj = sum_d W[e, d] F_dd
_FORCE_WEIGHTS = ((2.0, 0.0), (1.0, 1.0), (0.0, 2.0))
#: per-element energy-gap weights: E_i - E_j = sum_d G[e, d] E_d
_GAP_WEIGHTS = ((0.0, 0.0), (-1.0, 1.0), (0.0, 0.0))


def _table(values, like):
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def is_coupling(model: str, x, p, mass, dt, criterion: float = 0.0):
    """Coupling test: strong NAC motion or large off-diagonal force relative to
    the mean diagonal force.  With criterion 0 this is identically True."""
    f = tully.adiabatic_force(model, x)
    d = tully.adiabatic_coupling(model, x)
    f_diag_avg = 0.5 * (f[..., 0, 0] + f[..., 1, 1])
    nac_term = torch.abs(d[..., 0, 1] * p / mass) * dt >= criterion
    force_term = torch.abs(f[..., 0, 1] / f_diag_avg) >= criterion
    return nac_term | force_term


def _diag_force_sum(model: str, x, i: int, j: int):
    f = tully.adiabatic_force(model, x)
    return f[..., i, i] + f[..., j, j]


def adiabatic_leapfrog(model: str, x, p, mass, dt, drc: int, i: int, j: int):
    """Leapfrog x(dt/2) -> p(dt) -> x(dt/2) with force (F_ii + F_jj)/2;
    ``drc`` is +1 forward, -1 backward."""
    s = float(drc)
    x = x + s * dt / 2.0 * p / mass
    p = p + s * dt / 2.0 * _diag_force_sum(model, x, i, j)
    x = x + s * dt / 2.0 * p / mass
    return x, p


def omega0(model: str, xa, xb, i: int, j: int):
    """(dV_ij(xa) + dV_ij(xb)) / (2 hbar) with forward sign."""
    if i == j:
        return torch.zeros_like(xa)
    ea = tully.adiabatic_potential(model, xa)
    eb = tully.adiabatic_potential(model, xb)
    return (ea[..., i] - ea[..., j] + eb[..., i] - eb[..., j]) / (2.0 * HBAR)


def _offdiagonal_rotation(model, rho3, x, p, mass, dt, criterion):
    """Rotate the triangular 3-vector (rho00, rho10, rho11) by the coupling
    angle phi = (p/m) d01(x).  ``rho3`` is (3, ..., 2) RI."""
    couple = is_coupling(model, x, p, mass, dt, criterion)
    d01 = tully.adiabatic_coupling(model, x)[..., 0, 1]
    phi = (p / mass) * d01 * couple
    c = torch.cos(2.0 * phi * dt)
    s = torch.sin(2.0 * phi * dt)
    r00, r10, r11 = rho3[0], rho3[1], rho3[2]
    re10 = r10[..., 0]
    half_p = (1.0 + c) / 2.0
    half_m = (1.0 - c) / 2.0
    new00 = torch.stack(
        [
            half_p * r00[..., 0] - s * re10 + half_m * r11[..., 0],
            half_p * r00[..., 1] + half_m * r11[..., 1],
        ],
        dim=-1,
    )
    new10 = torch.stack(
        [
            s / 2.0 * r00[..., 0] + c * re10 - s / 2.0 * r11[..., 0],
            s / 2.0 * r00[..., 1] + r10[..., 1] - s / 2.0 * r11[..., 1],
        ],
        dim=-1,
    )
    new11 = torch.stack(
        [
            half_m * r00[..., 0] + s * re10 + half_p * r11[..., 0],
            half_m * r00[..., 1] + half_p * r11[..., 1],
        ],
        dim=-1,
    )
    return torch.stack([new00, new10, new11])


def _recombine(rotated):
    """Branch recombination of rotated (3t, ..., 3b, 2) predictions into the
    (3t, ..., 2) combined density."""
    r0m, r1m, r2m = rotated[0, ..., 0, :], rotated[1, ..., 0, :], rotated[2, ..., 0, :]
    r0z, r1z, r2z = rotated[0, ..., 1, :], rotated[1, ..., 1, :], rotated[2, ..., 1, :]
    r0p, r1p, r2p = rotated[0, ..., 2, :], rotated[1, ..., 2, :], rotated[2, ..., 2, :]
    # v_minus = (r0 + 2 Re(r1) + r2) / 4 ; the 2 Re(r1) enters Re only
    v_minus = torch.stack(
        [
            (r0m[..., 0] + 2.0 * r1m[..., 0] + r2m[..., 0]) / 4.0,
            (r0m[..., 1] + r2m[..., 1]) / 4.0,
        ],
        dim=-1,
    )
    v_zero = (r0z - r2z) / 2.0
    v_plus = torch.stack(
        [
            (r0p[..., 0] - 2.0 * r1p[..., 0] + r2p[..., 0]) / 4.0,
            (r0p[..., 1] + r2p[..., 1]) / 4.0,
        ],
        dim=-1,
    )
    mid = v_minus - v_plus
    mid = torch.stack([mid[..., 0], mid[..., 1] + r1z[..., 1]], dim=-1)  # + i Im(r1z)
    return torch.stack([v_minus + v_zero + v_plus, mid, v_minus - v_zero + v_plus])


def backward_predict(
    model: str,
    mass,
    dt,
    r_new,                  # (M, 2) phase coordinates AFTER the forward move
    rho_old,                # (M, 2) RI or None: exact density override
    source_elem: int,       # triangular index of the evolving element
    dist_fn,
    dist_params,
    criterion: float = 0.0,
):
    """The 17-step backward-branching density prediction, batched over M
    points of one source element."""
    i_src, j_src = ELEMENTS[source_elem]
    x0, p0 = r_new[:, 0], r_new[:, 1]
    couple0 = is_coupling(model, x0, p0, mass, dt, criterion)

    # backward half-step adiabatic: (x0, p0) -> (x2, p1)
    x2, p1 = adiabatic_leapfrog(model, x0, p0, mass, dt / 2.0, -1, i_src, j_src)
    # off-diagonal-force momentum branches: p2[n] = p1 - dt n f01(x2) couple
    f01 = tully.adiabatic_force(model, x2)[..., 0, 1] * couple0
    p2 = p1[:, None] - dt * _table(BRANCHES, x0)[None, :] * f01[:, None]   # (M, 3)
    x3 = x2[:, None] - dt / 4.0 * p2 / mass                               # (M, 3)
    # diagonal-force split towards each target element: p3[e] (3, M, 3)
    f_adia_x3 = tully.adiabatic_force(model, x3)                          # (M, 3, 2, 2)
    p3 = torch.stack(
        [p2 - dt / 4.0 * (f_adia_x3[..., a, a] + f_adia_x3[..., b, b]) for (a, b) in ELEMENTS]
    )
    x4 = x3[None] - dt / 4.0 * p3 / mass                                  # (3, M, 3)

    # one batched GP query per target element at (x4, p3)
    query = torch.stack([x4, p3], dim=-1).reshape(NUM_ELEMENTS, -1, 2)    # (3, 3M, 2)
    rho_pred = dist_fn(dist_params, query).reshape(NUM_ELEMENTS, -1, 3, 2).clone()
    if rho_old is not None:
        # control variate: exact carried value + GP branch differences
        diff = rho_pred[source_elem] - rho_pred[source_elem, :, 1:2, :]
        rho_pred[source_elem] = rho_old[:, None, :] + diff

    # adiabatic phase on the off-diagonal component from (x4 -> x2)
    theta = omega0(model, x2[:, None], x4[OFFDIAG_INDEX], 0, 1) * dt / 2.0
    rho_pred[OFFDIAG_INDEX] = ri.phase_mul(rho_pred[OFFDIAG_INDEX], theta)

    # per-branch off-diagonal rotation at (x2, p2[n]) over dt/2
    rotated = torch.stack(
        [
            _offdiagonal_rotation(model, rho_pred[:, :, n], x2, p2[:, n], mass, dt / 2.0,
                                  criterion)
            for n in range(3)
        ],
        dim=2,
    )                                                                     # (3, M, 3br, 2)
    combined = _recombine(rotated)                                        # (3, M, 2)

    # second off-diagonal rotation at (x2, p1) over dt/2
    combined = _offdiagonal_rotation(model, combined, x2, p1, mass, dt / 2.0, criterion)

    result = combined[source_elem]
    if i_src != j_src:
        result = ri.phase_mul(result, omega0(model, x0, x2, 0, 1) * dt / 2.0)
    return result


def _diag_forces(model: str, x):
    f = tully.adiabatic_force(model, x)
    return torch.stack([f[..., 0, 0], f[..., 1, 1]], dim=-1)


def _weighted_leapfrog(model: str, x, p, mass, dt, drc: int):
    """All-sources leapfrog: x, p are (3, ...) with per-source force weights."""
    s = float(drc)
    x = x + s * dt / 2.0 * p / mass
    fsum = torch.einsum("sd,s...d->s...", _table(_FORCE_WEIGHTS, x), _diag_forces(model, x))
    p = p + s * dt / 2.0 * fsum
    x = x + s * dt / 2.0 * p / mass
    return x, p


def _omega0_all(model: str, xa, xb):
    """Per-source omega0 (3, ...): nonzero only for the off-diagonal element."""
    gap = _table(_GAP_WEIGHTS, xa)
    ea = tully.adiabatic_potential(model, xa)
    eb = tully.adiabatic_potential(model, xb)
    return (
        torch.einsum("sd,s...d->s...", gap, ea) + torch.einsum("sd,s...d->s...", gap, eb)
    ) / (2.0 * HBAR)


def evolve_step(
    model: str,
    mass,
    dt,
    density: Density,
    dist_fn,
    dist_params,
    criterion: float = 0.0,
) -> Density:
    """One forward time step of every sampled point.

    Coupled points: two half-step leapfrogs then backward prediction.
    Uncoupled points: one full leapfrog, density = old distribution at the old
    coordinate times the adiabatic phase.  Both are computed and blended by
    the per-point coupling mask; all queries go to ``dist_fn`` in ONE call of
    10N points per target element."""
    n = density.num_points
    x0, p0 = density.points[..., 0], density.points[..., 1]          # (3, N)
    couple = is_coupling(model, x0, p0, mass, dt, criterion)          # (3, N)

    # forward: two half-step leapfrogs (coupled path) and one full (adiabatic)
    xa, pa = _weighted_leapfrog(model, x0, p0, mass, dt / 2.0, +1)
    xb, pb = _weighted_leapfrog(model, xa, pa, mass, dt / 2.0, +1)
    xc, pc = _weighted_leapfrog(model, x0, p0, mass, dt, +1)

    # backward half-step from the moved coordinates: (xb, pb) -> (x2, p1)
    couple0 = is_coupling(model, xb, pb, mass, dt, criterion)
    x2, p1 = _weighted_leapfrog(model, xb, pb, mass, dt / 2.0, -1)
    f01 = tully.adiabatic_force(model, x2)[..., 0, 1] * couple0       # (3, N)
    p2 = p1[..., None] - dt * _table(BRANCHES, x0) * f01[..., None]   # (3, N, 3)
    x3 = x2[..., None] - dt / 4.0 * p2 / mass                         # (3, N, 3)
    fd3 = _diag_forces(model, x3)                                     # (3, N, 3, 2)
    # diagonal-force split towards each target element
    p3 = p2[:, None] - dt / 4.0 * torch.einsum(
        "td,snbd->stnb", _table(_FORCE_WEIGHTS, x0), fd3)
    x4 = x3[:, None] - dt / 4.0 * p3 / mass                           # (3s, 3t, N, 3b)

    # ONE GP query per target element: branch points of every source + the
    # old coordinates (for the adiabatic path of that element)
    x4_t = x4.transpose(0, 1)                                         # (3t, 3s, N, 3b)
    p3_t = p3.transpose(0, 1)
    branch_q = torch.stack([x4_t, p3_t], dim=-1).reshape(NUM_ELEMENTS, -1, 2)
    query = torch.cat([branch_q, density.points], dim=1)             # (3, 9N + N, 2)
    rho_all = dist_fn(dist_params, query)                             # (3, 10N, 2)
    rho_pred = rho_all[:, : 9 * n].reshape(NUM_ELEMENTS, NUM_ELEMENTS, n, 3, 2).clone()
    rho_at_old = rho_all[:, 9 * n:]                                   # (3, N, 2)

    # control variate on each source's own element: exact carried value plus
    # the GP branch DIFFERENCE (see gple_tpu.dynamics.evolve.evolve_step)
    for s in range(NUM_ELEMENTS):
        diff = rho_pred[s, s] - rho_pred[s, s, :, 1:2, :]
        rho_pred[s, s] = density.rho[s][:, None, :] + diff

    # adiabatic phase on the off-diagonal target component from (x4 -> x2)
    theta = omega0(model, x2[:, :, None], x4[:, OFFDIAG_INDEX], 0, 1) * dt / 2.0
    rho_pred[OFFDIAG_INDEX] = ri.phase_mul(rho_pred[OFFDIAG_INDEX], theta)

    # per-branch off-diagonal rotation at (x2, p2[n]) over dt/2
    rotated = torch.stack(
        [
            _offdiagonal_rotation(model, rho_pred[:, :, :, b], x2, p2[:, :, b], mass,
                                  dt / 2.0, criterion)
            for b in range(3)
        ],
        dim=3,
    )                                                                 # (3t, 3s, N, 3b, 2)
    combined = _recombine(rotated)                                    # (3t, 3s, N, 2)

    # second off-diagonal rotation at (x2, p1) over dt/2
    combined = _offdiagonal_rotation(model, combined, x2, p1, mass, dt / 2.0, criterion)

    # each source takes its own target component; the off-diagonal source gets
    # the final phase omega0(x0, x2; i=0, j=1) = (E0 - E1) = -(gap weights)
    rho_na = torch.stack([combined[s, s] for s in range(NUM_ELEMENTS)])
    final_theta = -_omega0_all(model, xb, x2) * dt / 2.0
    rho_na = ri.phase_mul(rho_na, final_theta)

    # adiabatic path: phase-rotated old density at the full-leapfrog coordinate
    gap = _table(_GAP_WEIGHTS, x0)
    theta_ad = (
        torch.einsum("sd,snd->sn", gap, tully.adiabatic_potential(model, x0))
        + torch.einsum("sd,snd->sn", gap, tully.adiabatic_potential(model, xc))
    ) / (2.0 * HBAR)
    rho_ad = ri.phase_mul(rho_at_old, -theta_ad * dt)

    r_na = torch.stack([xb, pb], dim=-1)
    r_ad = torch.stack([xc, pc], dim=-1)
    mask = couple[..., None]
    return Density(
        points=torch.where(mask, r_na, r_ad),
        rho=torch.where(mask, rho_na, rho_ad),
        active=density.active,
    )


def predict_new_points(model: str, mass, dt, pts, elem: int, dist_fn, dist_params,
                       criterion: float = 0.0):
    """Density prediction for points with no known value: backward prediction
    where coupled, zero elsewhere.  Returns (M, 2) RI."""
    rho = backward_predict(model, mass, dt, pts, None, elem, dist_fn, dist_params, criterion)
    couple = is_coupling(model, pts[:, 0], pts[:, 1], mass, dt, criterion)
    return torch.where(couple[:, None], rho, 0.0)


def is_very_small(model, mass, dt, density: Density, dist_fn, dist_params,
                  criterion: float = 0.0):
    """Per-element smallness flags: an inactive element stays small only if
    every test-point prediction is below epsilon; active elements are never
    small.  Probes the union of every element's cloud.  Returns (3,) bool."""
    test_pts = density.points.reshape(-1, density.points.shape[-1])
    small = []
    for k in range(NUM_ELEMENTS):
        pred = predict_new_points(model, mass, dt, test_pts, k, dist_fn, dist_params,
                                  criterion)
        all_small = torch.all(ri.abs2(pred) < VERY_SMALL_EPSILON)
        small.append(~density.active[k] & all_small)
    return torch.stack(small)
