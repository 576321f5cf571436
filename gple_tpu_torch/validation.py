"""GPR validation harness (counterpart of :mod:`gple_tpu.validation`).

The reference's validation binaries, on the port:

* :func:`screenshot_fit` -- fit ONE exact phase-space snapshot from an
  oracle, report the elementwise MSE, the negative log marginal likelihood
  and the population from the grid and from the analytic integral
  (reference ``test/main_screenshot.cpp:11-123``);
* :func:`evolve_fit` -- fit every snapshot of a trajectory with warm-started
  hyperparameters and log population and energy from the grid and from the
  parameter integrals, before and after the conservation rescale
  (``test/main_evolve.cpp:56-179``);
* :func:`nll_loss` -- 1/2 y^T K^-1 y + 1/2 ln|K| (``test/gpr.cpp:499-532``);
* :func:`conservation_rescale` -- the per-surface rescale that enforces
  total population and energy (``test/gpr.cpp:913-992``).

The hyperparameter fit :func:`_fit_nll` runs the port's bounded L-BFGS
(``gp.opt._lbfgs_scan``) on the device of the data, the CUDA card unless
``device="cpu"``.  Its default ``line_search="zoom"`` is optax's zoom line
search, the solver the JAX package's validation reaches on the CPU;
``line_search="fan"`` is the fixed fan of its accelerator branch, whose
seven line-search candidates are one batched fit (a leading candidate axis
on every operand).  The value and gradient come from ``torch.autograd``
through the batched Cholesky and the kernels' autograd Functions.  The full
lower-triangular ARD matrix ``W`` reaches the Gram as transformed points
``z = W x`` with unit lengths, so its gradient runs through the Gram's points
cotangent (the ``rbf_gram_vjp_points`` kernel on the card).

Random numbers: :func:`grid_weighted_selection` seeds numpy's weighted
choice with ``key.randint(0, 2**31 - 1)`` (``RandomKeys``), where the JAX
package seeds it with ``jax.random.randint`` of its key.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch

from gple_tpu_torch.gp.opt import _bounds_to_sigmoid, _lbfgs_scan, _lead, _sigmoid_to_bounds
from gple_tpu_torch.models import tully
from gple_tpu_torch.ops import kernels as RK

#: points selected per snapshot (reference test/stdafx.h:47)
DEFAULT_NUM_POINTS = 200
#: the pinned magnitude and relative noise of the NLL fit
FIT_NOISE = 1e-2


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def nll_loss(state: RK.RealTrainState):
    """Negative log marginal likelihood 1/2 y^T alpha + sum(log diag L)
    (+ N/2 log 2pi omitted as a constant), of the batch shape of ``state``.
    A kernel that is not positive definite gives NaN, as JAX's Cholesky does."""
    quad = 0.5 * torch.sum(state.labels * state.alpha, dim=-1)
    k = RK.kernel_matrix(state.params, state.features, state.features, same=True)
    chol, info = torch.linalg.cholesky_ex(k)
    chol = torch.where((info == 0)[..., None, None], chol, float("nan"))
    logdet = torch.sum(torch.log(torch.abs(torch.diagonal(chol, dim1=-2, dim2=-1))), dim=-1)
    return quad + logdet


def grid_weighted_selection(key, coords, values, n_points: int):
    """Importance-select ``n_points`` grid points with probability ~ |value|
    (reference test/gpr.cpp:215-291); host numpy (coords (n, D), values (n,))."""
    coords, values = _host(coords), _host(values)
    w = np.abs(values)
    total = w.sum()
    if total == 0:
        idx = np.arange(n_points) % len(w)
    else:
        rng = np.random.default_rng(key.randint(0, 2**31 - 1))
        idx = rng.choice(len(w), size=min(n_points, (w > 0).sum()), replace=False,
                         p=w / total)
        if len(idx) < n_points:
            idx = np.concatenate([idx, idx[: n_points - len(idx)]])
    return coords[idx], values[idx]


def _unit_params(lengths, batch, like):
    ones = torch.ones(batch, dtype=like.dtype, device=like.device)
    return RK.KernelParams(magnitude=ones, lengths=lengths,
                           noise=torch.full_like(ones, FIT_NOISE))


def _fit_nll(features, labels, lengths0, lb, ub, steps: int = 60, full_ard: bool = False,
             line_search: str = "zoom"):
    """Two-stage NLL hyperparameter fit: L-BFGS (``line_search``, see
    :func:`gple_tpu_torch.gp.opt._lbfgs_scan`) in sigmoid coordinates inside
    ``[lb, ub]``, twice (reference gpr.cpp:535-643 runs Nelder-Mead then
    TNEWTON), then the maximum-likelihood magnitude.  All tensors on one
    device; returns the fitted ``RealTrainState``.

    ``full_ard`` fits the reference validation GPR's full lower-triangular
    characteristic matrix W = [[1/l_0, 0], [w_10, 1/l_1]] (test/gpr.cpp:
    309-328); the cross term starts at 0 (the axis-aligned kernel), bounded
    by the largest inverse length."""
    pd = lengths0.shape[-1]
    f64 = dict(dtype=features.dtype, device=features.device)
    if full_ard:
        wmax = 1.0 / torch.sqrt(lb[0] * lb[1])
        lb = torch.cat([lb, -wmax[None]])
        ub = torch.cat([ub, wmax[None]])
        theta0 = torch.cat([lengths0, torch.zeros(1, **f64)])
        cross = torch.zeros((pd, pd), **f64)
        cross[1, 0] = 1.0
    else:
        theta0 = lengths0

    def to_lengths(theta):
        if not full_ard:
            return theta
        return torch.diag_embed(1.0 / theta[..., :pd]) + theta[..., pd, None, None] * cross

    def loss(z):
        # z: (F, P), the line search's candidates (F = 1 under the zoom); the
        # features take the candidate axis too, so matrix lengths (F, D, D)
        # match their rank
        batch = z.shape[:-1]
        params = _unit_params(to_lengths(_sigmoid_to_bounds(z, lb, ub)), batch, z)
        st = RK.fit_real(params, _lead(features, batch), _lead(labels, batch))
        return torch.nan_to_num(nll_loss(st), nan=1e30, posinf=1e30)

    z = _bounds_to_sigmoid(theta0, lb, ub)
    for _ in range(2):
        z = _lbfgs_scan(loss, z, steps, line_search)
    with torch.no_grad():
        lengths = to_lengths(_sigmoid_to_bounds(z, lb, ub))
        state = RK.fit_real(_unit_params(lengths, (), z), features, labels)
        params = RK.KernelParams(magnitude=RK.optimal_magnitude(state), lengths=lengths,
                                 noise=torch.full_like(state.rescale, FIT_NOISE))
        return RK.fit_real(params, features, labels)


@dataclasses.dataclass
class SnapshotFit:
    state: RK.RealTrainState
    mse: float
    nll: float
    population_grid: float
    population_prm: float
    prediction: np.ndarray


def screenshot_fit(key, coords, values, da: float, n_points: int = DEFAULT_NUM_POINTS,
                   lengths0=None, full_ard: bool = False, device="cuda",
                   line_search: str = "zoom") -> SnapshotFit:
    """Fit one snapshot (coords (G, 2), real values (G,), cell area da) on
    ``device`` with the ``line_search`` L-BFGS and report MSE / NLL /
    populations both ways (main_screenshot.cpp:96-114).

    ``full_ard`` fits the full lower-triangular characteristic matrix (cross
    term between x and p) instead of axis-aligned lengths; ``lengths0`` stays
    a plain length vector either way."""
    f64 = dict(dtype=torch.float64, device=torch.device(device))
    feats, labels = grid_weighted_selection(key, coords, values, n_points)
    std = feats.std(axis=0)
    lb = torch.tensor(np.maximum(std / np.sqrt(n_points), 1e-2), **f64)
    ub = torch.tensor(2.0 * std, **f64)
    if lengths0 is None:
        lengths0 = 0.5 * std
    state = _fit_nll(torch.tensor(feats, **f64), torch.tensor(labels, **f64),
                     torch.tensor(np.asarray(lengths0), **f64), lb, ub, full_ard=full_ard,
                     line_search=line_search)
    with torch.no_grad():
        pred, _, _ = RK.predict_real(state, torch.as_tensor(coords, **f64),
                                     with_variance=False)
        host = torch.stack([torch.mean((pred - torch.as_tensor(values, **f64)) ** 2),
                            nll_loss(state), RK.population(state)]).cpu().numpy()
    return SnapshotFit(
        state=state,
        mse=float(host[0]),
        nll=float(host[1]),
        population_grid=float(np.sum(_host(values)) * da),
        population_prm=float(host[2]),
        prediction=pred.cpu().numpy(),
    )


def _char_rows(lengths):
    """(w00, w10, w11) of the characteristic matrix in z = W r form: vector
    lengths l map to W = diag(1/l); a matrix is lower triangular already."""
    if lengths.dim() == 2:
        return lengths[0, 0], lengths[1, 0], lengths[1, 1]
    return 1.0 / lengths[0], torch.zeros_like(lengths[0]), 1.0 / lengths[1]


#: fixed trapezoid rule in the standardized variable t = w00 (x - xi) over
#: [-8, 8]: spectrally convergent for the Gaussian-weighted smooth integrand,
#: truncation error exp(-32); 512 nodes leave the rule error below 1e-12
POT_NODES = 512
POT_SPAN = 8.0


def potential_energy_prm(state: RK.RealTrainState, model: str, surface: int):
    """integral V_s(x) f(x, p) dx dp from the fitted GP parameters (one
    unbatched state): the p-marginal in closed form (the cross term of a
    lower-triangular W shifts the p-Gaussian's mean and integrates out,
    leaving sqrt(2 pi)/w11 * exp(-(w00 dx)^2/2)) and the x integral as a fixed
    trapezoid rule in the standardized variable (reference test/gpr.cpp:764-841
    uses an adaptive stepper)."""
    lengths = state.params.lengths
    w00, _, w11 = _char_rows(lengths)
    t = torch.linspace(-POT_SPAN, POT_SPAN, POT_NODES + 1, dtype=lengths.dtype,
                       device=lengths.device)
    u = torch.exp(-0.5 * t**2) * (2.0 * POT_SPAN / POT_NODES)
    u[0] *= 0.5
    u[-1] *= 0.5
    xi = state.features[:, 0]
    x_nodes = xi[:, None] + t[None, :] / w00                       # (N, nodes)
    v = tully.adiabatic_potential(model, x_nodes.reshape(-1))[:, surface]
    v = v.reshape(x_nodes.shape)
    # integral V(x) exp(-(w00 dx)^2/2) dx = (1/w00) sum_j u_j V(xi + t_j/w00)
    pot_i = (v @ u) / w00
    coeff = state.params.magnitude**2 * math.sqrt(2.0 * math.pi) / torch.abs(w11)
    return coeff * torch.dot(pot_i, state.alpha) / state.rescale


def kinetic_energy_prm(state: RK.RealTrainState, mass: float):
    """integral p^2/(2m) f(x, p) dx dp analytically (test/gpr.cpp:845-886):
    for z = W (r - ri), W lower triangular,
    integral p^2 exp(-|z|^2/2) dr = (2 pi / (w00 w11)) *
        (1/w11^2 + p_i^2 + w10^2 / (w00 w11)^2)."""
    w00, w10, w11 = _char_rows(state.params.lengths)
    pi2 = state.features[:, 1] ** 2
    per_point = 1.0 / w11**2 + pi2 + w10**2 / (w00 * w11) ** 2
    coeff = state.params.magnitude**2 * 2.0 * math.pi / torch.abs(w00 * w11)
    return coeff * torch.dot(per_point, state.alpha) / (2.0 * mass) / state.rescale


def conservation_rescale(populations, energies, target_population: float,
                         target_energy: float):
    """Per-surface linear rescale factors a s.t. sum(a * pop) = target_pop and
    sum(a * pop * e) = target_energy (reference test/gpr.cpp:913-992 solves the
    same 2x2 linear system for two surfaces)."""
    pop = np.asarray(populations, dtype=float)
    e = np.asarray(energies, dtype=float)
    scale = np.ones_like(pop)
    live = pop > 1e-12 * max(pop.max(), 1e-300)
    if live.sum() >= 2:
        a_mat = np.stack([pop[live], pop[live] * e[live]])
        b = np.array([target_population, target_energy])
        sol, *_ = np.linalg.lstsq(a_mat, b, rcond=None)
        # exact when the 2x2 system is well conditioned; always re-normalize
        # the population constraint exactly afterwards
        scale[live] = sol
        scale[live] *= target_population / np.dot(scale[live], pop[live])
    elif live.sum() == 1:
        scale[live] = target_population / pop[live]
    return scale


@dataclasses.dataclass
class EvolveFitFrame:
    time: float
    mse: float
    population_grid: np.ndarray
    population_prm: np.ndarray
    energy_grid: float
    energy_prm: float
    population_rescaled: np.ndarray
    energy_rescaled: float


def evolve_fit(key, times, frames, x_grid, p_grid, model: str, mass: float,
               n_points: int = DEFAULT_NUM_POINTS, device="cuda",
               line_search: str = "zoom") -> List[EvolveFitFrame]:
    """Fit a whole trajectory of diagonal Wigner frames on ``device`` with
    warm-started hyperparameters and the ``line_search`` L-BFGS (reference
    test/main_evolve.cpp:54-179).

    ``frames``: (T, 2, Nx, Np) real diagonal distributions from an oracle."""
    x_grid, p_grid = _host(x_grid), _host(p_grid)
    da = float((x_grid[1] - x_grid[0]) * (p_grid[1] - p_grid[0]))
    gx, gp = np.meshgrid(x_grid, p_grid, indexing="ij")
    coords = np.stack([gx.ravel(), gp.ravel()], axis=-1)
    pot = tully.adiabatic_potential(model, torch.as_tensor(coords[:, 0])).numpy()
    e_per_cell = [coords[:, 1] ** 2 / (2.0 * mass) + pot[:, s] for s in range(2)]
    out: List[EvolveFitFrame] = []
    warm = [None, None]
    e0_target = None
    for t_idx, t in enumerate(_host(times)):
        key, sub = key.split(2)
        pops_g, pops_p, es_g, es_p, mses = [], [], [], [], []
        for s in range(2):
            vals = _host(frames[t_idx][s]).ravel()
            if np.abs(vals).max() < 1e-12:
                pops_g.append(0.0); pops_p.append(0.0); es_g.append(0.0); es_p.append(0.0)
                mses.append(0.0)
                continue
            fit = screenshot_fit(sub, coords, vals, da, n_points, lengths0=warm[s],
                                 device=device, line_search=line_search)
            fitted = _host(fit.state.params.lengths)
            # warm start stays a plain length vector under either kernel class
            warm[s] = 1.0 / np.abs(np.diagonal(fitted)) if fitted.ndim == 2 else fitted
            pops_g.append(fit.population_grid)
            pops_p.append(fit.population_prm)
            es_g.append(float((vals * e_per_cell[s]).sum() * da))
            es_p.append(float((fit.prediction * e_per_cell[s]).sum() * da))
            mses.append(fit.mse)
        if e0_target is None:
            e0_target = sum(es_g)
        scale = conservation_rescale(pops_p, np.asarray(es_p) / np.maximum(pops_p, 1e-300),
                                     1.0, e0_target)
        out.append(
            EvolveFitFrame(
                time=float(t),
                mse=float(np.mean(mses)),
                population_grid=np.asarray(pops_g),
                population_prm=np.asarray(pops_p),
                energy_grid=float(sum(es_g)),
                energy_prm=float(sum(es_p)),
                population_rescaled=np.asarray(pops_p) * scale,
                energy_rescaled=float(np.dot(scale, es_p)),
            )
        )
    return out
