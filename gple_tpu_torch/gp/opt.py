"""GP hyperparameters: the moment optimizer and the constrained ladder
(counterpart of :mod:`gple_tpu.gp.opt`).

* ``opt_mode="moment"`` sets the parameters in closed form -- lengths =
  |label|-weighted cloud std / 2 per axis (coherence: / ``off_len_div``), Re/Im
  independent (corr = 0), analytic magnitudes from one diagnostics fit whose
  LOOCV + extra-set error is the run.log error.
* ``opt_mode="ladder"`` is the reference's constrained restart ladder
  (opt.cpp:1019-1392): loss = LOOCV + extra-set error, lengths in sigmoid
  coordinates inside the cloud's bounds, equality constraints population = 1,
  energy = E0 and purity = P0 through an augmented-Lagrangian outer loop
  around a bounded L-BFGS, three stages (``local_previous`` ->
  ``local_initial`` -> ``global``, a Halton sweep) accepted by the 5%
  ``check_averages`` rule and ``compare_and_overwrite``.

The inner solver is the JAX package's fixed-fan L-BFGS (``_lbfgs_fixed_fan``,
the branch its ``_lbfgs_scan`` takes on an accelerator) on every device: a
two-loop recursion and a line search over a fixed fan of step scales whose
candidates are ONE batched fit (a leading batch axis on every loss), with no
data-dependent control flow, so no step waits for the host.  Gradients come
from ``torch.autograd`` through the Cholesky and the kernels' autograd
Functions (``gram_kernels.RBFGram`` / ``RBFPredictMean``).  Not ported: the
JAX CPU branch ``_lbfgs_zoom`` (optax's zoom line search, a data-dependent
loop) and the host pinning ``Optimizer.device="cpu"`` of the JAX package.

The optimizer runs on the device of the data it is given.  Its parameter
state stays on the host as numpy arrays, as in the JAX package;
:meth:`Optimizer.fitted_params` builds the tensors the fit reads.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from gple_tpu_torch.ops import complex_kernels as CK
from gple_tpu_torch.ops import kernels as RK
from gple_tpu_torch.storage import DIAG_INDICES, OFFDIAG_INDEX, Density

#: relative tolerance of the conservation checks (reference opt.h:13)
AVERAGE_TOLERANCE = 0.05
#: pinned magnitude / noise during optimization (opt.cpp:25-27)
INITIAL_MAGNITUDE = 1.0
INITIAL_NOISE = 1e-2
#: sub-kernel magnitude bounds for the complex kernel (opt.cpp:86-87)
COMPLEX_MAG_LB = 0.1
COMPLEX_MAG_UB = 10.0
#: bound on the real-imaginary correlation strength
CORR_BOUND = 0.99
#: hard floor on characteristic lengths (opt.cpp:397)
MIN_CHAR_LENGTH = 1.0 / 100.0

#: inner L-BFGS steps per solve, outer augmented-Lagrangian updates per
#: constrained pass, and the Halton starts of the global stage
LBFGS_STEPS = 60
AL_OUTER = 4
GLOBAL_STARTS = 16
#: penalty schedule on the RELATIVE constraint violations (the loss is
#: O(10-100), so the penalty must reach ~1e6 for a 0.1% violation to cost O(1))
AL_MU0 = 1e3
AL_MU_GROWTH = 10.0
#: L-BFGS history length (two-loop recursion)
LBFGS_HISTORY = 8
#: the line search's nonzero step scales (2^-9 .. 2, and 1); the zero step,
#: the current iterate, is the fan's last candidate
LINESEARCH_SCALES = tuple(2.0**k for k in range(-9, 2, 2)) + (1.0,)

_DIAG = list(DIAG_INDICES)


def _wstd(points, weights):
    """|weight|-weighted per-axis std of a cloud (N, D), floored."""
    w = torch.clamp(torch.abs(weights), min=1e-30)
    mu = (points.T @ w) / torch.sum(w)
    var = (((points - mu) ** 2).T @ w) / torch.sum(w)
    return torch.sqrt(torch.clamp(var, min=MIN_CHAR_LENGTH**2))


def _sigmoid_to_bounds(z, lb, ub):
    return lb + (ub - lb) * torch.sigmoid(z)


def _bounds_to_sigmoid(theta, lb, ub):
    frac = torch.clamp((theta - lb) / torch.clamp(ub - lb, min=1e-30), 1e-6, 1.0 - 1e-6)
    return torch.log(frac) - torch.log1p(-frac)


# -- losses and constraints ----------------------------------------------------------
#
# Every function below takes its parameters with optional leading batch axes
# (``diag_lengths (..., 2, D)``, ``off_flat (..., 2D + 3)``) and returns
# values of that batch shape: the line search's candidate fan is one batched
# fit.

def _lead(x, batch):
    """``x`` broadcast (as a view) to ``batch + x.shape``."""
    return x.expand(tuple(batch) + x.shape)


def _diag_states(diag_lengths, data):
    """Both diagonal elements fitted at unit magnitude, as one batched state."""
    batch = diag_lengths.shape[:-2]
    ones = torch.ones(diag_lengths.shape[:-1], dtype=diag_lengths.dtype,
                      device=diag_lengths.device)
    params = RK.KernelParams(magnitude=ones, lengths=diag_lengths,
                             noise=torch.full_like(ones, INITIAL_NOISE))
    return RK.fit_real(params, _lead(data["dpts"], batch), _lead(data["drho"], batch))


def _diag_loss_from_states(states, data):
    batch = states.alpha.shape[:-2]
    loo = RK.loocv_error(states)
    extra = RK.extra_set_error(states, _lead(data["depts"], batch),
                               _lead(data["derho"], batch))
    per_elem = torch.nan_to_num(loo + extra, nan=1e30, posinf=1e30)
    return torch.sum(per_elem * data["dmask"], dim=-1)


def _diag_loss(diag_lengths, data):
    return _diag_loss_from_states(_diag_states(diag_lengths, data), data)


def _off_state(off_flat, data, block_diag: bool = False):
    # off_flat: (..., m_R, l_R(d), m_I, l_I(d), corr) -- 2d + 3 entries
    d = (off_flat.shape[-1] - 3) // 2
    one = torch.ones((), dtype=off_flat.dtype, device=off_flat.device)
    params = CK.ComplexKernelParams(
        magnitude=one,
        real_magnitude=off_flat[..., 0],
        real_lengths=off_flat[..., 1: 1 + d],
        imag_magnitude=off_flat[..., 1 + d],
        imag_lengths=off_flat[..., 2 + d: 2 + 2 * d],
        noise=one * INITIAL_NOISE,
        corr=off_flat[..., -1],
    )
    return CK.fit_complex(params, data["opts"], data["orho"], block_diag=block_diag)


def _off_loss_from_state(state, data):
    loss = CK.loocv_error_complex(state) + CK.extra_set_error_complex(
        state, data["oepts"], data["oerho"])
    return torch.nan_to_num(loss, nan=1e30, posinf=1e30) * data["omask"]


def _off_loss(off_flat, data):
    return _off_loss_from_state(_off_state(off_flat, data), data)


def _averages_from_states(dstates, ostate, data):
    """(population, energy, purity) (..., 3) from the analytic GP integrals;
    ``ostate`` None leaves the coherence out of the purity."""
    pops = RK.population(dstates) * data["dmask"]
    population = torch.sum(pops, dim=-1)
    energy = torch.sum(pops * data["energies"], dim=-1)
    pur = torch.sum(RK.purity(dstates) * data["dmask"], dim=-1)
    if ostate is not None:
        pur = pur + 2.0 * CK.purity_complex(ostate) * data["omask"]
    vals = torch.stack([population, energy, pur], dim=-1)
    return torch.nan_to_num(vals, nan=1e150, posinf=1e150, neginf=-1e150)


def _raw_averages(diag_lengths, off_flat, data, with_off: bool):
    """(population, energy, purity) from the analytic GP integrals."""
    ostate = _off_state(off_flat, data) if with_off else None
    return _averages_from_states(_diag_states(diag_lengths, data), ostate, data)


# -- the inner solver ----------------------------------------------------------------

def _take(t, i):
    """``t[i]`` for a 0-d index tensor, without a host sync."""
    return torch.index_select(t, 0, i.reshape(1))[0]


def _lbfgs_fixed_fan(fn, z0, steps: int):
    """Fixed-step L-BFGS: two-loop recursion + a fixed fan of step scales.

    ``fn`` maps a batch of parameter arrays ``(F,) + z0.shape`` to ``(F,)``
    losses; each step evaluates the fan's seven nonzero candidates as ONE
    such call (no gradient) and the chosen iterate's value and gradient as
    one more.  The zero candidate keeps the iterate when no step improves
    the loss, so the fan doubles as a trust region.  A curvature pair enters
    the history only when s.y > 1e-12.  No step pulls a value to the host."""
    shape = z0.shape
    z = z0.detach().reshape(-1)
    d = z.shape[0]
    m = LBFGS_HISTORY
    f64 = dict(dtype=z.dtype, device=z.device)
    scales = torch.tensor(LINESEARCH_SCALES + (0.0,), **f64)
    slots = torch.arange(m, device=z.device)

    def fn_flat(zz):
        return fn(zz.reshape(zz.shape[:-1] + shape))

    def vg(zz):
        zz = zz.detach().requires_grad_(True)
        with torch.enable_grad():
            value = fn_flat(zz[None])[0]
            (grad,) = torch.autograd.grad(value, zz)
        return torch.nan_to_num(value.detach(), nan=1e30, posinf=1e30), torch.nan_to_num(grad)

    def direction(g, S, Y, rho, k):
        """Two-loop recursion over the circular (S, Y) history."""
        q = g
        alphas = []
        for j in range(m):          # newest to oldest
            i = (k - 1 - j) % m
            s_i, y_i, rho_i = _take(S, i), _take(Y, i), _take(rho, i)
            valid = (rho_i > 0.0) & (j < k)
            a = torch.where(valid, rho_i * torch.dot(s_i, q), 0.0)
            q = q - a * y_i
            alphas.append((s_i, y_i, rho_i, valid, a))
        i_last = (k - 1) % m
        s_l, y_l = _take(S, i_last), _take(Y, i_last)
        sy = torch.dot(s_l, y_l)
        yy = torch.dot(y_l, y_l)
        gamma = torch.where((k > 0) & (sy > 0.0) & (yy > 0.0),
                            sy / torch.clamp(yy, min=1e-30), 1.0)
        r = gamma * q
        for s_i, y_i, rho_i, valid, a in reversed(alphas):   # oldest to newest
            b = torch.where(valid, rho_i * torch.dot(y_i, r), 0.0)
            r = r + torch.where(valid, a - b, 0.0) * s_i
        return -r

    value, grad = vg(z)
    S = torch.zeros((m, d), **f64)
    Y = torch.zeros((m, d), **f64)
    rho = torch.zeros((m,), **f64)
    k = torch.zeros((), dtype=torch.long, device=z.device)
    for _ in range(steps):
        p = direction(grad, S, Y, rho, k)
        # safeguard: steepest descent if the direction is not a descent
        # direction (stale curvature pairs)
        p = torch.where(torch.dot(p, grad) < 0.0, p, -grad)
        cands = z[None, :] + scales[:, None] * p[None, :]
        with torch.no_grad():
            values = torch.nan_to_num(fn_flat(cands[:-1]), nan=1e30, posinf=1e30)
        # the zero step reproduces f(z): argmin never regresses
        best = torch.argmin(torch.cat([values, value[None]]))
        z_new = _take(cands, best)
        v_new, g_new = vg(z_new)
        s = z_new - z
        y = g_new - grad
        sy = torch.dot(s, y)
        put = (slots == k % m) & (sy > 1e-12)
        S = torch.where(put[:, None], s[None, :], S)
        Y = torch.where(put[:, None], y[None, :], Y)
        rho = torch.where(put, 1.0 / torch.clamp(sy, min=1e-30), rho)
        k = k + (sy > 1e-12).long()
        z, value, grad = z_new, v_new, g_new
    return z.reshape(shape)


# -- one stage of the ladder -----------------------------------------------------------

def _al_minimize(z0, loss_and_cons, lam_init, lbfgs_steps: int, al_outer: int):
    """Augmented-Lagrangian outer loop: ``al_outer`` L-BFGS solves of
    loss + lam.c + mu/2 |c|^2, each followed by lam += mu c, mu *= growth.
    Returns (z, lam)."""
    z, lam, mu = z0, lam_init, AL_MU0
    for _ in range(al_outer):
        def objective(zz, lam=lam, mu=mu):
            loss, cons = loss_and_cons(zz)
            return loss + torch.sum(lam * cons, dim=-1) + 0.5 * mu * torch.sum(cons**2, dim=-1)

        z = _lbfgs_fixed_fan(objective, z, lbfgs_steps)
        with torch.no_grad():
            _, cons = loss_and_cons(z)
        lam, mu = lam + mu * cons, mu * AL_MU_GROWTH
    return z, lam


def _run_stage(start_diag, start_off, lam0, data, off_active: bool,
               lbfgs_steps: int, al_outer: int):
    """One complete do_optimize pass (opt.cpp:1101-1198): elementwise fits,
    then the constrained diagonal pass, then (when the coherence is active)
    the constrained full pass.  ``lam0``: (2, 3) warm-start multipliers of
    the (diagonal, full) passes, zeros for a cold start.

    Returns (diag_lengths, off_flat, error, raw averages (3,), lam_out (2, 3))
    as device tensors."""
    dlb, dub = data["dlb"], data["dub"]
    olb, oub = data["olb"], data["oub"]
    targets = data["targets"]

    # 1. elementwise unconstrained minimization
    zd = _bounds_to_sigmoid(start_diag, dlb, dub)
    zd = _lbfgs_fixed_fan(lambda z: _diag_loss(_sigmoid_to_bounds(z, dlb, dub), data),
                          zd, lbfgs_steps)
    zo = _bounds_to_sigmoid(start_off, olb, oub)
    if off_active:
        zo = _lbfgs_fixed_fan(lambda z: _off_loss(_sigmoid_to_bounds(z, olb, oub), data),
                              zo, lbfgs_steps)

    # 2. constrained passes; the constraints are RELATIVE violations
    # (avgs / target - 1), so one penalty scale fits population, energy and
    # purity alike.  The diagonal pass holds purity only without a coherence.
    n_cons_diag = 2 if off_active else 3
    cons_scale = torch.clamp(torch.abs(targets), min=1e-3)

    def diag_lc(z):
        states = _diag_states(_sigmoid_to_bounds(z, dlb, dub), data)
        avgs = _averages_from_states(states, None, data)
        cons = ((avgs - targets) / cons_scale)[..., :n_cons_diag]
        return _diag_loss_from_states(states, data), cons

    zd, lam_diag = _al_minimize(zd, diag_lc, lam0[0][:n_cons_diag], lbfgs_steps, al_outer)
    lam_full = lam0[1][:3]

    if off_active:
        nd = zd.numel()
        zall = torch.cat([zd.reshape(-1), zo])

        def full_lc(z):
            lengths = _sigmoid_to_bounds(z[..., :nd].reshape(z.shape[:-1] + zd.shape), dlb, dub)
            dstates = _diag_states(lengths, data)
            ostate = _off_state(_sigmoid_to_bounds(z[..., nd:], olb, oub), data)
            avgs = _averages_from_states(dstates, ostate, data)
            loss = (_diag_loss_from_states(dstates, data)
                    + _off_loss_from_state(ostate, data))
            return loss, (avgs - targets) / cons_scale

        zall, lam_full = _al_minimize(zall, full_lc, lam0[1], lbfgs_steps, al_outer)
        zd = zall[:nd].reshape(zd.shape)
        zo = zall[nd:]

    with torch.no_grad():
        diag_lengths = _sigmoid_to_bounds(zd, dlb, dub)
        off_flat = _sigmoid_to_bounds(zo, olb, oub)
        dstates = _diag_states(diag_lengths, data)
        ostate = _off_state(off_flat, data) if off_active else None
        error = _diag_loss_from_states(dstates, data)
        if off_active:
            error = error + _off_loss_from_state(ostate, data)
        avgs = _averages_from_states(dstates, ostate, data)
        lam_out = torch.stack([
            torch.cat([lam_diag, torch.zeros(3 - n_cons_diag, dtype=lam_diag.dtype,
                                             device=lam_diag.device)]),
            lam_full])
    return diag_lengths, off_flat, error, avgs, lam_out


def _halton(n: int, d: int) -> np.ndarray:
    """First ``n`` points of the ``d``-dimensional Halton sequence in (0,1)."""
    all_primes = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)
    if d > len(all_primes):
        raise ValueError(f"_halton supports d <= {len(all_primes)}, got {d}")
    out = np.empty((n, d))
    for j, b in enumerate(all_primes[:d]):
        for i in range(1, n + 1):
            f, x, k = 1.0, 0.0, i
            while k > 0:
                f /= b
                x += f * (k % b)
                k //= b
            out[i - 1, j] = x
    return out


@torch.no_grad()
def _global_candidates(data):
    """The global stage's diagonal start: the GLOBAL_STARTS Halton points of
    the log-bounds box (the reference's DIRECT_L role, opt.cpp:1349-1383),
    evaluated as one batched fit; the one with the smallest unconstrained
    loss."""
    dlb, dub = data["dlb"], data["dub"]
    u = torch.tensor(_halton(GLOBAL_STARTS, dlb.numel()).reshape(
        (GLOBAL_STARTS,) + tuple(dlb.shape)), dtype=dlb.dtype, device=dlb.device)
    lengths = dlb * (dub / dlb) ** u
    return _take(lengths, torch.argmin(_diag_loss(lengths, data)))


@torch.no_grad()
def _global_candidates_off(data):
    """Halton sweep of the coherence's own parameter box (opt.cpp:372-384):
    magnitudes and lengths in log space, the correlation linearly (a zero-
    width axis under ``reference_parity``); the candidate with the smallest
    unconstrained loss."""
    olb, oub = data["olb"], data["oub"]
    d = olb.shape[0]
    u = torch.tensor(_halton(GLOBAL_STARTS, d), dtype=olb.dtype, device=olb.device)
    log_axes = torch.arange(d, device=olb.device) < d - 1
    safe_lb = torch.where(log_axes, torch.clamp(olb, min=1e-30), olb)
    offs = torch.where(log_axes, safe_lb * (oub / safe_lb) ** u, olb + (oub - olb) * u)
    return _take(offs, torch.argmin(_off_loss(offs, data)))


@torch.no_grad()
def _analytic_magnitudes(diag_lengths, off_flat, data):
    mags = RK.optimal_magnitude(_diag_states(diag_lengths, data))
    return mags, CK.optimal_magnitude_complex(_off_state(off_flat, data))


def _fit_once_diagnostics(diag_lengths, off_flat, data, block_diag: bool = False):
    """ONE fit of every element -> (error, analytic magnitudes (2,), coherence
    magnitude): the run.log error and the magnitudes from the same states."""
    dstates = _diag_states(diag_lengths, data)
    ostate = _off_state(off_flat, data, block_diag)
    err = _diag_loss_from_states(dstates, data) + _off_loss_from_state(ostate, data)
    return err, RK.optimal_magnitude(dstates), CK.optimal_magnitude_complex(ostate)


def _host(*tensors):
    """Host numpy copies of device tensors, through one device-to-host copy."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        out.append(flat[at: at + t.numel()].reshape(tuple(t.shape)))
        at += t.numel()
    return out


class OptResult(NamedTuple):
    error: float
    steps: list
    opt_type: str


@dataclasses.dataclass
class Optimizer:
    """Targets, parameter state, and the restart ladder
    (reference class Optimization, opt.h:17-105)."""

    model: str
    mass: float
    total_energy: float
    purity: float
    sigma_r0: np.ndarray                  # initial characteristic-length guess
    diag_lengths: np.ndarray = None       # (2, PhaseDim)
    off_params: np.ndarray = None         # (7,): m_R, l_R(2), m_I, l_I(2), corr
    diag_magnitudes: np.ndarray = None    # (2,) analytic magnitudes
    off_magnitude: float = 1.0
    #: the ladder's L-BFGS step budget (also reported in run.log)
    lbfgs_steps: int = LBFGS_STEPS
    #: (lb, ub) of the learnable Re-Im correlation; lb = ub = 1 pins the
    #: reference kernel (complex_kernel.h:12-13): the sigmoid-bounds transform
    #: collapses a zero-width box to its value
    corr_bounds: tuple = (-CORR_BOUND, CORR_BOUND)
    #: "moment" (closed form) or "ladder" (the constrained restart ladder)
    opt_mode: str = "moment"
    #: coherence lengthscale divisor (off lengths = weighted std / off_len_div)
    off_len_div: float = 2.0
    #: device of the tensors :meth:`fitted_params` builds (set by each
    #: :meth:`optimize` to the data's device)
    device: "str | torch.device" = "cuda"

    def __post_init__(self):
        self.sigma_r0 = np.asarray(self.sigma_r0, dtype=np.float64)
        if self.diag_lengths is None:
            self.diag_lengths = np.tile(self.sigma_r0, (2, 1))
        if self.off_params is None:
            self.off_params = self._initial_off()
        elif np.asarray(self.off_params).shape[0] == 2 * len(self.sigma_r0) + 2:
            # a parameter vector from before the learnable corr (an old
            # checkpoint): corr = 1 is the reference kernel it was fitted with
            self.off_params = np.concatenate([np.asarray(self.off_params), [1.0]])
        if self.diag_magnitudes is None:
            self.diag_magnitudes = np.ones(2)
        #: (2, 3) warm-start AL multipliers (diagonal pass, full pass) of the
        #: last reoptimization; None until the first one completes
        self._al_lam = None

    def _initial_off(self):
        # corr starts at 0 (independent Re/Im), the neutral point of [-1, 1]
        return np.concatenate(
            [[INITIAL_MAGNITUDE], self.sigma_r0, [INITIAL_MAGNITUDE], self.sigma_r0, [0.0]])

    # -- bounds from the point cloud (opt.cpp:1026-1052) ---------------------------
    @staticmethod
    def length_bounds(points):
        """(lower, upper) length bounds of a host (N, D) cloud."""
        n = points.shape[0]
        mean = np.mean(points, axis=0)
        std = np.sqrt(np.maximum(np.mean(points**2, axis=0) - mean**2, 0.0))
        std = np.maximum(std, MIN_CHAR_LENGTH)
        return np.maximum(std / np.sqrt(n), MIN_CHAR_LENGTH), 2.0 * std

    def _pack_data(self, density: Density, extra: Density, surface_energies):
        """The fit data on the device and the host copy of ``density.active``;
        the ladder's length bounds and constraint targets too (from one host
        copy of the points) when ``opt_mode="ladder"``."""
        active = density.active.cpu().numpy()
        dtype = density.points.dtype
        data = dict(
            dpts=density.points[_DIAG],
            drho=density.rho[_DIAG][..., 0],
            depts=extra.points[_DIAG],
            derho=extra.rho[_DIAG][..., 0],
            opts=density.points[OFFDIAG_INDEX],
            orho=density.rho[OFFDIAG_INDEX],
            oepts=extra.points[OFFDIAG_INDEX],
            oerho=extra.rho[OFFDIAG_INDEX],
            dmask=density.active[_DIAG].to(dtype),
            omask=density.active[OFFDIAG_INDEX].to(dtype),
            energies=surface_energies,
        )
        if self.opt_mode == "ladder":
            pts = density.points.cpu().numpy()
            dlb, dub = zip(*(self.length_bounds(pts[k]) for k in DIAG_INDICES))
            olb, oub = self.length_bounds(pts[OFFDIAG_INDEX])
            lo, hi = self.corr_bounds
            host = dict(
                dlb=np.stack(dlb), dub=np.stack(dub),
                olb=np.concatenate([[COMPLEX_MAG_LB], olb, [COMPLEX_MAG_LB], olb, [lo]]),
                oub=np.concatenate([[COMPLEX_MAG_UB], oub, [COMPLEX_MAG_UB], oub, [hi]]),
                targets=np.array([1.0, self.total_energy, self.purity]))
            data.update({k: torch.tensor(v, dtype=dtype, device=density.points.device)
                         for k, v in host.items()})
        return data, active

    # -- the main entry (reference Optimization::optimize, opt.cpp:1019) -----------
    def optimize(self, density: Density, extra: Density, surface_energies) -> OptResult:
        """Reoptimize on the device of ``density``.  The ladder differentiates,
        so it runs outside any inference mode of the caller, on copies of the
        data, with grad mode on."""
        self.device = density.points.device
        if self.opt_mode == "moment":
            data, active = self._pack_data(density, extra, surface_energies)
            return self._moment_impl(density, data, active)
        if self.opt_mode != "ladder":
            raise ValueError(f"Optimizer: unknown opt_mode {self.opt_mode!r}")
        with torch.inference_mode(False), torch.enable_grad():
            data, active = self._pack_data(density, extra, surface_energies)
            data = {k: v.clone() if isinstance(v, torch.Tensor) else
                    torch.as_tensor(v, dtype=density.points.dtype, device=self.device)
                    for k, v in data.items()}
            return self._ladder_impl(data, active)

    def _ladder_impl(self, data, active) -> OptResult:
        """The three-stage restart ladder (opt.cpp:1200-1392)."""
        off_active = bool(active[OFFDIAG_INDEX])
        f64 = dict(dtype=data["dlb"].dtype, device=data["dlb"].device)
        bounds = {k: data[k].cpu().numpy() for k in ("dlb", "dub", "olb", "oub")}

        def run(start_diag, start_off, tag):
            # the warm stage reuses the previous reopt's converged multipliers
            # and spends half the outer updates; cold restarts start from zero
            t0 = time.perf_counter()
            warm = tag == "local_previous" and self._al_lam is not None
            lam0 = torch.tensor(self._al_lam if warm else np.zeros((2, 3)), **f64)
            out = _run_stage(torch.tensor(start_diag, **f64), torch.tensor(start_off, **f64),
                             lam0, data, off_active, self.lbfgs_steps,
                             AL_OUTER // 2 if warm else AL_OUTER)
            dl, of, err, avgs, lam = _host(*out)
            return dict(diag_lengths=dl, off_params=of, error=float(err),
                        check=self._check_averages(avgs, off_active), tag=tag, lam=lam,
                        averages=avgs, seconds=time.perf_counter() - t0)

        # clip starts into the current bounds (move_into_bounds, opt.cpp:1054-1067)
        def clipped(diag, off):
            return (np.clip(diag, bounds["dlb"], bounds["dub"]),
                    np.clip(off, bounds["olb"], bounds["oub"]))

        #: the stages of this call, in order: their results, constraint checks
        #: and host walls (each ends with the pull of its results)
        self.stages = []
        res = run(*clipped(self.diag_lengths, self.off_params), "local_previous")
        self.stages.append(res)
        if not self._accepts(res):
            init_diag = np.tile(self.sigma_r0, (2, 1))
            res2 = run(*clipped(init_diag, self._initial_off()), "local_initial")
            self.stages.append(res2)
            res = self._compare(res, res2)
            if not self._accepts(res):
                (gdiag,) = _host(_global_candidates(data))
                if off_active:
                    (goff,) = _host(_global_candidates_off(data))
                else:
                    goff = np.concatenate([[1.0], gdiag[0], [1.0], gdiag[0], [0.0]])
                res3 = run(*clipped(gdiag, goff), "global")
                self.stages.append(res3)
                res = self._compare(res, res3)
        mags, off_mag = _host(*_analytic_magnitudes(
            torch.tensor(res["diag_lengths"], **f64), torch.tensor(res["off_params"], **f64),
            data))
        return self._finish(dict(res, mags=mags, off_mag=float(off_mag)), active)

    # -- moment-based hyperparameters (opt_mode="moment") ---------------------------
    def _moment_impl(self, density: Density, data, active) -> OptResult:
        """Moment-based hyperparameters: no search, no constraints.  The new
        parameters, the error and the magnitudes reach the host in one pull."""
        pts, rho = density.points, density.rho
        f64 = dict(dtype=pts.dtype, device=pts.device)
        diag = torch.tensor(self.diag_lengths, **f64)
        for d, k in enumerate(DIAG_INDICES):
            if active[k]:
                diag[d] = _wstd(pts[k], rho[k, :, 0]) / 2.0
        if active[OFFDIAG_INDEX]:
            o, orho = pts[OFFDIAG_INDEX], rho[OFFDIAG_INDEX]
            lr = _wstd(o, orho[:, 0]) / self.off_len_div
            li = _wstd(o, orho[:, 1]) / self.off_len_div
            mr = torch.sqrt(torch.mean(orho[:, 0] ** 2)) + 1e-30
            mi = torch.sqrt(torch.mean(orho[:, 1] ** 2)) + 1e-30
            off = torch.cat([mr[None], lr, mi[None], li, torch.zeros(1, **f64)])
            corr = 0.0
        else:
            off = torch.tensor(self.off_params, **f64)
            corr = float(self.off_params[-1])
        err, mags, off_mag = _fit_once_diagnostics(diag, off, data, corr == 0.0)
        host = torch.cat([diag.reshape(-1), off, err[None], mags, off_mag[None]]).cpu()
        host = host.numpy()
        nd = diag.numel()
        res = dict(diag_lengths=host[:nd].reshape(diag.shape),
                   off_params=host[nd: nd + off.numel()], error=float(host[-4]),
                   tag="moment", mags=host[-3:-1], off_mag=float(host[-1]),
                   lam=self._al_lam if self._al_lam is not None else np.zeros((2, 3)))
        return self._finish(res, active)

    def _check_averages(self, avgs, off_active) -> np.ndarray:
        """Relative deviations from the targets beyond the 5% tolerance (0 inside)."""
        targets = np.asarray([1.0, self.total_energy, self.purity])
        rel = np.abs(avgs / targets - 1.0)
        return np.where(rel < AVERAGE_TOLERANCE, 0.0, rel)

    @staticmethod
    def _accepts(res) -> bool:
        return bool(np.all(res["check"] == 0.0))

    @staticmethod
    def _compare(old, new) -> dict:
        """compare_and_overwrite (opt.cpp:1272-1318)."""
        c_old, c_new = old["check"], new["check"]
        better = int(np.sum((c_new < c_old) & (c_old > 2 * AVERAGE_TOLERANCE)))
        worse = int(np.sum((c_new > c_old) & (c_new > 2 * AVERAGE_TOLERANCE)))
        if better > worse or (better == worse and c_new.sum() < c_old.sum()):
            return new
        if better == worse and new["error"] < old["error"]:
            return new
        return old

    def _finish(self, res, active) -> OptResult:
        self.diag_lengths = res["diag_lengths"]
        self.off_params = res["off_params"]
        self._al_lam = res["lam"]
        self.diag_magnitudes = np.where(active[_DIAG], res["mags"], 1.0)
        self.off_magnitude = res["off_mag"] if active[OFFDIAG_INDEX] else 1.0
        return OptResult(error=res["error"], steps=[self.lbfgs_steps], opt_type=res["tag"])

    # -- fitted parameters ----------------------------------------------------------
    def fitted_params(self):
        """(diag KernelParams with analytic magnitudes, ComplexKernelParams) on
        :attr:`device`, from one host-to-device copy."""
        lengths = np.asarray(self.diag_lengths, dtype=np.float64)
        flat = torch.tensor(np.concatenate([
            np.asarray(self.diag_magnitudes, dtype=np.float64), lengths.ravel(),
            np.asarray(self.off_params, dtype=np.float64), [self.off_magnitude]]),
            dtype=torch.float64, device=self.device)
        nl = lengths.size
        diag = RK.KernelParams(magnitude=flat[:2], lengths=flat[2: 2 + nl].reshape(
            lengths.shape), noise=torch.full_like(flat[:2], INITIAL_NOISE))
        off = flat[2 + nl: -1]
        d = (off.shape[0] - 3) // 2
        off_p = CK.ComplexKernelParams(
            magnitude=flat[-1],
            real_magnitude=off[0],
            real_lengths=off[1: 1 + d],
            imag_magnitude=off[1 + d],
            imag_lengths=off[2 + d: 2 + 2 * d],
            noise=torch.full_like(flat[-1], INITIAL_NOISE),
            corr=off[-1],
        )
        return diag, off_p
