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

The inner solver is chosen by :func:`_lbfgs_scan`'s ``line_search``:

* ``"zoom"`` (the default on every device) is :func:`_lbfgs_zoom`, optax
  0.2.6's ``lbfgs()`` -- memory 10, the scaled initial preconditioner and
  the zoom line search (Nocedal & Wright 3.5/3.6 with Hager-Zhang's
  approximate-Wolfe test) -- translated formula for formula.  It is the
  branch the JAX package's ``_lbfgs_scan`` takes on the CPU, where its
  ``Optimizer.device="cpu"`` pins the ladder, so the JAX ladder always runs
  it.  Its loop is data dependent: the line search's scalars live on the
  host and every loss evaluation costs one device-to-host pull
  (the counters ``zoom.<name>`` of :data:`ZOOM_COUNTERS` count them,
  :mod:`gple_tpu_torch.utils.spans`).  On a CUDA device the ladder's
  evaluations (value, gradient and slope) run as CUDA graphs: one
  :class:`ZoomGraph` per loss kind and shape (:data:`ZOOM_KINDS`), owned by
  the optimizer's :class:`ZoomGraphs`, captured at its first evaluation and
  replayed by every later one of every solve, outer update, stage and
  ladder of the optimizer, with the point, the multipliers, the penalty and
  the fit data copied into its static buffers (``zoom.replays`` counts the
  replays).  On the CPU, and in every other caller of the zoom (the
  validation fits), each evaluation is an eager autograd pass of the
  closure.
* ``"fan"`` is :func:`_lbfgs_fixed_fan`, the JAX package's accelerator
  branch: a two-loop recursion and a line search over a fixed fan of step
  scales whose candidates are ONE batched fit (a leading batch axis on every
  loss), with no data-dependent control flow, so no step waits for the host.

Gradients come from ``torch.autograd`` through the Cholesky and the kernels'
autograd Functions (``gram_kernels.RBFGram`` / ``RBFPredictMean``).

The optimizer runs on the device of the data it is given.  Its parameter
state stays on the host as numpy arrays, as in the JAX package;
:meth:`Optimizer.fitted_params` builds the tensors the fit reads.
Elsewhere in the package the state is set only through the constructor,
:meth:`~Optimizer.like`, :meth:`~Optimizer.restore` and
:meth:`~Optimizer.adopt`, and read through :meth:`~Optimizer.snapshot`.
:func:`pack_off` and :func:`unpack_off` alone build and slice the
coherence's 2D + 3 parameter vector.
:func:`moment_kernel_params` is the per-tick moment tracking
(``GPLEConfig.moment_per_tick``) and ``Optimizer.coh_fit_extra`` the
booster's share of the moment statistics.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from gple_tpu_torch.ops import complex_kernels as CK
from gple_tpu_torch.ops import graphs as GR
from gple_tpu_torch.ops import kernels as RK
from gple_tpu_torch.storage import DIAG_INDICES, OFFDIAG_INDEX, Density, diag_rows
from gple_tpu_torch.utils import spans

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


def off_moments(points, rho, off_len_div: float):
    """The coherence's moment parameters ``(m_R, l_R, m_I, l_I)`` of the cloud
    ``points`` (N, D) with labels ``rho`` (N, 2): the label RMS of each part
    and its |label|-weighted std over ``off_len_div``."""
    lr = _wstd(points, rho[:, 0]) / off_len_div
    li = _wstd(points, rho[:, 1]) / off_len_div
    mr = torch.sqrt(torch.mean(rho[:, 0] ** 2)) + 1e-30
    mi = torch.sqrt(torch.mean(rho[:, 1] ** 2)) + 1e-30
    return mr, lr, mi, li


def pack_off(real_magnitude, real_lengths, imag_magnitude, imag_lengths, corr):
    """The coherence's parameter vector ``(m_R, l_R(D), m_I, l_I(D), corr)``,
    2D + 3 entries: the form of :attr:`Optimizer.off_params`, of the
    ladder's search and of its bounds.  One tensor from tensors (0-d
    magnitudes and corr), else one host float64 array.  :func:`unpack_off`
    splits it; :meth:`ComplexKernelParams.to_flat` is another form (2D + 5:
    the global magnitude and the noise too)."""
    parts = (real_magnitude, real_lengths, imag_magnitude, imag_lengths, corr)
    if isinstance(real_lengths, torch.Tensor):
        return torch.cat([p.reshape(-1) for p in parts])
    return np.concatenate([np.ravel(p) for p in parts])


def unpack_off(off, magnitude, noise) -> "CK.ComplexKernelParams":
    """:func:`pack_off`'s vector ``off`` (..., 2D + 3), tensor or host array,
    as a :class:`ComplexKernelParams` (views of ``off``) with the global
    ``magnitude`` and ``noise``."""
    d = (off.shape[-1] - 3) // 2
    return CK.ComplexKernelParams(
        magnitude=magnitude,
        real_magnitude=off[..., 0],
        real_lengths=off[..., 1: 1 + d],
        imag_magnitude=off[..., 1 + d],
        imag_lengths=off[..., 2 + d: 2 + 2 * d],
        noise=noise,
        corr=off[..., -1],
    )


def moment_kernel_params(density: Density, prev_diag: "RK.KernelParams",
                         prev_off: "CK.ComplexKernelParams", off_extra=None,
                         off_len_div: float = 2.0, track_diag: bool = True):
    """The moment parameters of the current cloud, on the device
    (``gple_tpu/gp/opt.py:87-137``): the per-tick tracking of
    ``GPLEConfig.moment_per_tick``.  Diagonal lengths (``track_diag``) are
    the |label|-weighted cloud std / 2 of each active element; the coherence
    lengths the weighted std of its cloud -- with the booster points
    ``off_extra = (points (k, D), rho (k, 2))`` joined -- over
    ``off_len_div``, its sub-kernel magnitudes the label RMS.  Magnitudes,
    noise and corr carry over from ``prev``, as do inactive elements'
    parameters."""
    if track_diag:
        lens = torch.stack([_wstd(density.points[k], density.rho[k, :, 0])
                            for k in DIAG_INDICES]) / 2.0
        diag = prev_diag._replace(lengths=torch.where(
            diag_rows(density.active)[:, None], lens, prev_diag.lengths))
    else:
        diag = prev_diag
    o_pts, o_rho = density.points[OFFDIAG_INDEX], density.rho[OFFDIAG_INDEX]
    if off_extra is not None:
        o_pts = torch.cat([o_pts, off_extra[0]])
        o_rho = torch.cat([o_rho, off_extra[1]])
    mr, lr, mi, li = off_moments(o_pts, o_rho, off_len_div)
    act = density.active[OFFDIAG_INDEX]
    off = prev_off._replace(
        real_magnitude=torch.where(act, mr, prev_off.real_magnitude),
        real_lengths=torch.where(act, lr, prev_off.real_lengths),
        imag_magnitude=torch.where(act, mi, prev_off.imag_magnitude),
        imag_lengths=torch.where(act, li, prev_off.imag_lengths))
    return diag, off


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
    """The coherence fitted at unit magnitude; ``off_flat`` (..., 2D + 3) is
    :func:`pack_off`'s vector."""
    one = torch.ones((), dtype=off_flat.dtype, device=off_flat.device)
    params = unpack_off(off_flat, one, one * INITIAL_NOISE)
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
    with spans.span("wait"):
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


#: optax 0.2.6 ``lbfgs()`` as the JAX package builds it (``alias.py:2591-2600``,
#: ``linesearch.py:1331``): history 10, the zoom line search with at most 20
#: steps, its sufficient-decrease / curvature / approximate-decrease
#: tolerances, the interval below which a decreasing step is taken, and the
#: interval search's growth factor
ZOOM_MEMORY = 10
ZOOM_LINESEARCH_STEPS = 20
ZOOM_SLOPE_RTOL = 1e-4
ZOOM_CURV_RTOL = 0.9
ZOOM_APPROX_DEC_RTOL = 1e-6
ZOOM_STEPSIZE_PRECISION = 1e-5
ZOOM_INCREASE_FACTOR = 2.0
#: the zoom solve stops when the sup-norm of the L-BFGS update falls below this
ZOOM_XTOL = 1e-7
#: the zoom's counters, each ``zoom.<name>`` in the spans' collections:
#: solves, L-BFGS iterations, loss evaluations (value and gradient) and
#: device-to-host pulls
ZOOM_COUNTERS = ("solves", "iterations", "evaluations", "syncs")

_f = np.float64


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (optax ``_cubicmin``); NaN where there is none."""
    C = fpa
    db = b - a
    dc = c - a
    dbdc = db * dc
    denom = dbdc * dbdc * (db - dc)
    u = fb - fa - C * db
    v = fc - fa - C * dc
    A = (dc * dc * u + -(db * db) * v) / denom
    B = (-(dc * (dc * dc)) * u + db * (db * db) * v) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a (optax ``_quadmin``)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (2.0 * B)


def _decrease_error(step, value, slope, value_init, slope_init):
    """Armijo error, or Hager-Zhang's approximate one near the minimum; 0 when
    satisfied, inf for NaN (optax ``_compute_decrease_error``)."""
    armijo = value - value_init - ZOOM_SLOPE_RTOL * step * slope_init
    approx = slope - (2 * ZOOM_SLOPE_RTOL - 1.0) * slope_init
    approx = np.maximum(approx, value - value_init - ZOOM_APPROX_DEC_RTOL * np.abs(value_init))
    err = np.maximum(np.minimum(approx, armijo), 0.0)
    return _f(np.inf) if np.isnan(err) else err


def _curvature_error(slope, slope_init):
    err = np.maximum(np.abs(slope) - ZOOM_CURV_RTOL * np.abs(slope_init), 0.0)
    return _f(np.inf) if np.isnan(err) else err


def _lbfgs_zoom(fn, z0, steps: int, evaluate=None):
    """optax's ``lbfgs()`` with its zoom line search, run as the JAX
    package's ``_lbfgs_zoom`` runs it: at most ``steps`` iterations, stopping
    once the sup-norm of the update is at most :data:`ZOOM_XTOL`, with NaNs
    of the gradient and the update zeroed.

    ``fn`` maps a batch ``(1,) + z0.shape`` to ``(1,)`` losses; each
    evaluation differentiates it eagerly.  ``evaluate`` (a
    :class:`ZoomGraph`), where given, takes the place of that evaluation:
    ``evaluate(z, u)`` of a flat point and direction returns the loss, its
    gradient and the slope along ``u``.  The L-BFGS memory and every vector
    stay on the device; the line search's scalars (values, slopes, step
    sizes) are numpy float64 on the host, one pull per loss evaluation plus
    one per iteration.  The interval search, the cubic / quadratic /
    bisection choice, the safeguarded step and the approximate-Wolfe test
    follow ``optax/_src/linesearch.py`` formula for formula."""
    shape = z0.shape
    z = z0.detach().reshape(-1)
    d = z.shape[0]
    m = ZOOM_MEMORY
    f64 = dict(dtype=z.dtype, device=z.device)
    dw = torch.zeros((m, d), **f64)      # parameter differences
    du = torch.zeros((m, d), **f64)      # gradient differences
    rhos = torch.zeros((m,), **f64)
    prev_z, prev_g = z, z
    spans.count("zoom.solves")

    def value_grad(zz, u=None):
        """The loss and its gradient at ``zz``, and the slope along ``u``."""
        spans.count("zoom.evaluations")
        if evaluate is not None:
            return evaluate(zz, u)
        zz = zz.detach().requires_grad_(True)
        with torch.enable_grad():
            value = fn(zz.reshape((1,) + shape))[0]
            (grad,) = torch.autograd.grad(value, zz, allow_unused=True)
        grad = torch.zeros_like(zz) if grad is None else grad
        return value.detach(), grad, None if u is None else torch.dot(grad, u)

    def pull(*scalars):
        spans.count("zoom.syncs")
        with spans.span("wait"):
            return [_f(v) for v in torch.stack(scalars).tolist()]

    value, grad = _f(np.inf), None       # the line search's last value and gradient
    count, it, dz = 0, 0, np.inf
    while it < steps and dz > ZOOM_XTOL:
        fresh = not np.isfinite(value)
        if fresh:
            value_t, grad, _ = value_grad(z)
        grad = torch.nan_to_num(grad)
        # -- scale_by_lbfgs: store the newest pair, then the two-loop product
        if count > 0:
            s, y = z - prev_z, grad - prev_g
            sy = torch.dot(y, s)
            i = (count - 1) % m
            dw[i], du[i] = s, y
            rhos[i] = torch.where(sy == 0.0, 0.0, 1.0 / sy)
            yy = torch.dot(y, y)
            gamma = torch.where(yy > 0.0, sy / yy, 1.0)
        else:
            gamma = torch.clamp(1.0 / torch.sqrt(torch.dot(grad, grad)), max=1.0)
        order = [(count + j) % m for j in range(m)]
        vec, alphas = grad, [None] * m
        for j in reversed(range(m)):
            i = order[j]
            alphas[j] = rhos[i] * torch.dot(dw[i], vec)
            vec = vec - alphas[j] * du[i]
        vec = gamma * vec
        for j in range(m):
            i = order[j]
            vec = vec + (alphas[j] - rhos[i] * torch.dot(du[i], vec)) * dw[i]
        count += 1
        prev_z, prev_g = z, grad
        u = -vec
        scalars = [torch.dot(u, grad), torch.amax(torch.abs(torch.nan_to_num(u)))]
        if fresh:
            value, slope0, umax = pull(value_t, *scalars)
        else:
            slope0, umax = pull(*scalars)

        # -- the zoom line search along u
        def on_line(step):
            v, g, slope = value_grad(z + float(step) * u, u)
            vh, sh = pull(v, slope)
            return vh, g, sh

        v0 = value
        step, cur_v, cur_g, cur_s = _f(0.0), v0, grad, slope0
        found = done = failed = False
        low, v_low, s_low = _f(0.0), v0, slope0
        high, v_high = _f(0.0), v0      # (optax's slope at high is never read)
        cref, v_cref = _f(0.0), v0
        safe, v_safe, g_safe = _f(0.0), v0, grad
        ls = 0
        with np.errstate(all="ignore"):
            while not (done or failed):
                if not found:
                    # interval search (Nocedal & Wright 3.5)
                    new = _f(1.0) if ls == 0 else ZOOM_INCREASE_FACTOR * step
                    nv, ng, ns = on_line(new)
                    de = _decrease_error(new, nv, ns, v0, slope0)
                    err = np.maximum(de, _curvature_error(ns, slope0))
                    if de <= 0.0:
                        safe, v_safe, g_safe = new, nv, ng
                    set_high = bool(de > 0.0) or (bool(nv >= cur_v) and ls > 0)
                    if bool(ns >= 0.0) and not set_high:
                        low, v_low, s_low, high, v_high = new, nv, ns, step, cur_v
                        found = True
                    else:
                        low, v_low, s_low, high, v_high = step, cur_v, cur_s, new, nv
                        found = set_high
                    done = bool(err <= 0.0)
                    found = found or done
                    failed = ls + 1 >= ZOOM_LINESEARCH_STEPS and not done
                    cref, v_cref = low, v_low
                else:
                    # zoom into [low, high] (Nocedal & Wright 3.6)
                    delta = np.abs(high - low)
                    left, right = np.minimum(high, low), np.maximum(high, low)
                    mid = _cubicmin(low, v_low, s_low, high, v_high, cref, v_cref)
                    if not (mid > left + 0.2 * delta and mid < right - 0.2 * delta):
                        mid = _quadmin(low, v_low, s_low, high, v_high)
                        if not (mid > left + 0.1 * delta and mid < right - 0.1 * delta):
                            mid = (low + high) / 2.0
                    nv, ng, ns = on_line(mid)
                    new = mid
                    de = _decrease_error(mid, nv, ns, v0, slope0)
                    err = np.maximum(de, _curvature_error(ns, slope0))
                    if de <= 0.0 and nv < v_safe:
                        safe, v_safe, g_safe = mid, nv, ng
                    done = bool(err <= 0.0)
                    high_to_mid = bool(de > 0.0) or bool(nv >= v_low)
                    high_to_low = bool(ns * (high - low) >= 0.0) and not high_to_mid
                    if high_to_mid or high_to_low:
                        cref, v_cref = high, v_high
                    else:
                        cref, v_cref = low, v_low
                    if high_to_mid:
                        high, v_high = mid, nv
                    else:
                        if high_to_low:
                            high, v_high = low, v_low
                        low, v_low, s_low = mid, nv, ns
                    failed = (ls + 1 >= ZOOM_LINESEARCH_STEPS
                              or (delta <= ZOOM_STEPSIZE_PRECISION and safe > 0.0)) and not done
                step, cur_v, cur_g, cur_s, dec_err = new, nv, ng, ns, de
                ls += 1
                if failed and (safe > 0.0 or np.isinf(dec_err)):
                    # the safeguarded step: the best sufficient decrease found
                    step, cur_v, cur_g = safe, v_safe, g_safe
        value, grad = cur_v, cur_g
        z = z + float(step) * u
        dz = float(np.abs(step) * umax)
        it += 1
        spans.count("zoom.iterations")
    return z.reshape(shape)


#: the inner solvers :func:`_lbfgs_scan` selects between
LINE_SEARCHES = ("zoom", "fan")


def _lbfgs_scan(fn, z0, steps: int, line_search: str = "zoom", evaluate=None):
    """The bounded L-BFGS inner solver: ``"zoom"`` (:func:`_lbfgs_zoom`, the
    JAX package's CPU branch and its ladder's default, with its optional
    graphed ``evaluate``) or ``"fan"`` (:func:`_lbfgs_fixed_fan`, its
    accelerator branch)."""
    if line_search == "zoom":
        return _lbfgs_zoom(fn, z0, steps, evaluate)
    if line_search == "fan":
        return _lbfgs_fixed_fan(fn, z0, steps)
    raise ValueError(f"_lbfgs_scan: unknown line_search {line_search!r}")


# -- the stage's losses as functions of the sigmoid coordinates ------------------------

def _cons_scale(targets):
    """The constraints' scale: they are RELATIVE violations (avgs / target -
    1), so one penalty scale fits population, energy and purity alike."""
    return torch.clamp(torch.abs(targets), min=1e-3)


def _diag_lc(z, data, n_cons: int):
    """The constrained diagonal pass at ``z (..., 2, D)``: the loss and the
    first ``n_cons`` relative constraint violations."""
    states = _diag_states(_sigmoid_to_bounds(z, data["dlb"], data["dub"]), data)
    avgs = _averages_from_states(states, None, data)
    cons = ((avgs - data["targets"]) / _cons_scale(data["targets"]))[..., :n_cons]
    return _diag_loss_from_states(states, data), cons


def _full_lc(z, data):
    """The constrained full pass at ``z (..., 2D + 2D + 3)`` (the diagonal
    lengths' coordinates, then the coherence's): the joint loss and the
    three relative constraint violations."""
    dlb = data["dlb"]
    nd = dlb.numel()
    lengths = _sigmoid_to_bounds(z[..., :nd].reshape(z.shape[:-1] + dlb.shape), dlb,
                                 data["dub"])
    dstates = _diag_states(lengths, data)
    ostate = _off_state(_sigmoid_to_bounds(z[..., nd:], data["olb"], data["oub"]), data)
    avgs = _averages_from_states(dstates, ostate, data)
    loss = _diag_loss_from_states(dstates, data) + _off_loss_from_state(ostate, data)
    return loss, (avgs - data["targets"]) / _cons_scale(data["targets"])


def _penalized(loss_and_cons, lam, mu):
    """The augmented Lagrangian loss + lam.c + mu/2 |c|^2 of ``loss_and_cons``;
    ``mu`` a number or a 0-d tensor."""
    def objective(z):
        loss, cons = loss_and_cons(z)
        return loss + torch.sum(lam * cons, dim=-1) + 0.5 * mu * torch.sum(cons**2, dim=-1)
    return objective


def _zoom_loss(kind: str, data, n_cons: int = 0, lam=None, mu=None):
    """The loss of a :data:`ZOOM_KINDS` kind as a function of a batch of
    sigmoid coordinates; the constrained kinds penalized by ``lam`` and
    ``mu``."""
    if kind == "diag":
        return lambda z: _diag_loss(_sigmoid_to_bounds(z, data["dlb"], data["dub"]), data)
    if kind == "off":
        return lambda z: _off_loss(_sigmoid_to_bounds(z, data["olb"], data["oub"]), data)
    if kind == "diag_lc":
        return _penalized(lambda z: _diag_lc(z, data, n_cons), lam, mu)
    if kind == "full_lc":
        return _penalized(lambda z: _full_lc(z, data), lam, mu)
    raise ValueError(f"_zoom_loss: unknown kind {kind!r}")


# -- the zoom's graphed evaluations ----------------------------------------------------

#: the zoom's loss kinds: the diagonal elementwise loss, the coherence's, the
#: constrained diagonal objective and the constrained full objective
ZOOM_KINDS = ("diag", "off", "diag_lc", "full_lc")


class ZoomGraph:
    """One loss kind's value and gradient as a :class:`~gple_tpu_torch.ops.
    graphs.Graph` of kind ``"zoom"`` that differentiates: over the static
    point ``z`` (flat), direction ``u``, multipliers ``lam`` and penalty
    ``mu`` (0-d), the fit data of its :class:`ZoomGraphs`, and the outputs
    ``value``, ``grad`` and ``slope`` (``grad . u``).  On a CUDA device the
    first call captures it and every call replays it (each replay counts
    ``zoom.replays``); on the CPU it runs eagerly, the same function over
    the same buffers."""

    def __init__(self, kind: str, z0, data, n_cons: int = 0):
        f64 = dict(dtype=z0.dtype, device=z0.device)
        self.shape = tuple(z0.shape)
        self.z = torch.zeros(z0.numel(), **f64)
        self.u = torch.zeros_like(self.z)
        self.lam = torch.zeros(n_cons, **f64)
        self.mu = torch.zeros((), **f64)
        self.value = torch.zeros((), **f64)
        self.grad = torch.zeros_like(self.z)
        self.slope = torch.zeros((), **f64)
        self.loss = _zoom_loss(kind, data, n_cons, self.lam, self.mu)
        self.graph = GR.Graph(self._evaluate, [self.z, self.u, self.lam, self.mu, self.value,
                                               self.grad, self.slope], "zoom", autograd=True)

    def _evaluate(self):
        z = self.z.detach().requires_grad_(True)
        value = self.loss(z.reshape((1,) + self.shape))[0]
        (grad,) = torch.autograd.grad(value, z, allow_unused=True)
        with torch.no_grad():
            self.value.copy_(value)
            if grad is None:
                self.grad.zero_()
            else:
                self.grad.copy_(grad)
            self.slope.copy_(torch.dot(self.grad, self.u))

    def penalty(self, lam, mu: float) -> None:
        """Set the multipliers and the penalty of the next solves."""
        self.lam.copy_(lam)
        self.mu.fill_(mu)

    def __call__(self, z, u=None):
        """(value, gradient, slope along ``u``) at the flat point ``z``; the
        value and slope are the buffers, valid until the next call."""
        self.z.copy_(z)
        if u is not None:
            self.u.copy_(u)
        self.graph()
        if self.graph.graph is not None:
            spans.count("zoom.replays")
        return self.value, self.grad.clone(), self.slope


class ZoomGraphs:
    """An optimizer's :class:`ZoomGraph` s, one per loss kind, point shape
    and number of constraints, over one static copy of the fit data, which
    :meth:`load` refills from each ladder's data (new buffers, and no
    graphs, when the data's shapes change)."""

    def __init__(self):
        self.data = None
        self.graphs = {}
        self._source = None

    def load(self, data) -> None:
        """Make ``data`` the fit data of every graph (a copy into the
        buffers, once for each data dict)."""
        if data is self._source:
            return
        layout = {k: (v.shape, v.dtype, v.device) for k, v in data.items()}
        if self.data is None or layout != {k: (v.shape, v.dtype, v.device)
                                           for k, v in self.data.items()}:
            self.data = {k: v.detach().clone() for k, v in data.items()}
            self.graphs = {}
        else:
            GR.copy_(self.data, data)
        self._source = data

    def get(self, kind: str, z0, n_cons: int = 0) -> ZoomGraph:
        key = (kind, tuple(z0.shape), n_cons)
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = ZoomGraph(kind, z0, self.data, n_cons)
        return graph


# -- one stage of the ladder -----------------------------------------------------------

def _al_minimize(z0, loss_and_cons, lam_init, lbfgs_steps: int, al_outer: int,
                 line_search: str = "zoom", evaluate=None):
    """Augmented-Lagrangian outer loop: ``al_outer`` L-BFGS solves of
    loss + lam.c + mu/2 |c|^2, each followed by lam += mu c, mu *= growth;
    ``evaluate`` (a :class:`ZoomGraph` of the same objective) takes each
    solve's lam and mu.  Returns (z, lam)."""
    z, lam, mu = z0, lam_init, AL_MU0
    for _ in range(al_outer):
        if evaluate is not None:
            evaluate.penalty(lam, mu)
        z = _lbfgs_scan(_penalized(loss_and_cons, lam, mu), z, lbfgs_steps, line_search,
                        evaluate)
        with torch.no_grad():
            _, cons = loss_and_cons(z)
        lam, mu = lam + mu * cons, mu * AL_MU_GROWTH
    return z, lam


def _run_stage(start_diag, start_off, lam0, data, off_active: bool,
               lbfgs_steps: int, al_outer: int, line_search: str = "zoom", graphs=None):
    """One complete do_optimize pass (opt.cpp:1101-1198): elementwise fits,
    then the constrained diagonal pass, then (when the coherence is active)
    the constrained full pass.  ``lam0``: (2, 3) warm-start multipliers of
    the (diagonal, full) passes, zeros for a cold start; ``line_search``
    the inner solver (:func:`_lbfgs_scan`); ``graphs`` (a
    :class:`ZoomGraphs`) evaluates the zoom's losses, each kind as one
    graph, where given.

    Returns (diag_lengths, off_flat, error, raw averages (3,), lam_out (2, 3))
    as device tensors."""
    dlb, dub = data["dlb"], data["dub"]
    olb, oub = data["olb"], data["oub"]
    graphed = graphs is not None and line_search == "zoom"
    if graphed:
        graphs.load(data)

    def evaluator(kind, z0, n_cons=0):
        return graphs.get(kind, z0, n_cons) if graphed else None

    # 1. elementwise unconstrained minimization
    zd = _bounds_to_sigmoid(start_diag, dlb, dub)
    zd = _lbfgs_scan(_zoom_loss("diag", data), zd, lbfgs_steps, line_search,
                     evaluator("diag", zd))
    zo = _bounds_to_sigmoid(start_off, olb, oub)
    if off_active:
        zo = _lbfgs_scan(_zoom_loss("off", data), zo, lbfgs_steps, line_search,
                         evaluator("off", zo))

    # 2. constrained passes; the diagonal pass holds purity only without a
    # coherence
    n_cons_diag = 2 if off_active else 3
    zd, lam_diag = _al_minimize(zd, lambda z: _diag_lc(z, data, n_cons_diag),
                                lam0[0][:n_cons_diag], lbfgs_steps, al_outer, line_search,
                                evaluator("diag_lc", zd, n_cons_diag))
    lam_full = lam0[1][:3]

    if off_active:
        nd = zd.numel()
        zall = torch.cat([zd.reshape(-1), zo])
        zall, lam_full = _al_minimize(zall, lambda z: _full_lc(z, data), lam0[1],
                                      lbfgs_steps, al_outer, line_search,
                                      evaluator("full_lc", zall, 3))
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
    with spans.span("wait"):
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
    with spans.span("wait"):
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


def fit_data(density: Density, extra: Density) -> dict:
    """The fit data of the losses and diagnostics: both diagonal elements'
    points and real labels and their extra points (``d*``), the coherence's
    (``o*``), and the activity masks as floats."""
    dtype = density.points.dtype
    return dict(
        dpts=diag_rows(density.points),
        drho=diag_rows(density.rho)[..., 0],
        depts=diag_rows(extra.points),
        derho=diag_rows(extra.rho)[..., 0],
        opts=density.points[OFFDIAG_INDEX],
        orho=density.rho[OFFDIAG_INDEX],
        oepts=extra.points[OFFDIAG_INDEX],
        oerho=extra.rho[OFFDIAG_INDEX],
        dmask=diag_rows(density.active).to(dtype),
        omask=density.active[OFFDIAG_INDEX].to(dtype),
    )


def _host(*tensors):
    """Host numpy copies of device tensors, through one device-to-host copy."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    with spans.span("wait"):
        flat = flat.cpu().numpy()
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
    off_params: np.ndarray = None         # (7,): pack_off's m_R, l_R(2), m_I, l_I(2), corr
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
    #: moment mode: the first ``coh_fit_extra`` off-diagonal extra points join
    #: the coherence's moment statistics, as they join its fit (the booster,
    #: GPLEConfig.coh_fit_extra)
    coh_fit_extra: int = 0
    #: the ladder's inner solver (:func:`_lbfgs_scan`): "zoom" or "fan"
    line_search: str = "zoom"
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
        #: the zoom's graphed loss evaluations of the ladders on a CUDA device:
        #: captured at each kind's first evaluation, replayed by every later
        #: one of this optimizer
        self._zoom_graphs = ZoomGraphs()

    #: the state that :meth:`optimize` and :meth:`adopt` replace (never write
    #: into): each attribute by its name in the checkpoint archive
    #: (:mod:`gple_tpu_torch.io.checkpoint`)
    _STATE = {"diag_lengths": "diag_lengths", "off_params": "off_params",
              "diag_magnitudes": "diag_magnitudes", "off_magnitude": "off_magnitude",
              "al_lam": "_al_lam"}

    @classmethod
    def like(cls, other, device) -> "Optimizer":
        """A copy of ``other``, an optimizer of this package or of the JAX
        package (whose fields are the same): its targets, settings, parameter
        state and multipliers, on ``device``."""
        opt = cls(
            model=other.model, mass=float(other.mass), total_energy=float(other.total_energy),
            purity=float(other.purity), sigma_r0=np.array(other.sigma_r0),
            diag_lengths=np.array(other.diag_lengths), off_params=np.array(other.off_params),
            diag_magnitudes=np.array(other.diag_magnitudes),
            off_magnitude=float(other.off_magnitude), lbfgs_steps=other.lbfgs_steps,
            corr_bounds=tuple(float(b) for b in other.corr_bounds), opt_mode=other.opt_mode,
            off_len_div=float(other.off_len_div), coh_fit_extra=int(other.coh_fit_extra),
            device=device)
        if other._al_lam is not None:
            opt._al_lam = np.array(other._al_lam)
        return opt

    def snapshot(self) -> dict:
        """The state (:attr:`_STATE`) by its archive names: the parameters,
        the analytic magnitudes and the warm AL multipliers ``al_lam`` (None
        before the first reoptimization)."""
        return {name: getattr(self, attr) for name, attr in self._STATE.items()}

    def restore(self, snap: dict) -> None:
        """Set the state named in ``snap``: a :meth:`snapshot`, or a part of one."""
        for name, value in snap.items():
            setattr(self, self._STATE[name], value)

    def adopt(self, diag: "RK.KernelParams", off: "CK.ComplexKernelParams",
              error) -> OptResult:
        """Take the parameters (host arrays) and the error of a moment reopt
        made on the device, as :meth:`optimize` would have left them;
        returns its result."""
        self.diag_lengths, self.diag_magnitudes = diag.lengths, diag.magnitude
        self.off_params = pack_off(off.real_magnitude, off.real_lengths, off.imag_magnitude,
                                   off.imag_lengths, off.corr)
        self.off_magnitude = float(off.magnitude)
        if self._al_lam is None:
            self._al_lam = np.zeros((2, 3))
        return OptResult(error=float(error), steps=[self.lbfgs_steps], opt_type="moment")

    @property
    def corr(self) -> float:
        """The coherence's Re-Im correlation."""
        return float(unpack_off(np.asarray(self.off_params), self.off_magnitude,
                                INITIAL_NOISE).corr)

    def _initial_off(self):
        # corr starts at 0 (independent Re/Im), the neutral point of [-1, 1]
        return pack_off(INITIAL_MAGNITUDE, self.sigma_r0, INITIAL_MAGNITUDE, self.sigma_r0, 0.0)

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
        (active,) = _host(density.active)
        data = dict(fit_data(density, extra), energies=surface_energies)
        if self.opt_mode == "ladder":
            (pts,) = _host(density.points)
            dlb, dub = zip(*(self.length_bounds(pts[k]) for k in DIAG_INDICES))
            olb, oub = self.length_bounds(pts[OFFDIAG_INDEX])
            lo, hi = self.corr_bounds
            host = dict(
                dlb=np.stack(dlb), dub=np.stack(dub),
                olb=pack_off(COMPLEX_MAG_LB, olb, COMPLEX_MAG_LB, olb, lo),
                oub=pack_off(COMPLEX_MAG_UB, oub, COMPLEX_MAG_UB, oub, hi),
                targets=np.array([1.0, self.total_energy, self.purity]))
            with spans.span("wait"):
                data.update({k: torch.tensor(v, dtype=density.points.dtype,
                                             device=density.points.device)
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
            k = min(int(self.coh_fit_extra), extra.points.shape[1])
            off_extra = ((extra.points[OFFDIAG_INDEX, :k], extra.rho[OFFDIAG_INDEX, :k])
                         if k > 0 else None)
            return self._moment_impl(density, data, active, off_extra)
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
        graphs = self._zoom_graphs if data["dlb"].device.type == "cuda" else None
        names = ("dlb", "dub", "olb", "oub")
        bounds = dict(zip(names, _host(*(data[k] for k in names))))

        def run(start_diag, start_off, tag):
            # the warm stage reuses the previous reopt's converged multipliers
            # and spends half the outer updates; cold restarts start from zero
            warm = tag == "local_previous" and self._al_lam is not None
            with spans.collect() as totals, spans.span("stage", tag=tag):
                with spans.span("wait"):
                    lam0 = torch.tensor(self._al_lam if warm else np.zeros((2, 3)), **f64)
                    starts = (torch.tensor(start_diag, **f64), torch.tensor(start_off, **f64))
                out = _run_stage(*starts, lam0, data, off_active, self.lbfgs_steps,
                                 AL_OUTER // 2 if warm else AL_OUTER, self.line_search,
                                 graphs)
                dl, of, err, avgs, lam = _host(*out)
            return dict(diag_lengths=dl, off_params=of, error=float(err),
                        check=self._check_averages(avgs, off_active), tag=tag, lam=lam,
                        averages=avgs, seconds=totals.seconds("stage"),
                        zoom={k: totals.count("zoom." + k) for k in ZOOM_COUNTERS})

        # clip starts into the current bounds (move_into_bounds, opt.cpp:1054-1067)
        def clipped(diag, off):
            return (np.clip(diag, bounds["dlb"], bounds["dub"]),
                    np.clip(off, bounds["olb"], bounds["oub"]))

        #: the stages of this call, in order: their results, constraint checks,
        #: host walls (the ``stage`` span, which ends with the pull of its
        #: results) and the zoom's counters (solves, iterations, loss
        #: evaluations, host pulls; zeros under the fan)
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
                    goff = pack_off(1.0, gdiag[0], 1.0, gdiag[0], 0.0)
                res3 = run(*clipped(gdiag, goff), "global")
                self.stages.append(res3)
                res = self._compare(res, res3)
        with spans.span("wait"):
            lengths = (torch.tensor(res["diag_lengths"], **f64),
                       torch.tensor(res["off_params"], **f64))
        mags, off_mag = _host(*_analytic_magnitudes(*lengths, data))
        return self._finish(dict(res, mags=mags, off_mag=float(off_mag)), active)

    # -- moment-based hyperparameters (opt_mode="moment") ---------------------------
    def _moment_impl(self, density: Density, data, active, off_extra=None) -> OptResult:
        """Moment-based hyperparameters: no search, no constraints; the
        booster points ``off_extra`` join the coherence's statistics.  The new
        parameters, the error and the magnitudes reach the host in one pull."""
        pts, rho = density.points, density.rho
        f64 = dict(dtype=pts.dtype, device=pts.device)
        with spans.span("wait"):
            diag = torch.tensor(self.diag_lengths, **f64)
        for d, k in enumerate(DIAG_INDICES):
            if active[k]:
                diag[d] = _wstd(pts[k], rho[k, :, 0]) / 2.0
        if active[OFFDIAG_INDEX]:
            o, orho = pts[OFFDIAG_INDEX], rho[OFFDIAG_INDEX]
            if off_extra is not None:
                o = torch.cat([o, off_extra[0]])
                orho = torch.cat([orho, off_extra[1]])
            mr, lr, mi, li = off_moments(o, orho, self.off_len_div)
            off = pack_off(mr, lr, mi, li, torch.zeros_like(mr))
            corr = 0.0
        else:
            with spans.span("wait"):
                off = torch.tensor(self.off_params, **f64)
            corr = self.corr
        err, mags, off_mag = _fit_once_diagnostics(diag, off, data, corr == 0.0)
        (host,) = _host(torch.cat([diag.reshape(-1), off, err[None], mags, off_mag[None]]))
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
        with spans.span("wait"):
            flat = torch.tensor(np.concatenate([
                np.asarray(self.diag_magnitudes, dtype=np.float64), lengths.ravel(),
                np.asarray(self.off_params, dtype=np.float64), [self.off_magnitude]]),
                dtype=torch.float64, device=self.device)
        nl = lengths.size
        diag = RK.KernelParams(magnitude=flat[:2], lengths=flat[2: 2 + nl].reshape(
            lengths.shape), noise=torch.full_like(flat[:2], INITIAL_NOISE))
        return diag, unpack_off(flat[2 + nl: -1], flat[-1],
                                torch.full_like(flat[-1], INITIAL_NOISE))

    def param_rows(self, points) -> list:
        """param.txt's (lower bound, parameters, upper bound) rows of the
        elements (00), (10), (11), the length bounds from the host clouds
        ``points`` (3, N, D); the correlation's box is the learnable one,
        (-CORR_BOUND, CORR_BOUND)."""
        rows = []
        for s, k in enumerate(DIAG_INDICES):
            lb, ub = self.length_bounds(points[k])
            rows.append(([1.0, *lb, INITIAL_NOISE],
                         [self.diag_magnitudes[s], *self.diag_lengths[s], INITIAL_NOISE],
                         [1.0, *ub, INITIAL_NOISE]))
        olb, oub = self.length_bounds(points[OFFDIAG_INDEX])
        rows.insert(1, tuple([mag, *off, INITIAL_NOISE] for mag, off in (
            (1.0, pack_off(COMPLEX_MAG_LB, olb, COMPLEX_MAG_LB, olb, -CORR_BOUND)),
            (self.off_magnitude, np.asarray(self.off_params)),
            (1.0, pack_off(COMPLEX_MAG_UB, oub, COMPLEX_MAG_UB, oub, CORR_BOUND)))))
        return rows
