"""GP hyperparameters: the moment optimizer (counterpart of :mod:`gple_tpu.gp.opt`).

Ported: the moment path (``opt_mode="moment"``), which sets the parameters in
closed form -- lengths = |label|-weighted cloud std / 2 per axis (coherence:
/ ``off_len_div``), Re/Im independent (corr = 0), analytic magnitudes from
one diagnostics fit whose LOOCV + extra-set error is the run.log error.
The constrained ladder (augmented-Lagrangian L-BFGS, the restart ladder, the
Halton global sweep) is not ported yet: ``opt_mode="ladder"`` raises
``NotImplementedError``.

The optimizer runs on the device of the data it is given.  The JAX package
pins it to the host CPU (``Optimizer.device``), which only served its TPU
backend.  Its parameter state stays on the host as numpy arrays, as in the
JAX package; :meth:`Optimizer.fitted_params` builds the tensors the fit reads.
"""

from __future__ import annotations

import dataclasses
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

_DIAG = list(DIAG_INDICES)


def _wstd(points, weights):
    """|weight|-weighted per-axis std of a cloud (N, D), floored."""
    w = torch.clamp(torch.abs(weights), min=1e-30)
    mu = (points.T @ w) / torch.sum(w)
    var = (((points - mu) ** 2).T @ w) / torch.sum(w)
    return torch.sqrt(torch.clamp(var, min=MIN_CHAR_LENGTH**2))


# -- losses of one fit --------------------------------------------------------------

def _diag_states(diag_lengths, data):
    """Both diagonal elements fitted at unit magnitude, as one batched state."""
    ones = torch.ones(2, dtype=diag_lengths.dtype, device=diag_lengths.device)
    params = RK.KernelParams(magnitude=ones, lengths=diag_lengths,
                             noise=torch.full_like(ones, INITIAL_NOISE))
    return RK.fit_real(params, data["dpts"], data["drho"])


def _diag_loss_from_states(states, data):
    loo = RK.loocv_error(states)
    extra = RK.extra_set_error(states, data["depts"], data["derho"])
    per_elem = torch.nan_to_num(loo + extra, nan=1e30, posinf=1e30)
    return torch.sum(per_elem * data["dmask"])


def _off_state(off_flat, data, block_diag: bool = False):
    # off_flat: (m_R, l_R(d), m_I, l_I(d), corr) -- 2d + 3 entries
    d = (off_flat.shape[0] - 3) // 2
    one = torch.ones((), dtype=off_flat.dtype, device=off_flat.device)
    params = CK.ComplexKernelParams(
        magnitude=one,
        real_magnitude=off_flat[0],
        real_lengths=off_flat[1: 1 + d],
        imag_magnitude=off_flat[1 + d],
        imag_lengths=off_flat[2 + d: 2 + 2 * d],
        noise=one * INITIAL_NOISE,
        corr=off_flat[-1],
    )
    return CK.fit_complex(params, data["opts"], data["orho"], block_diag=block_diag)


def _off_loss_from_state(state, data):
    loss = CK.loocv_error_complex(state) + CK.extra_set_error_complex(
        state, data["oepts"], data["oerho"])
    return torch.nan_to_num(loss, nan=1e30, posinf=1e30) * data["omask"]


def _fit_once_diagnostics(diag_lengths, off_flat, data, block_diag: bool = False):
    """ONE fit of every element -> (error, analytic magnitudes (2,), coherence
    magnitude): the run.log error and the magnitudes from the same states."""
    dstates = _diag_states(diag_lengths, data)
    ostate = _off_state(off_flat, data, block_diag)
    err = _diag_loss_from_states(dstates, data) + _off_loss_from_state(ostate, data)
    return err, RK.optimal_magnitude(dstates), CK.optimal_magnitude_complex(ostate)


class OptResult(NamedTuple):
    error: float
    steps: list
    opt_type: str


@dataclasses.dataclass
class Optimizer:
    """Targets and parameter state (reference class Optimization, opt.h:17-105)."""

    model: str
    mass: float
    total_energy: float
    purity: float
    sigma_r0: np.ndarray                  # initial characteristic-length guess
    diag_lengths: np.ndarray = None       # (2, PhaseDim)
    off_params: np.ndarray = None         # (7,): m_R, l_R(2), m_I, l_I(2), corr
    diag_magnitudes: np.ndarray = None    # (2,) analytic magnitudes
    off_magnitude: float = 1.0
    #: the ladder's L-BFGS step budget; the moment path reports it in run.log
    lbfgs_steps: int = 60
    #: "moment" only; "ladder" is not ported yet
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
        if self.diag_magnitudes is None:
            self.diag_magnitudes = np.ones(2)

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
        """The fit data on the device and the host copy of ``density.active``.
        The ladder's length bounds and constraint targets are not packed: the
        moment path reads neither."""
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
        return data, active

    # -- the main entry (reference Optimization::optimize, opt.cpp:1019) -----------
    def optimize(self, density: Density, extra: Density, surface_energies) -> OptResult:
        """Reoptimize on the device of ``density``."""
        self.device = density.points.device
        data, active = self._pack_data(density, extra, surface_energies)
        return self._optimize_impl(density, data, active)

    def _optimize_impl(self, density: Density, data, active) -> OptResult:
        if self.opt_mode != "moment":
            raise NotImplementedError(
                "Optimizer: only opt_mode='moment' is ported; the constrained ladder "
                "is ROADMAP Queue A item 11")
        return self._moment_impl(density, data, active)

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
                   tag="moment", mags=host[-3:-1], off_mag=float(host[-1]))
        return self._finish(res, active)

    def _finish(self, res, active) -> OptResult:
        self.diag_lengths = res["diag_lengths"]
        self.off_params = res["off_params"]
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
