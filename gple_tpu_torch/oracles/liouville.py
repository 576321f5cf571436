"""Exact grid-MQCLE solver: the second verification oracle.

Counterpart of :mod:`gple_tpu.oracles.liouville`: Trotter-split propagation
of the partial-Wigner-transformed density matrix rho(x, p) on a phase-space
grid,

    rho(t+dt) = e^{-iL_Q dt/2} e^{-iL_R dt/2} e^{-iL_P dt} e^{-iL_R dt/2}
                e^{-iL_Q dt/2} rho(t),

with the density matrix one ``(N, N, 2, 2)`` complex128 tensor on the
solver's device (the CUDA card unless ``device="cpu"``), ``torch.fft`` along
the same axes as the JAX code (cuFFT on the card), and the per-grid 2x2
transforms precomputed once with the closed-form eigensolver.

Differences of form from the JAX package, none of value:

* a basis change ``C^T rho C`` at every grid point (JAX's three-operand
  einsum) is one batched product of rho, read as ``(N, N, 4)``, with a
  precomputed ``(N, 4, 4)`` matrix ``kron(C^T, C^T)^T`` (:func:`_sandwich`):
  no transposed copies, and no einsum path search on every call;
* JAX's ``.at[:, :, 0, 1].multiply(ph)`` / ``.at[:, :, 1, 0].multiply(conj ph)``
  is one out-of-place product with an ``(N, 1, 2, 2)`` phase tensor whose
  diagonal is exactly 1;
* :func:`_hermitize` writes the diagonal's real part and one off-diagonal
  element and its conjugate instead of adding rho to its conjugate
  transpose;
* the phase tensors of the substeps are computed once per step length and
  kept (JAX rebuilt them inside its jitted step);
* the Trotter loop is a Python loop where JAX scanned a jitted step.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import numpy as np
import torch

from gple_tpu_torch.models import tully
from gple_tpu_torch.utils.constants import HBAR, PLANCK_H, power_of_two_cutoff


@dataclasses.dataclass(frozen=True)
class LiouvilleConfig:
    model: str = "DAC"
    mass: float = 2000.0
    x0: float = -10.0
    p0: float = 30.0
    sigma_p: float = 1.5
    xmin: float = -10.0
    xmax: float = 10.0
    dx_input: float = 0.2
    output_time: float = 10.0
    dt_input: float = 0.1

    @property
    def sigma_x(self) -> float:
        return HBAR / (2.0 * self.sigma_p)

    @property
    def dx(self) -> float:
        p0max = self.p0 + 3.0 * self.sigma_p
        return power_of_two_cutoff(min(self.dx_input, PLANCK_H / p0max / 2.0))

    @property
    def n_grids(self) -> int:
        return int((self.xmax - self.xmin) / self.dx) + 1

    @property
    def pmin(self) -> float:
        return self.p0 - math.pi * HBAR / self.dx / 2.0

    @property
    def pmax(self) -> float:
        return self.p0 + math.pi * HBAR / self.dx / 2.0

    @property
    def dp(self) -> float:
        return (self.pmax - self.pmin) / (self.n_grids - 1)

    @property
    def x_grid(self) -> np.ndarray:
        n = self.n_grids
        i = np.arange(n)
        return (self.xmin * (n - 1 - i) + self.xmax * i) / (n - 1)

    @property
    def p_grid(self) -> np.ndarray:
        n = self.n_grids
        i = np.arange(n)
        return (self.pmin * (n - 1 - i) + self.pmax * i) / (n - 1)

    @property
    def dt(self) -> float:
        return power_of_two_cutoff(
            min(self.dt_input, HBAR / 500.0 / (self.sigma_p * self.p0 / self.mass))
        )

    @property
    def total_time(self) -> float:
        return (self.xmax - self.xmin) / (self.p0 / self.mass) * 2.0

    @property
    def output_step(self) -> int:
        return max(1, int(self.output_time / self.dt))

    @property
    def total_step(self) -> int:
        return int(self.total_time / self.dt)


def _sandwich_matrix(c):
    """(N, 4, 4) complex128 ``M^T`` with ``M[(a,d),(b,c)] = C[b,a] C[c,d]`` for
    c (N,2,2) real: C^T rho C = (rho as (N, N, 4)) @ M^T at every grid point."""
    m = torch.einsum("xba,xcd->xadbc", c, c).reshape(c.shape[0], 4, 4)
    return m.transpose(-1, -2).to(torch.complex128).contiguous()


def _apply(mt, rho):
    """rho (N,N,2,2) through a per-grid-point (N, 4, 4) :func:`_sandwich_matrix`."""
    return torch.bmm(rho.reshape(rho.shape[0], rho.shape[1], 4), mt).reshape(rho.shape)


def _sandwich(c, rho):
    """C^T rho C per grid point: c (N,2,2) real, rho (N,N,2,2) complex."""
    return _apply(_sandwich_matrix(c), rho)


def _hermitize(rho):
    """0.5 (rho + rho^H) per grid point, element by element: the diagonal is
    its real part, the (1, 0) element the conjugate of the (0, 1) one (the
    same values, bit for bit, as the full formula, in fewer passes)."""
    out = torch.empty_like(rho)
    torch.diagonal(out, dim1=-2, dim2=-1).copy_(torch.diagonal(rho, dim1=-2, dim2=-1).real)
    off = 0.5 * (rho[..., 0, 1] + torch.conj(rho[..., 1, 0]))
    out[..., 0, 1] = off
    out[..., 1, 0] = torch.conj(off)
    return out


class LiouvilleSolver:
    def __init__(self, cfg: LiouvilleConfig, device="cuda"):
        self.cfg = cfg
        self.device = dev = torch.device(device)
        f64 = dict(dtype=torch.float64, device=dev)
        n = cfg.n_grids
        x = torch.tensor(cfg.x_grid, **f64)
        p = torch.tensor(cfg.p_grid, **f64)
        # transforms and basis quantities over the x grid
        self.c_adia = tully.adiabatic_transform(cfg.model, x)        # (N,2,2)
        self.e_adia = tully.adiabatic_potential(cfg.model, x)        # (N,2)
        f_dia = tully.diabatic_force(cfg.model, x)                   # (N,2,2)
        self.f_eig, self.c_force = tully.sym2x2_eigh(f_dia)          # (N,2), (N,2,2)
        # the four basis changes as (N, 4, 4) matrices (_sandwich_matrix)
        self._to_adia = _sandwich_matrix(self.c_adia)
        self._to_dia = _sandwich_matrix(self.c_adia.transpose(-1, -2))
        self._to_force = _sandwich_matrix(self.c_force)
        self._from_force = _sandwich_matrix(self.c_force.transpose(-1, -2))
        # FFT integer wavenumbers k in [0..N/2-1, -N/2..-1] (reference
        # general.cpp:339-346, where index k >= N/2 maps to k - N)
        self.k_wave = torch.tensor(np.fft.fftfreq(n) * n, **f64)
        self.x = x
        self.p = p
        self._phases = {}

    # -- initialization (general.cpp:68-106) -----------------------------------
    def initial_density(self):
        cfg = self.cfg
        gx = torch.exp(-(((self.x - cfg.x0) / cfg.sigma_x) ** 2) / 2.0)
        gp = torch.exp(-(((self.p - cfg.p0) / cfg.sigma_p) ** 2) / 2.0)
        rho00 = gx[:, None] * gp[None, :] / (2.0 * math.pi * cfg.sigma_x * cfg.sigma_p)
        rho00 = rho00 / (torch.sum(rho00) * cfg.dx * cfg.dp)
        rho = torch.zeros((cfg.n_grids, cfg.n_grids, 2, 2), dtype=torch.complex128,
                          device=self.device)
        rho[:, :, 0, 0] = rho00
        return rho

    # -- Trotter substeps -------------------------------------------------------
    def _phase(self, kind: str, t: float):
        """The phase tensor of one substep of length ``t``, computed once."""
        key = (kind, t)
        if key not in self._phases:
            cfg = self.cfg
            if kind == "quantum":
                de = self.e_adia[:, 1] - self.e_adia[:, 0]  # (N,)
                ph = torch.exp(1.0j * de * t / HBAR)        # phase of the (0,1) element
                one = torch.ones_like(ph)
                val = torch.stack([torch.stack([one, ph], -1),
                                   torch.stack([torch.conj(ph), one], -1)], -2)
                val = val[:, None]                          # (N, 1, 2, 2)
            elif kind == "position":
                length = cfg.xmax - cfg.xmin
                val = torch.exp(-1.0j * self.p[None, :] / cfg.mass * 2.0 * math.pi
                                * self.k_wave[:, None] / length * t)[:, :, None, None]
            else:
                length_p = cfg.pmax - cfg.pmin
                f_sum = self.f_eig[:, :, None] + self.f_eig[:, None, :]  # (N,2,2)
                val = torch.exp(-1.0j * f_sum[:, None, :, :] * math.pi
                                * self.k_wave[None, :, None, None] / length_p * t)
            self._phases[key] = val
        return self._phases[key]

    def quantum_liouville(self, rho_dia, t):
        """Diabatic-basis quantum Liouville via the adiabatic phase trick."""
        rho_adia = self.to_adiabatic(rho_dia) * self._phase("quantum", t)
        return self.to_diabatic(rho_adia)

    def classical_position(self, rho, t):
        """exp(-iL_R t): FFT over x, multiply exp(-p/m * 2 pi i k / L * t)."""
        rho_k = torch.fft.fft(rho, dim=0)
        rho = torch.fft.ifft(rho_k * self._phase("position", t), dim=0)
        return _hermitize(rho)

    def classical_momentum(self, rho, t):
        """exp(-iL_P t) in the force basis: FFT over p with eigen-force phases."""
        rho_f = _apply(self._to_force, rho)
        rho_k = torch.fft.fft(rho_f, dim=1)
        rho_f = torch.fft.ifft(rho_k * self._phase("momentum", t), dim=1)
        rho_f = _hermitize(rho_f)
        return _hermitize(_apply(self._from_force, rho_f))

    def trotter_step(self, rho_dia, dt):
        rho = self.quantum_liouville(rho_dia, dt / 2.0)
        rho = self.classical_position(rho, dt / 2.0)
        rho = self.classical_momentum(rho, dt)
        rho = self.classical_position(rho, dt / 2.0)
        rho = self.quantum_liouville(rho, dt / 2.0)
        return rho

    def _step(self, rho, n_steps: int):
        for _ in range(n_steps):
            rho = self.trotter_step(rho, self.cfg.dt)
        return rho

    # -- observables (adiabatic basis; general.cpp:108-164) ---------------------
    def to_adiabatic(self, rho_dia):
        # _sandwich(M, rho) = M^T rho M, so this is C^T rho_dia C
        return _apply(self._to_adia, rho_dia)

    def to_diabatic(self, rho_adia):
        # C rho_adia C^T
        return _apply(self._to_dia, rho_adia)

    def populations(self, rho_adia):
        cfg = self.cfg
        diag = torch.diagonal(rho_adia, dim1=-2, dim2=-1).real     # (N, N, 2)
        return torch.sum(diag, dim=(0, 1)) * cfg.dx * cfg.dp

    def averages(self, rho_adia):
        cfg = self.cfg
        ppl_grid = torch.diagonal(rho_adia, dim1=-2, dim2=-1).real  # (N,N,2)
        kin = (self.p ** 2 / (2.0 * cfg.mass))[None, :, None]
        pot = self.e_adia[:, None, :]
        e = torch.sum(ppl_grid * (pot + kin)) * cfg.dx * cfg.dp
        x = torch.sum(ppl_grid * self.x[:, None, None]) * cfg.dx * cfg.dp
        p = torch.sum(ppl_grid * self.p[None, :, None]) * cfg.dx * cfg.dp
        return e, x, p

    # -- main loop (main.cpp:192-314) -------------------------------------------
    def run(self, store_rho: bool = True, max_outputs: Optional[int] = None):
        cfg = self.cfg
        n_out = cfg.total_step // cfg.output_step + 1
        if max_outputs is not None:
            n_out = min(n_out, max_outputs)
        rho_adia = self.initial_density()
        rho_dia = self.to_diabatic(rho_adia)
        times, rhos, avgs, ppls = [], [], [], []
        last_x = None
        for i_out in range(n_out):
            t = i_out * cfg.output_step * cfg.dt
            rho_adia = self.to_adiabatic(rho_dia)
            e, x, p = self.averages(rho_adia)
            ppl = self.populations(rho_adia)
            times.append(t)
            if store_rho:
                rhos.append(rho_adia.cpu().numpy())
            host = torch.cat([torch.stack([e, x, p]), ppl]).cpu().numpy()
            avgs.append(tuple(float(v) for v in host[:3]))
            ppls.append(host[3:])
            x_f = avgs[-1][1]
            if x_f > 0.0 and (
                (last_x is not None and (x_f - last_x) * cfg.p0 < 0) or x_f > -cfg.x0
            ):
                break
            last_x = x_f
            rho_dia = self._step(rho_dia, cfg.output_step)
        return LiouvilleResult(
            cfg=cfg,
            times=np.asarray(times),
            rhos=np.asarray(rhos) if store_rho else None,
            averages=np.asarray(avgs),
            populations=np.asarray(ppls),
        )


@dataclasses.dataclass
class LiouvilleResult:
    cfg: LiouvilleConfig
    times: np.ndarray
    rhos: Optional[np.ndarray]      # (n_out, N, N, 2, 2) adiabatic
    averages: np.ndarray            # (n_out, 3)
    populations: np.ndarray         # (n_out, 2)

    def save_txt(self, outdir: str) -> None:
        """Emit x.txt p.txt t.txt phase.txt averages.txt (reference formats)."""
        os.makedirs(outdir, exist_ok=True)
        np.savetxt(os.path.join(outdir, "x.txt"), self.cfg.x_grid)
        np.savetxt(os.path.join(outdir, "p.txt"), self.cfg.p_grid)
        np.savetxt(os.path.join(outdir, "t.txt"), self.times)
        with open(os.path.join(outdir, "averages.txt"), "w") as f:
            for t, (e, x, p), ppl in zip(self.times, self.averages, self.populations):
                f.write(f"{t} {e} {x} {p} " + " ".join(str(v) for v in ppl) + "\n")
        if self.rhos is not None:
            with open(os.path.join(outdir, "phase.txt"), "w") as f:
                for frame in self.rhos:
                    vals = frame.transpose(2, 3, 0, 1).reshape(4, -1)
                    for row in vals:
                        f.write(
                            " ".join(f"{v.real:.18g} {v.imag:.18g}" for v in row) + "\n"
                        )
                    f.write("\n")
