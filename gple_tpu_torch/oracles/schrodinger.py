"""Exact DVR Schroedinger solver: the primary verification oracle.

Counterpart of :mod:`gple_tpu.oracles.schrodinger`, function for function:
the Colbert-Miller discrete variable representation with reflective,
periodic or Manolopoulos-absorbing boundaries, spectral, Strang or RK4
propagation, the matmul form of the Wigner transform, and the reference's
output files.

Every operator is built once, explicitly in float64 / complex128, on the
solver's device (the CUDA card unless ``device="cpu"``).  The large products
are library calls, as XLA's were in the JAX package: the Hamiltonian's
``torch.linalg.eigh`` (cuSOLVER on the card), the Strang step's two
matrix-vector products and the Wigner transform's complex matrix product
(cuBLAS, FP64 tensor cores).  No Pallas kernel computed any of them.

Differences of form from the JAX package, none of value:

* ``(-1.0) ** d`` on an integer tensor gives torch's default dtype (float32);
  the signs are built as a float64 ``where`` instead;
* the Strang and RK4 loops are Python loops over precomputed operators
  (``V^H`` is one contiguous tensor) where JAX scanned a jitted step;
* the Wigner transform's four element pairs are one ``(4N, 2N-1) @ (2N-1, N)``
  product instead of four.
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

BOUNDARIES = ("reflective", "periodic", "absorbing")

#: stop-condition constants (reference ``schrodinger_equation/general.h:45-46``)
PPL_LIM = 1e-4
CHANGE_LIM = 1e-5

_C128 = torch.complex128


@dataclasses.dataclass(frozen=True)
class DVRConfig:
    model: str = "DAC"
    boundary: str = "absorbing"
    mass: float = 2000.0
    x0: float = -10.0
    p0: float = 30.0
    sigma_p: float = 1.5
    xmin: float = -10.0
    xmax: float = 10.0
    dx_input: float = 0.1
    output_time: float = 10.0
    dt_input: float = 0.01

    def __post_init__(self):
        if self.boundary not in BOUNDARIES:
            raise ValueError(f"boundary must be one of {BOUNDARIES}")

    # -- derived grid quantities (reference main.cpp:63-146) ------------------
    @property
    def sigma_x(self) -> float:
        return HBAR / (2.0 * self.sigma_p)

    @property
    def dx(self) -> float:
        p0max = self.p0 + 3.0 * self.sigma_p
        return power_of_two_cutoff(min(self.dx_input, PLANCK_H / p0max / 5.0))

    @property
    def absorbing_length(self) -> float:
        if self.boundary != "absorbing":
            return 0.0
        p0min = self.p0 - 3.0 * self.sigma_p
        return PLANCK_H / p0min

    @property
    def n_interacting(self) -> int:
        return int((self.xmax - self.xmin) / self.dx) + 1

    @property
    def n_absorbing(self) -> int:
        return int(self.absorbing_length / self.dx)

    @property
    def n_grids(self) -> int:
        return self.n_interacting + 2 * self.n_absorbing

    @property
    def x_grid(self) -> np.ndarray:
        i = np.arange(self.n_grids)
        return self.xmin + self.dx * (i - self.n_absorbing)

    @property
    def p_grid(self) -> np.ndarray:
        n = self.n_grids
        pmin = self.p0 - math.pi * HBAR / self.dx / 2.0
        pmax = self.p0 + math.pi * HBAR / self.dx / 2.0
        i = np.arange(n)
        return ((n - 1 - i) * pmin + i * pmax) / (n - 1)

    @property
    def dt(self) -> float:
        if self.boundary == "absorbing":
            return power_of_two_cutoff(
                min(self.dt_input, HBAR / 500.0 / (self.sigma_p * self.p0 / self.mass))
            )
        return self.output_time

    @property
    def total_time(self) -> float:
        return (self.xmax - self.xmin) / (self.p0 / self.mass) * 2.0

    @property
    def output_step(self) -> int:
        return max(1, int(self.output_time / self.dt))

    @property
    def total_step(self) -> int:
        return int(self.total_time / self.dt)


def _offsets(n: int, device):
    """d = i - j over an (n, n) grid, and its parity sign (-1)^d in float64."""
    i = torch.arange(n, device=device)
    d = i[:, None] - i[None, :]
    sign = torch.where(d % 2 == 0, 1.0, -1.0).to(torch.float64)
    return d, sign


def kinetic_matrix(n: int, dx: float, mass: float, boundary: str, device="cuda"):
    """Colbert-Miller kinetic-energy DVR block T (n, n), real symmetric, float64."""
    d, sign = _offsets(n, device)
    if boundary in ("reflective", "absorbing"):
        off = torch.where(d == 0, 1, d).to(torch.float64)
        t_off = sign * (HBAR / dx) ** 2 / (off * off) / mass
        t_diag = (math.pi * HBAR / dx) ** 2 / 6.0 / mass
        return torch.where(d == 0, t_diag, t_off)
    # periodic
    length = (n - 1) * dx
    ang = d.to(torch.float64) * math.pi / n
    sin2 = torch.where(d == 0, 1.0, torch.sin(ang) ** 2)
    t_off = sign * torch.cos(ang) * (math.pi * HBAR / length) ** 2 / sin2 / mass
    t_diag = (math.pi * HBAR / length) ** 2 / 6.0 / mass * (n * n - 1)
    return torch.where(d == 0, t_diag, t_off)


def _grid(cfg: DVRConfig, device):
    return torch.tensor(cfg.x_grid, dtype=torch.float64, device=device)


def _blocks(per_point, n: int):
    """``(2n, 2n)`` complex matrix, surface-major, with ``per_point (n, 2, 2)``
    on the grid diagonal of each (surface, surface) block:
    ``M[(m, i), (k, i)] = per_point[i, m, k]``."""
    out = torch.zeros((2, n, 2, n), dtype=_C128, device=per_point.device)
    idx = torch.arange(n, device=per_point.device)
    out[:, idx, :, idx] = per_point.to(_C128)
    return out


def hamiltonian(cfg: DVRConfig, include_absorbing: bool = True, device="cuda"):
    """Dense diabatic Hamiltonian, shape ``(2N, 2N)`` complex128, surface-major."""
    n = cfg.n_grids
    x = _grid(cfg, device)
    # potential couples surfaces at the same grid point: V_{m,k}(x_i) delta_ij
    h = _blocks(tully.diabatic_potential(cfg.model, x), n)
    # kinetic couples grids on the same surface: T_ij delta_{m,k}
    t_block = kinetic_matrix(n, cfg.dx, cfg.mass, cfg.boundary, device).to(_C128)
    h[0, :, 0, :] += t_block
    h[1, :, 1, :] += t_block
    if cfg.boundary == "absorbing" and include_absorbing:
        a = tully.absorbing_potential(cfg.mass, cfg.xmin, cfg.xmax, cfg.absorbing_length, x)
        h = h - 1.0j * _blocks(torch.diag_embed(torch.stack([a, a], dim=-1)), n)
    return h.reshape(2 * n, 2 * n)


def initial_wavefunction(cfg: DVRConfig, device="cuda"):
    """Gaussian wavepacket on the ground adiabatic surface, grid-normalized, (2N,)."""
    x = _grid(cfg, device)
    psi0 = torch.exp(
        -(((x - cfg.x0) / (2.0 * cfg.sigma_x)) ** 2) + 1.0j * cfg.p0 * x / HBAR
    ) / math.sqrt(math.sqrt(2.0 * math.pi) * cfg.sigma_x)
    psi = torch.cat([psi0, torch.zeros_like(psi0)])
    norm = torch.sqrt(torch.sum(torch.abs(psi) ** 2) * cfg.dx)
    return psi / norm


def adiabatic_to_diabatic_matrix(cfg: DVRConfig, device="cuda"):
    """Block-diagonal transform psi_dia = C psi_adia over the grid, (2N, 2N)."""
    c = tully.adiabatic_transform(cfg.model, _grid(cfg, device))  # (n, 2, 2)
    n = cfg.n_grids
    return _blocks(c, n).reshape(2 * n, 2 * n)


def wigner_transform(psi, x_grid, p_grid, dx: float, boundary: str):
    """Wigner transform of all 4 density-matrix elements, shape ``(2, 2, N, N)``:

    W_ij(x, p) = sum_y exp(2 i p y / hbar) psi_i(x - y) conj(psi_j(x + y))
                 * dx / (pi hbar),

    one complex product ``F (4N, 2N-1) @ E (2N-1, N)`` with ``F`` the gathered
    pair products of the four element pairs and ``E[k, p] = exp(2 i p k dx)``.
    ``psi`` is the (2N,) wavefunction on the device that the transform runs on.
    """
    dev = psi.device
    n = len(x_grid)
    psi2 = psi.reshape(2, n)
    k = torch.arange(-(n - 1), n, device=dev)  # (2n-1,) offsets
    xi = torch.arange(n, device=dev)
    im = xi[:, None] - k[None, :]  # x - y index
    ip = xi[:, None] + k[None, :]  # x + y index
    if boundary == "periodic":
        mask = (torch.abs(k) <= n // 3)[None, :]
        im_w, ip_w = torch.remainder(im, n), torch.remainder(ip, n)
    else:
        mask = (im >= 0) & (im < n) & (ip >= 0) & (ip < n)
        im_w, ip_w = torch.clamp(im, 0, n - 1), torch.clamp(ip, 0, n - 1)
    p = torch.as_tensor(np.asarray(p_grid), dtype=torch.float64, device=dev)
    phases = torch.exp(2.0j * p[None, :] * (k.to(torch.float64) * dx)[:, None] / HBAR)
    lo = psi2[:, im_w] * mask                       # (2, n, 2n-1): psi_i(x - y)
    hi = torch.conj(psi2[:, ip_w])                  # (2, n, 2n-1): conj psi_j(x + y)
    f = (lo[:, None] * hi[None, :]).reshape(4 * n, 2 * n - 1)
    return (f @ phases).reshape(2, 2, n, n) * (dx / (math.pi * HBAR))


def fd_derivative_matrix(n: int, dx: float, device="cuda"):
    """Infinite-order finite-difference first-derivative matrix (n, n), float64."""
    d, sign = _offsets(n, device)
    off = torch.where(d == 0, 1, d).to(torch.float64)
    return torch.where(d == 0, 0.0, sign / (dx * off))


class DVRSolver:
    """Builds the operators once on ``device``, then propagates and observes.

    Usage::

        solver = DVRSolver(DVRConfig(model="SAC", p0=20.0))          # the card
        result = solver.run()
    """

    def __init__(self, cfg: DVRConfig, device="cuda"):
        self.cfg = cfg
        self.device = dev = torch.device(device)
        n = cfg.n_grids
        self.h = hamiltonian(cfg, device=dev)
        self.h_hermitian = (hamiltonian(cfg, include_absorbing=False, device=dev)
                            if cfg.boundary == "absorbing" else self.h)
        self.transform = adiabatic_to_diabatic_matrix(cfg, dev)
        self.transform_h = self.transform.conj().T.contiguous()
        self.psi0_adia = initial_wavefunction(cfg, dev)
        self.psi0_dia = self.transform @ self.psi0_adia
        deriv = fd_derivative_matrix(n, cfg.dx, dev)
        zero = torch.zeros_like(deriv)
        self.p_op = -1.0j * HBAR * torch.cat(
            [torch.cat([deriv, zero], 1), torch.cat([zero, deriv], 1)], 0).to(_C128)
        if cfg.boundary != "absorbing":
            # Hermitian: one-time spectral decomposition (general.cpp:204-227)
            self._eigval, self._eigvec = torch.linalg.eigh(self.h)
            self._coef0 = self._eigvec.conj().T @ self.psi0_dia
        else:
            # Strang splitting: exp(-iH dt) ~ D exp(-iH_herm dt) D with
            # D = exp(-A dt / 2), spectrally exact for the Hermitian part and
            # unconditionally stable (the reference's RK4 is kept for parity)
            self._eigval, self._eigvec = torch.linalg.eigh(self.h_hermitian)
            self._eigvec_h = self._eigvec.conj().T.contiguous()
            a = tully.absorbing_potential(cfg.mass, cfg.xmin, cfg.xmax, cfg.absorbing_length,
                                          _grid(cfg, dev))
            self._half_decay = torch.exp(-torch.cat([a, a]) * cfg.dt / (2.0 * HBAR))
            self._phase_dt = torch.exp(-1.0j * self._eigval * cfg.dt / HBAR)

    # -- propagation ----------------------------------------------------------
    def _spectral_evolve(self, t):
        phase = torch.exp(-1.0j * self._eigval * t / HBAR)
        return self._eigvec @ (phase * self._coef0)

    def _rk4_steps(self, psi, n_steps: int):
        dt, h = self.cfg.dt, self.h
        for _ in range(n_steps):
            k1 = h @ psi / (1.0j * HBAR)
            k2 = h @ (psi + dt / 2.0 * k1) / (1.0j * HBAR)
            k3 = h @ (psi + dt / 2.0 * k2) / (1.0j * HBAR)
            k4 = h @ (psi + dt * k3) / (1.0j * HBAR)
            psi = psi + dt / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        return psi

    def _strang_steps(self, psi, n_steps: int):
        v, vh = self._eigvec, self._eigvec_h
        d, ph = self._half_decay, self._phase_dt
        for _ in range(n_steps):
            psi = d * psi
            psi = v @ (ph * (vh @ psi))
            psi = d * psi
        return psi

    # -- observables ----------------------------------------------------------
    def averages(self, psi_dia):
        """<E>, <x>, <p> (0-d tensors) from the diabatic wavefunction
        (general.cpp:443-478)."""
        cfg = self.cfg
        n = cfg.n_grids
        e = torch.real(torch.vdot(psi_dia, self.h_hermitian @ psi_dia)) * cfg.dx
        dens = torch.abs(psi_dia.reshape(2, n)) ** 2
        x = torch.sum(dens * _grid(cfg, psi_dia.device)[None, :]) * cfg.dx
        p = torch.real(torch.vdot(psi_dia, self.p_op @ psi_dia)) * cfg.dx
        return e, x, p

    def populations(self, psi_adia):
        n = self.cfg.n_grids
        dens = torch.abs(psi_adia.reshape(2, n)) ** 2
        return torch.sum(dens, dim=1) * self.cfg.dx

    # -- main loop (reference main.cpp:211-298) --------------------------------
    def run(self, store_wigner: bool = True, max_outputs: Optional[int] = None):
        cfg = self.cfg
        n_out = cfg.total_step // cfg.output_step + 1
        if max_outputs is not None:
            n_out = min(n_out, max_outputs)
        times, psis, wigners, avgs, ppls = [], [], [], [], []
        psi_dia = self.psi0_dia
        last_x, last_ppl = None, None
        for i_out in range(n_out):
            t = i_out * cfg.output_step * cfg.dt
            psi_adia = self.transform_h @ psi_dia
            e, x, p = self.averages(psi_dia)
            ppl = self.populations(psi_adia)
            times.append(t)
            if store_wigner:
                wigners.append(wigner_transform(psi_adia, cfg.x_grid, cfg.p_grid, cfg.dx,
                                                cfg.boundary).cpu().numpy())
            # one device-to-host copy for this output's scalars and psi
            host = torch.cat([torch.stack([e, x, p]).to(_C128), ppl.to(_C128),
                              psi_adia]).cpu().numpy()
            psis.append(host[5:])
            avgs.append(tuple(float(v) for v in host[:3].real))
            ppl_h = host[3:5].real.copy()
            ppls.append(ppl_h)
            # stop conditions (main.cpp:255-287)
            x_f = avgs[-1][1]
            if x_f > 0.0:
                if x_f > -cfg.x0:
                    break
                if last_x is not None and (x_f - last_x) * cfg.p0 < 0:
                    break
                if cfg.boundary == "absorbing" and float(np.sum(ppl_h)) < PPL_LIM:
                    break
                if last_ppl is not None and np.all(np.abs(ppl_h - last_ppl) < CHANGE_LIM):
                    break
            last_x, last_ppl = x_f, ppl_h
            # propagate to the next output time
            if cfg.boundary == "absorbing":
                psi_dia = self._strang_steps(psi_dia, cfg.output_step)
            else:
                psi_dia = self._spectral_evolve((i_out + 1) * cfg.output_step * cfg.dt)
        return DVRResult(
            cfg=cfg,
            times=np.asarray(times),
            psis=np.asarray(psis),
            wigners=np.asarray(wigners) if store_wigner else None,
            averages=np.asarray(avgs),
            populations=np.asarray(ppls),
        )


@dataclasses.dataclass
class DVRResult:
    cfg: DVRConfig
    times: np.ndarray
    psis: np.ndarray
    wigners: Optional[np.ndarray]
    averages: np.ndarray      # (n_out, 3): <E>, <x>, <p>
    populations: np.ndarray   # (n_out, 2)

    def save_txt(self, outdir: str) -> None:
        """Emit the reference's output files (x.txt p.txt t.txt psi.txt
        phase.txt averages.txt) so its plot scripts work unchanged."""
        os.makedirs(outdir, exist_ok=True)
        np.savetxt(os.path.join(outdir, "x.txt"), self.cfg.x_grid)
        np.savetxt(os.path.join(outdir, "p.txt"), self.cfg.p_grid)
        np.savetxt(os.path.join(outdir, "t.txt"), self.times)
        with open(os.path.join(outdir, "psi.txt"), "w") as f:
            for psi in self.psis:
                f.write(" ".join(f"{abs(v) ** 2:.18g}" for v in psi) + "\n")
        with open(os.path.join(outdir, "averages.txt"), "w") as f:
            for t, (e, x, p), ppl in zip(self.times, self.averages, self.populations):
                f.write(f"{t} {e} {x} {p} " + " ".join(str(v) for v in ppl) + "\n")
        if self.wigners is not None:
            with open(os.path.join(outdir, "phase.txt"), "w") as f:
                for frame in self.wigners:
                    for i in range(2):
                        for j in range(2):
                            vals = frame[i, j].ravel()
                            f.write(
                                " "
                                + " ".join(f"{v.real:.18g} {v.imag:.18g}" for v in vals)
                                + "\n"
                            )
                    f.write("\n")
