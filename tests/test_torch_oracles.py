"""PyTorch port: the DVR oracle (``gple_tpu_torch.oracles.schrodinger``) on the CPU.

* The checks of ``tests/test_schrodinger.py`` on the port, with their
  tolerances (the grid Liouville oracle's are in ``test_torch_liouville.py``).
* Parity with ``gple_tpu.oracles.schrodinger`` on the same configurations:
  the operators (kinetic blocks of all three boundaries, H, the FD momentum,
  psi0, the adiabatic transform) 1e-12 relative to each one's largest entry;
  psi(t), populations, averages and the Wigner frames of a run 1e-10
  relative, on the spectral, Strang and RK4 paths; the Wigner transform of
  the same psi 1e-12 relative to the largest |entry|.
* ``save_txt`` of either oracle's result on the JAX package's arrays writes
  files byte-identical to the JAX package's.
"""

import filecmp
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gple_tpu.oracles import liouville as JL
from gple_tpu.oracles import schrodinger as JS
from gple_tpu_torch import convert
from gple_tpu_torch.oracles.liouville import LiouvilleResult
from gple_tpu_torch.oracles.schrodinger import (
    DVRConfig,
    DVRResult,
    DVRSolver,
    adiabatic_to_diabatic_matrix,
    fd_derivative_matrix,
    hamiltonian,
    initial_wavefunction,
    kinetic_matrix,
    wigner_transform,
)
from gple_tpu_torch.utils.constants import HBAR
from test_torch_kernels import _warm_torch_exp, one_torch_thread  # noqa: F401 (fixtures)


CPU = "cpu"
TOL_STATE = 1e-10
TOL_WIGNER = 1e-12

SMALL = dict(model="SAC", mass=2000.0, x0=-3.0, p0=25.0, sigma_p=1.0, xmin=-5.0, xmax=5.0,
             dx_input=1.0, output_time=20.0, dt_input=0.5)
#: tests/test_schrodinger.py:85's absorbing configuration
ABSORBING = dict(SMALL, boundary="absorbing", x0=-2.0, xmin=-3.0, xmax=3.0,
                 output_time=40.0)
#: the parity runs' grid: SMALL on x in [-3, 3] (n = 193)
PARITY = dict(SMALL, x0=-2.0, xmin=-3.0, xmax=3.0)


def small_cfg(**kw):
    return DVRConfig(**{**SMALL, "boundary": "reflective", **kw})


def _rel(ours, theirs):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    return float(np.abs(ours - theirs).max() / np.abs(theirs).max())


# -- tests/test_schrodinger.py on the port ------------------------------------------------

def test_kinetic_matrix_second_derivative():
    """T psi ~ -hbar^2/(2m) psi'' for a smooth function away from edges."""
    n, dx, mass = 256, 0.05, 2000.0
    x = (np.arange(n) - n / 2) * dx
    t = kinetic_matrix(n, dx, mass, "reflective", CPU)
    assert t.dtype == torch.float64
    psi = np.exp(-(x**2) / 2.0)
    exact = -HBAR**2 / (2 * mass) * (x**2 - 1.0) * psi
    approx = (t @ torch.from_numpy(psi)).numpy()
    inner = slice(n // 4, 3 * n // 4)
    np.testing.assert_allclose(approx[inner], exact[inner], atol=1e-10)


def test_hamiltonian_hermitian_without_abc():
    h = hamiltonian(small_cfg(), device=CPU).numpy()
    assert h.dtype == np.complex128
    np.testing.assert_allclose(h, h.conj().T, atol=1e-12)


def test_initial_wavefunction_normalized_and_centered():
    cfg = small_cfg()
    psi = initial_wavefunction(cfg, CPU).numpy()
    n = cfg.n_grids
    assert np.sum(np.abs(psi) ** 2) * cfg.dx == pytest.approx(1.0, rel=1e-12)
    mean_x = np.sum(cfg.x_grid * np.abs(psi[:n]) ** 2) * cfg.dx
    assert mean_x == pytest.approx(cfg.x0, abs=1e-3)
    assert np.all(psi[n:] == 0)


def test_norm_and_energy_conservation_spectral():
    cfg = small_cfg()
    res = DVRSolver(cfg, CPU).run(store_wigner=False, max_outputs=4)
    np.testing.assert_allclose(res.populations.sum(axis=1), 1.0, atol=1e-8)
    np.testing.assert_allclose(res.averages[:, 0], res.averages[0, 0], rtol=1e-8)
    dt_out = res.times[1] - res.times[0]
    vel = (res.averages[1, 1] - res.averages[0, 1]) / dt_out
    assert vel == pytest.approx(cfg.p0 / cfg.mass, rel=0.05)


def test_absorbing_strang_damps_norm():
    solver = DVRSolver(DVRConfig(**ABSORBING), CPU)
    h = solver.h.numpy()
    assert np.abs(h - h.conj().T).max() > 0       # -iA on the diagonal
    res = solver.run(store_wigner=False, max_outputs=8)
    total = res.populations.sum(axis=1)
    assert np.all(total <= 1.0 + 1e-6)
    assert total[-1] < total[0] + 1e-6


def test_wigner_transform_marginals():
    """Integrating W_ii over p recovers |psi_i(x)|^2; over x and p, population."""
    cfg = small_cfg()
    psi = initial_wavefunction(cfg, CPU)
    w = wigner_transform(psi, cfg.x_grid, cfg.p_grid, cfg.dx, cfg.boundary).numpy()
    n = cfg.n_grids
    dp = cfg.p_grid[1] - cfg.p_grid[0]
    marg_x = w[0, 0].real.sum(axis=1) * dp
    dens = np.abs(psi[:n].numpy()) ** 2
    np.testing.assert_allclose(marg_x, dens, atol=2e-4 * dens.max())
    assert w[0, 0].real.sum() * cfg.dx * dp == pytest.approx(1.0, abs=2e-3)
    assert abs(w[1, 1].real.sum() * cfg.dx * dp) < 1e-12
    np.testing.assert_allclose(w[0, 1], np.conj(w[1, 0]), atol=1e-12)
    mean_p = (w[0, 0].real.sum(axis=0) * cfg.p_grid).sum() / w[0, 0].real.sum()
    assert mean_p == pytest.approx(cfg.p0, rel=1e-3)


def test_fd_derivative_antisymmetric():
    d = fd_derivative_matrix(64, 0.1, CPU).numpy()
    np.testing.assert_allclose(d, -d.T, atol=1e-14)


def test_sac_scattering_populations_sensible():
    res = DVRSolver(small_cfg(p0=20.0, x0=-4.0), CPU).run(store_wigner=False)
    assert res.populations.shape[1] == 2
    np.testing.assert_allclose(res.populations.sum(axis=1), 1.0, atol=1e-6)
    assert res.populations[-1, 1] > 0.01


def test_save_txt(tmp_path):
    cfg = small_cfg()
    DVRSolver(cfg, CPU).run(store_wigner=True, max_outputs=2).save_txt(str(tmp_path))
    assert np.loadtxt(tmp_path / "x.txt").shape[0] == cfg.n_grids
    assert np.loadtxt(tmp_path / "averages.txt").shape[1] == 6  # t, E, x, p, ppl0, ppl1


# -- parity with gple_tpu.oracles ---------------------------------------------------------

@pytest.mark.parametrize("boundary", ["reflective", "periodic", "absorbing"])
def test_operators_match_jax(boundary):
    kw = ABSORBING if boundary == "absorbing" else dict(PARITY, boundary=boundary)
    tcfg = DVRConfig(**kw)
    jcfg = JS.DVRConfig(**kw)
    assert convert.to_torch(jcfg, CPU) == tcfg
    n = tcfg.n_grids
    pairs = [
        (kinetic_matrix(n, tcfg.dx, tcfg.mass, boundary, CPU),
         JS.kinetic_matrix(n, jcfg.dx, jcfg.mass, boundary)),
        (hamiltonian(tcfg, device=CPU), JS.hamiltonian(jcfg)),
        (hamiltonian(tcfg, include_absorbing=False, device=CPU),
         JS.hamiltonian(jcfg, include_absorbing=False)),
        (fd_derivative_matrix(n, tcfg.dx, CPU), JS.fd_derivative_matrix(n, jcfg.dx)),
        (initial_wavefunction(tcfg, CPU), JS.initial_wavefunction(jcfg)),
        (adiabatic_to_diabatic_matrix(tcfg, CPU), JS.adiabatic_to_diabatic_matrix(jcfg)),
    ]
    for ours, theirs in pairs:
        assert ours.shape == theirs.shape
        assert _rel(ours.numpy(), theirs) <= 1e-12


@pytest.mark.parametrize("boundary", ["reflective", "periodic", "absorbing"])
def test_dvr_run_matches_jax(boundary):
    """Spectral (reflective, periodic) and Strang (absorbing) runs with
    Wigner frames: psi(t), populations, averages and every frame (which
    inherit psi's rounding); then each frame's transform of the JAX
    package's own psi."""
    kw = ABSORBING if boundary == "absorbing" else dict(PARITY, boundary=boundary)
    cfg = DVRConfig(**kw)
    ours = DVRSolver(cfg, CPU).run(store_wigner=True, max_outputs=3)
    theirs = JS.DVRSolver(JS.DVRConfig(**kw)).run(store_wigner=True, max_outputs=3)
    np.testing.assert_array_equal(ours.times, theirs.times)
    for a, b in ((ours.psis, theirs.psis), (ours.populations, theirs.populations),
                 (ours.averages, theirs.averages), (ours.wigners, theirs.wigners)):
        assert _rel(a, b) <= TOL_STATE
    for psi, frame in zip(theirs.psis, theirs.wigners):
        w = wigner_transform(torch.from_numpy(psi), cfg.x_grid, cfg.p_grid, cfg.dx,
                             cfg.boundary)
        assert _rel(w.numpy(), frame) <= TOL_WIGNER


def test_rk4_matches_jax():
    ours = DVRSolver(DVRConfig(**ABSORBING), CPU)
    theirs = JS.DVRSolver(JS.DVRConfig(**ABSORBING))
    psi = ours._rk4_steps(ours.psi0_dia, 6).numpy()
    assert _rel(psi, theirs._rk4_block(theirs.psi0_dia, 6)) <= TOL_STATE


def test_save_txt_byte_identical_to_jax(tmp_path):
    """Both result classes write the JAX package's files byte for byte."""
    jcfg = JS.DVRConfig(**dict(PARITY, boundary="reflective"))
    jres = JS.DVRSolver(jcfg).run(store_wigner=True, max_outputs=1)
    jres.save_txt(str(tmp_path / "jax_se"))
    DVRResult(cfg=convert.to_torch(jcfg, CPU), times=jres.times, psis=jres.psis,
              wigners=jres.wigners, averages=jres.averages,
              populations=jres.populations).save_txt(str(tmp_path / "port_se"))
    lcfg = JL.LiouvilleConfig(**dict(PARITY, output_time=1.0))
    lres = JL.LiouvilleSolver(lcfg).run(store_rho=True, max_outputs=2)
    lres.save_txt(str(tmp_path / "jax_le"))
    LiouvilleResult(cfg=convert.to_torch(lcfg, CPU), times=lres.times, rhos=lres.rhos,
                    averages=lres.averages,
                    populations=lres.populations).save_txt(str(tmp_path / "port_le"))
    for kind, names in (("se", ["averages.txt", "p.txt", "phase.txt", "psi.txt", "t.txt",
                                "x.txt"]),
                        ("le", ["averages.txt", "p.txt", "phase.txt", "t.txt", "x.txt"])):
        match, mismatch, errors = filecmp.cmpfiles(tmp_path / f"jax_{kind}",
                                                   tmp_path / f"port_{kind}", names,
                                                   shallow=False)
        assert match == names and not mismatch and not errors


def test_wigner_transform_on_jax_psi():
    """The transform alone, on the JAX package's psi: 1e-12 of the largest entry."""
    cfg = JS.DVRConfig(**dict(PARITY, boundary="periodic"))
    rng = np.random.default_rng(5)
    psi = rng.normal(size=2 * cfg.n_grids) + 1j * rng.normal(size=2 * cfg.n_grids)
    theirs = JS.wigner_transform(jnp.asarray(psi), cfg.x_grid, cfg.p_grid, cfg.dx, "periodic")
    ours = wigner_transform(torch.from_numpy(psi), cfg.x_grid, cfg.p_grid, cfg.dx, "periodic")
    assert _rel(ours.numpy(), theirs) <= TOL_WIGNER
    assert math.isclose(float(np.abs(theirs).max()), float(ours.abs().max()), rel_tol=1e-12)
