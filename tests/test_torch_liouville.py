"""PyTorch port: the grid-MQCLE oracle (``gple_tpu_torch.oracles.liouville``) on the CPU.

* The checks of ``tests/test_liouville.py`` on the port, with their
  tolerances, the cross-oracle check against the port's DVR included.
* Parity with ``gple_tpu.oracles.liouville``: rho after the Trotter test's
  10 steps, and the stored rho, populations and averages of a 2-output run,
  1e-9 relative to the largest |entry|; the element-wise ``_hermitize``
  equals the JAX package's formula bit for bit.

The Trotter step is ~25 small tensor ops: one intra-op thread per process
(the suite runs one worker per core).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gple_tpu.oracles import liouville as JL
from gple_tpu_torch import convert
from gple_tpu_torch.oracles import DVRConfig, DVRSolver, LiouvilleConfig, LiouvilleSolver
from gple_tpu_torch.oracles.liouville import _hermitize
from test_torch_kernels import _warm_torch_exp, one_torch_thread  # noqa: F401 (fixtures)
from test_torch_oracles import CPU, SMALL, _rel

TOL_RHO = 1e-9


def small_le_cfg(**kw):
    return LiouvilleConfig(**{**SMALL, **kw})


# -- tests/test_liouville.py on the port --------------------------------------------------

def test_initial_density_normalized():
    s = LiouvilleSolver(small_le_cfg(), CPU)
    rho = s.initial_density().numpy()
    cfg = s.cfg
    assert rho[:, :, 0, 0].real.sum() * cfg.dx * cfg.dp == pytest.approx(1.0, rel=1e-12)
    assert np.all(rho[:, :, 1, 1] == 0)
    np.testing.assert_allclose(s.populations(s.initial_density()).numpy(), [1.0, 0.0],
                               atol=1e-12)


def test_basis_transform_roundtrip():
    s = LiouvilleSolver(small_le_cfg(), CPU)
    rho = s.initial_density()
    np.testing.assert_allclose(s.to_adiabatic(s.to_diabatic(rho)).numpy(), rho.numpy(),
                               atol=1e-12)


def test_trotter_conserves_norm_and_hermiticity():
    s = LiouvilleSolver(small_le_cfg(), CPU)
    rho = s._step(s.to_diabatic(s.initial_density()), 10).numpy()
    np.testing.assert_allclose(rho, np.conj(np.swapaxes(rho, -1, -2)), atol=1e-12)
    total = (rho[:, :, 0, 0].real.sum() + rho[:, :, 1, 1].real.sum()) * s.cfg.dx * s.cfg.dp
    assert total == pytest.approx(1.0, abs=1e-8)


def test_wavepacket_moves_classically():
    s = LiouvilleSolver(small_le_cfg(), CPU)
    res = s.run(store_rho=False, max_outputs=3)
    dt_out = res.times[1] - res.times[0]
    vel = (res.averages[1, 1] - res.averages[0, 1]) / dt_out
    assert vel == pytest.approx(s.cfg.p0 / s.cfg.mass, rel=0.05)
    np.testing.assert_allclose(res.averages[:, 0], res.averages[0, 0], rtol=1e-3)
    np.testing.assert_allclose(res.populations.sum(axis=1), 1.0, atol=1e-6)


def test_liouville_vs_schrodinger_populations():
    """The two oracles' populations agree to a few percent over a short window."""
    common = dict(model="SAC", mass=2000.0, x0=-3.0, p0=25.0, sigma_p=1.0, xmin=-5.0,
                  xmax=5.0, output_time=100.0, dx_input=1.0, dt_input=0.5)
    se = DVRSolver(DVRConfig(boundary="reflective", **common), CPU).run(
        store_wigner=False, max_outputs=3)
    le = LiouvilleSolver(LiouvilleConfig(**common), CPU).run(store_rho=False, max_outputs=3)
    n = min(len(se.times), len(le.times))
    np.testing.assert_allclose(se.times[:n], le.times[:n])
    np.testing.assert_allclose(se.populations[:n], le.populations[:n], atol=0.05)


# -- parity with gple_tpu.oracles.liouville ------------------------------------------------

def test_liouville_matches_jax():
    """rho after the Trotter test's 10 steps, then a stored run of 2 outputs
    (16 steps apart)."""
    theirs = JL.LiouvilleSolver(JL.LiouvilleConfig(**SMALL))
    ours = LiouvilleSolver(convert.to_torch(theirs.cfg, CPU), CPU)
    rho = ours._step(ours.to_diabatic(ours.initial_density()), 10).numpy()
    assert _rel(rho, theirs._step(theirs.to_diabatic(theirs.initial_density()), 10)) <= TOL_RHO
    short = dict(SMALL, output_time=2.0)
    a = LiouvilleSolver(LiouvilleConfig(**short), CPU).run(store_rho=True, max_outputs=2)
    b = JL.LiouvilleSolver(JL.LiouvilleConfig(**short)).run(store_rho=True, max_outputs=2)
    np.testing.assert_array_equal(a.times, b.times)
    for x, y in ((a.rhos, b.rhos), (a.populations, b.populations), (a.averages, b.averages)):
        assert _rel(x, y) <= TOL_RHO


def test_hermitize_matches_jax_formula():
    rng = np.random.default_rng(8)
    rho = rng.normal(size=(7, 5, 2, 2)) + 1j * rng.normal(size=(7, 5, 2, 2))
    ours = _hermitize(torch.from_numpy(rho)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(JL._hermitize(jnp.asarray(rho))))
    np.testing.assert_array_equal(ours, 0.5 * (rho + np.conj(np.swapaxes(rho, -1, -2))))
