"""PyTorch port: the Monte-Carlo observables against ``gple_tpu.observables``.

The same clouds, labels and GP states go through both packages (random
clouds from a numpy seed, every element with its own cloud, a complex
coherence; the JAX package's fit carried into the port, so the comparison
holds the observables and not the fit), with all three elements active and
with one inactive.  Limits: every point-sum observable 1e-12 relative; the
analytic GP integrals that ``observe_all`` also returns 1e-10 relative, the
limit ``tests/test_torch_gp.py`` holds them to (the purity is a quadratic
form in alpha, whose rounding differs between the packages' matmuls).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gple_tpu import observables as JOBS
from gple_tpu.ops import complex_kernels as JCK
from gple_tpu.ops import kernels as JRK
from gple_tpu.storage import Density as JDensity
from gple_tpu.storage import fit_gp_states as jax_fit
from gple_tpu_torch import convert
from gple_tpu_torch import observables as OBS
from test_torch_kernels import _warm_torch_exp  # noqa: F401 (fixture)

TOL = 1e-12
TOL_GP_INTEGRALS = 1e-10
GP_INTEGRALS = ("ppl_prm_each", "pop_prm", "energy_prm", "purity_prm")
MODEL, MASS = "SAC", 2000.0
R0, SIGMA = np.array([-10.0, 30.0]), np.array([1.0 / 3.0, 1.5])


def random_clouds(seed: int, n: int, active):
    """(points (3, n, 2), rho (3, n, 2), active (3,)) as numpy: a Gaussian
    cloud per element, Gaussian diagonal labels, a complex coherence."""
    rng = np.random.default_rng(seed)
    pts = R0 + rng.normal(size=(3, n, 2)) * SIGMA * rng.uniform(0.8, 1.2, size=(3, 1, 2))
    g = np.exp(-0.5 * np.sum(((pts - R0) / SIGMA) ** 2, axis=-1)) / (2 * np.pi * np.prod(SIGMA))
    phase = 1.0 * (pts[1, :, 1] - R0[1])
    rho = np.zeros((3, n, 2))
    rho[0, :, 0] = g[0]
    rho[2, :, 0] = 0.3 * g[2]
    rho[1, :, 0] = 0.2 * g[1] * np.cos(phase)
    rho[1, :, 1] = 0.2 * g[1] * np.sin(phase)
    active = np.asarray(active, dtype=bool)
    rho = np.where(active[:, None, None], rho, 0.0)
    return pts, rho, active


def jax_params(lengths=SIGMA):
    lengths = jnp.asarray(lengths)
    diag = JRK.KernelParams(magnitude=jnp.ones(2),
                            lengths=jnp.stack([lengths, lengths]),
                            noise=jnp.full(2, 1e-2))
    off = JCK.ComplexKernelParams(
        magnitude=jnp.asarray(1.0), real_magnitude=jnp.asarray(1.0),
        real_lengths=lengths, imag_magnitude=jnp.asarray(1.0),
        imag_lengths=lengths, noise=jnp.asarray(1e-2), corr=jnp.asarray(0.0))
    return diag, off


def both_states(seed, n, active):
    """The same (Density, GPStates) in both packages."""
    pts, rho, act = random_clouds(seed, n, active)
    jd = JDensity(points=jnp.asarray(pts), rho=jnp.asarray(rho), active=jnp.asarray(act))
    jg = jax_fit(*jax_params(), jd, block_diag=True)
    return jd, jg, convert.to_torch(jd, "cpu"), convert.to_torch(jg, "cpu")


@pytest.mark.parametrize("active", [(True, True, True), (True, False, True)])
def test_observe_all_matches_jax(active):
    jd, jg, td, tg = both_states(1, 48, active)
    jobs = JOBS.observe_all(MODEL, jd, jg, MASS)
    tobs = OBS.observe_all(MODEL, td, tg, MASS)
    assert set(tobs) == set(jobs)
    for name, value in tobs.items():
        assert value.dtype == torch.float64, name
        tol = TOL_GP_INTEGRALS if name in GP_INTEGRALS else TOL
        np.testing.assert_allclose(value.numpy(), np.asarray(jobs[name]), rtol=tol,
                                   atol=1e-300, err_msg=name)


@pytest.mark.parametrize("active", [(True, True, True), (True, True, False)])
def test_point_sum_observables_match_jax(active):
    jd, _, td, _ = both_states(2, 40, active)
    pairs = [
        (OBS.population_each_surface(td), JOBS.population_each_surface(jd)),
        (OBS.r_average_all_surfaces(td), JOBS.r_average_all_surfaces(jd)),
        (OBS.r_average_one_element(td.points[2], td.rho[2]),
         JOBS.r_average_one_element(jd.points[2], jd.rho[2])),
        (OBS.standard_deviation_one_element(td.points[1]),
         JOBS.standard_deviation_one_element(jd.points[1])),
        (OBS.total_energy_each_surface(MODEL, td, MASS),
         JOBS.total_energy_each_surface(MODEL, jd, MASS)),
        (OBS.total_energy_all_surfaces(MODEL, td, MASS),
         JOBS.total_energy_all_surfaces(MODEL, jd, MASS)),
        (OBS.purity_each_element(td), JOBS.purity_each_element(jd)),
    ]
    for i, (ours, theirs) in enumerate(pairs):
        theirs = np.asarray(theirs)
        if not active[2] and i == 2:   # inactive element: 0 / 0 in both packages
            assert np.all(np.isnan(ours.numpy())) and np.all(np.isnan(theirs))
            continue
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=TOL, atol=1e-300,
                                   err_msg=f"pair {i}")


def test_total_energy_and_rho_complex_match_jax():
    jd, jg, td, tg = both_states(3, 32, (True, True, True))
    e = np.array([0.21, 0.37])
    np.testing.assert_allclose(tg.total_energy(torch.tensor(e)).numpy(),
                               np.asarray(jg.total_energy(jnp.asarray(e))),
                               rtol=TOL_GP_INTEGRALS)
    np.testing.assert_array_equal(td.rho_complex, jd.rho_complex)
