"""PyTorch port: the moment optimizer and its losses against ``gple_tpu.gp.opt``.

The same clouds (numpy seeds) go through both packages.  Limits: the LOOCV,
extra-set and analytic-magnitude functions, real and complex, 1e-10
relative; ``Optimizer.optimize`` in moment mode -- lengths, off parameters,
magnitudes and the run.log error -- 1e-10 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gple_tpu.gp import opt as jopt
from gple_tpu.ops import complex_kernels as JCK
from gple_tpu.ops import kernels as JRK
from gple_tpu.storage import Density as JDensity
from gple_tpu_torch import convert
from gple_tpu_torch.gp import opt
from gple_tpu_torch.ops import complex_kernels as CK
from gple_tpu_torch.ops import kernels as RK
from test_torch_kernels import _warm_torch_exp, one_torch_thread  # noqa: F401 (fixtures)
from test_torch_observables import random_clouds

TOL = 1e-10
N = 40
SIGMA = np.array([1.0 / 3.0, 1.5])


def close(ours, theirs, what):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs), rtol=TOL, atol=1e-300,
                               err_msg=what)


@pytest.fixture(scope="module")
def clouds():
    pts, rho, _ = random_clouds(5, N, (True, True, True))
    epts, erho, _ = random_clouds(6, 5 * N, (True, True, True))
    return pts, rho, epts, erho


def test_real_losses_and_magnitude_match(clouds):
    pts, rho, epts, erho = clouds
    d = [0, 2]
    jp = JRK.KernelParams(magnitude=jnp.ones(2), lengths=jnp.asarray(np.stack([SIGMA] * 2)),
                          noise=jnp.full(2, 1e-2))
    jstate = jax.vmap(JRK.fit_real)(jp, jnp.asarray(pts[d]), jnp.asarray(rho[d, :, 0]))
    tstate = RK.fit_real(convert.to_torch(jp, "cpu"), torch.tensor(pts[d]),
                         torch.tensor(rho[d, :, 0]))
    close(RK.loocv_error(tstate), jax.vmap(JRK.loocv_error)(jstate), "loocv")
    close(RK.kinv_diagonal(tstate), jax.vmap(JRK.kinv_diagonal)(jstate), "diag(K^-1)")
    close(RK.extra_set_error(tstate, torch.tensor(epts[d]), torch.tensor(erho[d, :, 0])),
          jax.vmap(JRK.extra_set_error)(jstate, jnp.asarray(epts[d]),
                                        jnp.asarray(erho[d, :, 0])), "extra-set")
    close(RK.optimal_magnitude(tstate), jax.vmap(JRK.optimal_magnitude)(jstate), "magnitude")


def test_complex_losses_and_magnitude_match(clouds):
    pts, rho, epts, erho = clouds
    jp = JCK.ComplexKernelParams(
        magnitude=jnp.asarray(1.0), real_magnitude=jnp.asarray(0.8),
        real_lengths=jnp.asarray(SIGMA / 2), imag_magnitude=jnp.asarray(1.1),
        imag_lengths=jnp.asarray(SIGMA / 1.5), noise=jnp.asarray(1e-2), corr=jnp.asarray(0.0))
    jstate = JCK.fit_complex(jp, jnp.asarray(pts[1]), jnp.asarray(rho[1]), block_diag=True)
    tstate = CK.fit_complex(convert.to_torch(jp, "cpu"), torch.tensor(pts[1]),
                            torch.tensor(rho[1]), block_diag=True)
    close(CK.loocv_error_complex(tstate), JCK.loocv_error_complex(jstate), "loocv")
    close(CK.extra_set_error_complex(tstate, torch.tensor(epts[1]), torch.tensor(erho[1])),
          JCK.extra_set_error_complex(jstate, jnp.asarray(epts[1]), jnp.asarray(erho[1])),
          "extra-set")
    close(CK.optimal_magnitude_complex(tstate), JCK.optimal_magnitude_complex(jstate),
          "magnitude")


def _optimizers():
    kw = dict(model="SAC", mass=2000.0, total_energy=0.23, purity=1.0, sigma_r0=SIGMA)
    return jopt.Optimizer(**kw), opt.Optimizer(**kw, device="cpu")


@pytest.mark.parametrize("active", [(True, True, True), (True, False, False)])
def test_moment_optimizer_matches(active, clouds):
    pts, rho, epts, erho = clouds
    act = np.asarray(active)
    rho = np.where(act[:, None, None], rho, 0.0)
    erho = np.where(act[:, None, None], erho, 0.0)
    jd = JDensity(points=jnp.asarray(pts), rho=jnp.asarray(rho), active=jnp.asarray(act))
    je = JDensity(points=jnp.asarray(epts), rho=jnp.asarray(erho), active=jnp.asarray(act))
    energies = np.array([0.23, 0.0])
    jo, to = _optimizers()
    jres = jo.optimize(jd, je, jnp.asarray(energies))
    tres = to.optimize(convert.to_torch(jd, "cpu"), convert.to_torch(je, "cpu"),
                       torch.tensor(energies))
    assert (tres.opt_type, tres.steps) == (jres.opt_type, jres.steps) == ("moment", [60])
    close(tres.error, jres.error, "error")
    close(to.diag_lengths, jo.diag_lengths, "diag lengths")
    close(to.off_params, jo.off_params, "off params")
    close(to.diag_magnitudes, jo.diag_magnitudes, "diag magnitudes")
    close(to.off_magnitude, jo.off_magnitude, "off magnitude")
    jdiag, joff = jo.fitted_params()
    tdiag, toff = to.fitted_params()
    for ours, theirs in ((tdiag, jdiag), (toff, joff)):
        for f in ours._fields:
            close(getattr(ours, f).numpy(), getattr(theirs, f), f)


def test_wstd_and_length_bounds_match(clouds):
    pts, rho, _, _ = clouds
    close(opt._wstd(torch.tensor(pts[1]), torch.tensor(rho[1, :, 1])),
          jopt._wstd_jnp(jnp.asarray(pts[1]), jnp.asarray(rho[1, :, 1])), "wstd")
    for ours, theirs in zip(opt.Optimizer.length_bounds(pts[0]),
                            jopt.Optimizer.length_bounds(pts[0])):
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("corr", [0.0, -0.37])
def test_off_vector_pack_unpack_round_trip(corr):
    """The coherence's 2D + 3 vector has one layout, (m_R, l_R(D), m_I,
    l_I(D), corr), written out by hand here: ``unpack_off`` reads it from an
    optimizer's parameters (host and tensor, and through ``fitted_params``,
    ``corr`` and param.txt's row) and ``pack_off`` gives it back bit for bit."""
    rng = np.random.default_rng(17)
    d = len(SIGMA)
    off = np.concatenate([[rng.uniform(0.1, 10.0)], rng.uniform(0.01, 3.0, d),
                          [rng.uniform(0.1, 10.0)], rng.uniform(0.01, 3.0, d), [corr]])
    o = opt.Optimizer(model="SAC", mass=2000.0, total_energy=0.1, purity=1.0, sigma_r0=SIGMA,
                      off_params=off.copy(), off_magnitude=2.75, device="cpu")
    host_p = opt.unpack_off(o.off_params, o.off_magnitude, opt.INITIAL_NOISE)
    f64 = dict(dtype=torch.float64)
    dev_p = opt.unpack_off(torch.tensor(o.off_params), torch.tensor(o.off_magnitude, **f64),
                           torch.tensor(opt.INITIAL_NOISE, **f64))
    for p in (host_p, dev_p, o.fitted_params()[1]):
        for field, value in (("real_magnitude", off[0]), ("real_lengths", off[1:1 + d]),
                             ("imag_magnitude", off[1 + d]),
                             ("imag_lengths", off[2 + d:2 + 2 * d]), ("corr", off[-1])):
            np.testing.assert_array_equal(np.asarray(getattr(p, field)), value, err_msg=field)
        assert float(p.magnitude) == 2.75 and float(p.noise) == opt.INITIAL_NOISE
    back = opt.pack_off(host_p.real_magnitude, host_p.real_lengths, host_p.imag_magnitude,
                        host_p.imag_lengths, host_p.corr)
    assert back.dtype == np.float64 and np.array_equal(back, off)
    back_t = opt.pack_off(dev_p.real_magnitude, dev_p.real_lengths, dev_p.imag_magnitude,
                          dev_p.imag_lengths, dev_p.corr)
    assert torch.equal(back_t, torch.tensor(off))
    assert o.corr == corr
    o.adopt(RK.KernelParams(*(np.asarray(t) for t in o.fitted_params()[0])),
            CK.ComplexKernelParams(*(np.asarray(t) for t in dev_p)), 0.5)
    assert np.array_equal(o.off_params, off) and o.off_magnitude == 2.75
    pts = np.random.default_rng(3).normal(size=(3, 8, d))
    _, params, _ = o.param_rows(pts)[1]
    np.testing.assert_array_equal(params, [2.75, *off, opt.INITIAL_NOISE])


def test_ladder_is_not_ported(clouds, one_torch_thread):
    """The constrained ladder is ported whole, with both of the JAX
    package's inner solvers: optax's zoom line search (its CPU branch, the
    default) and the fixed fan (its accelerator branch).  Here it runs on
    all three elements with each, and one of the three stages is accepted;
    an unknown mode raises."""
    pts, rho, epts, erho = clouds
    t = torch.tensor
    from gple_tpu_torch.storage import Density

    density = Density(points=t(pts), rho=t(rho), active=torch.ones(3, dtype=torch.bool))
    extra = Density(points=t(epts), rho=t(erho), active=density.active)
    kw = dict(model="SAC", mass=2000.0, total_energy=0.2, purity=1.0, sigma_r0=SIGMA,
              device="cpu")
    for line_search in opt.LINE_SEARCHES:
        to = opt.Optimizer(**kw, opt_mode="ladder", lbfgs_steps=2, line_search=line_search)
        res = to.optimize(density, extra, t([0.2, 0.0]))
        assert res.opt_type in ("local_previous", "local_initial", "global")
        assert to._al_lam.shape == (2, 3) and np.isfinite(res.error)
        assert (to.stages[0]["zoom"]["solves"] > 0) == (line_search == "zoom")
    assert callable(opt._lbfgs_fixed_fan) and callable(opt._lbfgs_zoom)
    with pytest.raises(ValueError, match="opt_mode"):
        opt.Optimizer(**kw, opt_mode="zoom").optimize(density, extra, t([0.2, 0.0]))
