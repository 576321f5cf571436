"""PyTorch port: Tully physics, the evolver and the activation test.

The same numpy inputs go through ``gple_tpu`` (CPU, x64) and
``gple_tpu_torch`` (CPU, plain kernel versions).  The Tully functions are
closed forms evaluated in the same order, so they agree to a few ulps; the
evolver's points never touch a GP and agree to 1e-12, and its densities go
through GP predictions and agree to 1e-8 (the limits
``tests/test_sharding.py`` holds the JAX step to).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from gple_tpu import driver as JD
from gple_tpu.dynamics import evolve as JEV
from gple_tpu.models import tully as JT
from gple_tpu.sampler import mc as JMC
from gple_tpu_torch import convert
from gple_tpu_torch import driver as TD
from gple_tpu_torch.dynamics import evolve as EV
from gple_tpu_torch.entry import example_state
from gple_tpu_torch.models import tully as T
from gple_tpu_torch.sampler import mc as MC
from test_torch_kernels import _warm_torch_exp, t64  # noqa: F401 (fixture)

MODEL, MASS, DT = "SAC", 2000.0, 1.0
N = 32


def close(out, ref, tol):
    """|out - ref| <= tol * max(1, max |ref|)."""
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(1.0, np.abs(ref).max()))


# -- Tully models ----------------------------------------------------------------------

TULLY_FNS = ["diabatic_potential", "diabatic_force", "diabatic_hesse", "adiabatic_potential",
             "adiabatic_transform", "adiabatic_force", "adiabatic_coupling"]


@pytest.mark.parametrize("fn", TULLY_FNS)
@pytest.mark.parametrize("model", ["SAC", "DAC", "ECR"])
def test_tully_functions_match(model, fn):
    x = np.concatenate([np.linspace(-12.0, 12.0, 241), [0.0, -1e-9, 1e-9]]).reshape(4, 61)
    ref = np.asarray(getattr(JT, fn)(model, jnp.asarray(x)))
    out = getattr(T, fn)(model, t64(x))
    assert tuple(out.shape) == ref.shape
    close(out, ref, 1e-14)


@pytest.mark.parametrize("model", ["SAC", "DAC", "ECR"])
def test_diabatic_force_is_minus_gradient(model):
    x = torch.linspace(-8.0, 8.0, 161, dtype=torch.float64)
    x = x[x != 0].requires_grad_(True)  # |x| has a kink at 0 for SAC/ECR
    v = T.diabatic_potential(model, x)
    f = T.diabatic_force(model, x)
    for i, j in ((0, 0), (0, 1), (1, 1)):
        (grad,) = torch.autograd.grad(v[:, i, j].sum(), x, retain_graph=True)
        np.testing.assert_allclose(-grad.numpy(), f[:, i, j].detach().numpy(),
                                   rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("model", ["SAC", "DAC", "ECR"])
def test_diabatic_hesse_is_minus_force_gradient(model):
    x = torch.linspace(-8.0, 8.0, 161, dtype=torch.float64)
    x = x[x != 0].requires_grad_(True)
    f = T.diabatic_force(model, x)
    h = T.diabatic_hesse(model, x)
    for i, j in ((0, 0), (0, 1), (1, 1)):
        (grad,) = torch.autograd.grad(f[:, i, j].sum(), x, retain_graph=True)
        np.testing.assert_allclose(-grad.numpy(), h[:, i, j].detach().numpy(),
                                   rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("frm,to", [("diabatic", "adiabatic"), ("adiabatic", "force"),
                                    ("force", "diabatic")])
def test_basis_transform_matches(frm, to):
    rng = np.random.default_rng(30)
    x = np.linspace(-3.0, 3.0, 9)
    rho = rng.normal(size=(9, 2, 2)) + 1j * rng.normal(size=(9, 2, 2))
    ref = np.asarray(JT.basis_transform("DAC", jnp.asarray(x), jnp.asarray(rho), frm, to))
    out = T.basis_transform("DAC", t64(x), torch.tensor(rho), frm, to).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-14)


def test_absorbing_potential_and_kinetic_energy_match():
    x = np.linspace(-12.0, 12.0, 97)
    ref = np.asarray(JT.absorbing_potential(2000.0, -8.0, 8.0, 4.0, jnp.asarray(x)))
    close(T.absorbing_potential(2000.0, -8.0, 8.0, 4.0, t64(x)), ref, 1e-14)
    p = np.linspace(-30.0, 30.0, 12).reshape(6, 2)
    close(T.kinetic_energy(2000.0, t64(p)), JT.kinetic_energy(2000.0, jnp.asarray(p)), 1e-15)
    assert T.MANOLOPOULOS_C == JT.MANOLOPOULOS_C


def test_initial_distribution_matches():
    rng = np.random.default_rng(31)
    pts = np.array([-10.0, 30.0]) + rng.normal(size=(50, 2)) * [1 / 3, 1.5]
    args = ((-10.0, 30.0), (1 / 3, 1.5))
    for row, col in ((0, 0), (1, 0), (1, 1)):
        ref = JMC.initial_distribution(*map(jnp.asarray, args), jnp.asarray(pts), row, col,
                                       (0.8, 0.6), (0.0, 0.3))
        out = MC.initial_distribution(*args, t64(pts), row, col, (0.8, 0.6), (0.0, 0.3))
        close(out, ref, 1e-15)


# -- the evolver ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def states():
    """The example state from __graft_entry__ and the port's on the same points."""
    jd, jg = graft._example_state(N)
    td, tg = example_state(N, "cpu", pts0=np.asarray(jd.points[0]))
    return jd, jg, td, tg


def test_evolve_helpers_match():
    rng = np.random.default_rng(32)
    x, p = rng.uniform(-3.0, 3.0, size=40), rng.uniform(5.0, 30.0, size=40)
    close(EV.is_coupling(MODEL, t64(x), t64(p), MASS, DT).numpy().astype(float),
          np.asarray(JEV.is_coupling(MODEL, jnp.asarray(x), jnp.asarray(p), MASS, DT)), 0)
    for i, j in ((0, 0), (1, 0), (1, 1)):
        ref = JEV.adiabatic_leapfrog(MODEL, jnp.asarray(x), jnp.asarray(p), MASS, DT, -1, i, j)
        out = EV.adiabatic_leapfrog(MODEL, t64(x), t64(p), MASS, DT, -1, i, j)
        close(out[0], ref[0], 1e-14)
        close(out[1], ref[1], 1e-14)
        close(EV.omega0(MODEL, t64(x), t64(p * 0.1), i, j),
              JEV.omega0(MODEL, jnp.asarray(x), jnp.asarray(p * 0.1), i, j), 1e-14)


@pytest.mark.parametrize("dist", ["gp_dist_all", "gp_dist_all_nocut"])
def test_evolve_step_matches(states, dist):
    jd, jg, td, tg = states
    ref = JEV.evolve_step(MODEL, MASS, DT, jd, getattr(JD, dist), jg)
    out = EV.evolve_step(MODEL, MASS, DT, td, getattr(TD, dist), tg)
    close(out.points, ref.points, 1e-12)
    close(out.rho, ref.rho, 1e-8)
    np.testing.assert_array_equal(out.active.numpy(), np.asarray(ref.active))


@pytest.mark.parametrize("elem", [0, 1, 2])
def test_predict_new_points_matches(states, elem):
    jd, jg, td, tg = states
    pts = np.asarray(jd.points[elem]) + np.array([0.05, -0.3])
    ref = JEV.predict_new_points(MODEL, MASS, DT, jnp.asarray(pts), elem, JD.gp_dist_all, jg)
    out = EV.predict_new_points(MODEL, MASS, DT, t64(pts), elem, TD.gp_dist_all, tg)
    close(out, ref, 1e-8)


@pytest.mark.parametrize("active", [(True, True, True), (True, False, False)])
def test_is_very_small_matches(states, active):
    jd, jg, td, tg = states
    jd = jd._replace(active=jnp.asarray(active))
    jg = jg._replace(active=jnp.asarray(active))
    tgps = convert.to_torch(jg, "cpu")
    tden = convert.to_torch(jd, "cpu")
    ref = np.asarray(JEV.is_very_small(MODEL, MASS, DT, jd, JD.gp_dist_all, jg))
    out = EV.is_very_small(MODEL, MASS, DT, tden, TD.gp_dist_all, tgps).numpy()
    np.testing.assert_array_equal(out, ref)
    assert not out[np.asarray(active)].any()  # active elements are never small
