"""PyTorch port: Tully physics, the evolver and the activation test.

The same numpy inputs go through ``gple_tpu`` (CPU, x64) and
``gple_tpu_torch`` (CPU, plain kernel versions).  The Tully functions are
closed forms evaluated in the same order, so they agree to a few ulps; the
evolver's points never touch a GP and agree to 1e-12, and its densities go
through GP predictions and agree to 1e-8 (the limits
``tests/test_sharding.py`` holds the JAX step to).
"""

import functools
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from gple_tpu import driver as JD
from gple_tpu import storage as JS
from gple_tpu.dynamics import evolve as JEV
from gple_tpu.models import tully as JT
from gple_tpu.sampler import mc as JMC
from gple_tpu_torch import convert
from gple_tpu_torch import driver as TD
from gple_tpu_torch import storage as TS
from gple_tpu_torch.dynamics import evolve as EV
from gple_tpu_torch.entry import example_params, example_state
from gple_tpu_torch.models import tully as T
from gple_tpu_torch.ops import graphs as GR
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


#: every non-empty active tuple; the first two keep the ids they had
ACTIVE_TUPLES = [(True, True, True), (True, False, False), (True, True, False),
                 (True, False, True), (False, True, True), (False, True, False),
                 (False, False, True)]


@pytest.fixture(scope="module")
def crossing(states):
    """The example state moved to the avoided crossing (x about 0), refitted:
    there the populated (0,0) element feeds every other element above the
    activation test's epsilon within a tick."""
    jd, jg, _, _ = states
    jd = jd._replace(points=jd.points + jnp.asarray([10.0, 0.0]))
    jg = JS.fit_gp_states(jg.diag.params, jg.offdiag.params, jd, block_diag=True)
    return jd, jg


@pytest.mark.parametrize("active", ACTIVE_TUPLES)
def test_is_very_small_matches(states, crossing, active):
    """JAX's flags, the port's full test (nine predictions) and the port's
    test on the host's tuple (only the pairs it reads) agree, far from the
    coupling and at the crossing, where an inactive element is not small
    because its prediction is above epsilon."""
    for where, (jd, jg) in (("far", states[:2]), ("crossing", crossing)):
        jd = jd._replace(active=jnp.asarray(active))
        jg = jg._replace(active=jnp.asarray(active))
        tgps = convert.to_torch(jg, "cpu")
        tden = convert.to_torch(jd, "cpu")
        ref = np.asarray(JEV.is_very_small(MODEL, MASS, DT, jd, JD.gp_dist_all, jg))
        out = EV.is_very_small(MODEL, MASS, DT, tden, TD.gp_dist_all, tgps).numpy()
        read = EV.is_very_small(MODEL, MASS, DT, tden, TD.gp_dist_all, tgps,
                                active=active).numpy()
        np.testing.assert_array_equal(out, ref, err_msg=where)
        np.testing.assert_array_equal(read, ref, err_msg=where)
        assert not out[np.asarray(active)].any()  # active elements are never small
        if where == "crossing" and active[0]:
            assert not out.any(), out


def test_variance_pairs_counts_the_pairs_read():
    assert EV.variance_pairs(None) == 9
    assert [EV.variance_pairs(a) for a in ACTIVE_TUPLES] == [0, 2, 2, 2, 2, 2, 2]


@pytest.mark.parametrize("targets", list(itertools.product([True, False], repeat=3)))
def test_predict_all_targets(states, targets):
    """``predict_all`` on a subset of targets: the full call's rows where
    predicted, bit for bit (every element is predicted alone), zeros
    elsewhere."""
    _, _, td, tg = states
    pts = td.points + torch.tensor([0.05, -0.3], dtype=torch.float64)
    for with_variance in (True, False):
        full = TS.predict_all(tg, pts, with_variance)
        out = TS.predict_all(tg, pts, with_variance, targets=targets)
        assert out.shape == full.shape
        for k, on in enumerate(targets):
            if on:
                assert torch.equal(out[k], full[k])
            else:
                assert torch.equal(out[k], torch.zeros_like(out[k]))


# -- the tick's evolve on the host's tuple ---------------------------------------------

EVOLVE_DISTS = ["gp_dist_all", "gp_dist_all_nocut", "gp_dist_coh_cut"]


@pytest.mark.parametrize("dist", EVOLVE_DISTS)
@pytest.mark.parametrize("active", ACTIVE_TUPLES)
def test_tick_core_on_the_host_tuple_equals_all_targets(states, crossing, active, dist):
    """A ``_tick_core`` tick whose evolve predicts only the targets of the
    host's tuple against one predicting all three, under each evolve
    distribution, far from the coupling and at the crossing: the density,
    the extra cloud, the flags and the GP states are equal bit for bit (an
    inactive target's rows are zeros either way, and each target is
    predicted alone in both)."""
    for where, (jd, jg) in (("far", states[:2]), ("crossing", crossing)):
        tden = convert.to_torch(jd._replace(active=jnp.asarray(active)), "cpu")
        tgps = convert.to_torch(jg._replace(active=jnp.asarray(active)), "cpu")
        extra = tden._replace(points=tden.points + t64([0.05, -0.3]))
        full, read = (TD._tick_core(MODEL, MASS, DT, tden, extra, tgps, tgps.diag.params,
                                    tgps.offdiag.params, getattr(TD, dist), "none", 0, 2.0,
                                    True, targets)
                      for targets in (None, active))
        for ours, theirs in zip(GR.leaves(read), GR.leaves(full)):
            assert torch.equal(ours, theirs), where


def _matmul_flops(fn) -> int:
    """The flops of the matrix products that ``fn()`` runs."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def test_cutoff_evolve_predicts_one_target_at_the_start():
    """One cutoff ``evolve_step`` with (0,0) alone active, at N = 96: the
    distribution bound to the host's tuple runs about one (10N, N) x (N, N)
    product (the lone diagonal target's variance), the unbound one the
    thirteen of all three targets; and ``_tick_core`` binds the tuple for
    both of its evolves (density and extra cloud)."""
    n = 96
    density, _ = example_state(n, "cpu", generator=torch.Generator().manual_seed(5))
    active = torch.tensor([True, False, False])
    density = density._replace(active=active,
                               rho=torch.where(active[:, None, None], density.rho, 0.0))
    dp, op = example_params("cpu")
    with torch.inference_mode():
        gps = TS.fit_gp_states(dp, op, density, block_diag=True)
    gemm = 2 * 10 * n * n * n

    def evolve(dist):
        return lambda: EV.evolve_step(MODEL, MASS, DT, density, dist, gps)

    bound = _matmul_flops(evolve(functools.partial(TD.gp_dist_all,
                                                   targets=(True, False, False))))
    every = _matmul_flops(evolve(TD.gp_dist_all))
    assert bound <= 1.1 * gemm, bound / gemm
    assert every >= 12 * gemm, every / gemm

    asked = []

    def recorded(gps, pts3, targets=None):
        asked.append(targets)
        return TD.gp_dist_all(gps, pts3, targets=targets)

    TD._tick_core(MODEL, MASS, DT, density, density, gps, dp, op, recorded, "none", 0, 2.0,
                  True, (True, False, False))
    assert asked == [(True, False, False)] * 2
