"""PyTorch port: the constrained ladder against ``gple_tpu.gp.opt``.

The clouds are ``tests/test_opt.py``'s Metropolis-sampled density (N = 64
points, 5N extra points), once as it is (only element (0, 0) active) and
once with a quadrature coherence and a small upper population (all three
elements active, so the full pass with the coherence runs).  The JAX
package's ladder runs its CPU inner solver (optax's zoom line search) unless
told otherwise; these tests patch ``gple_tpu.gp.opt._lbfgs_scan`` to its
fixed-fan branch, the one the port has, inside the test only (``jax``'s
caches are cleared around the patch and the step counts are ones no other
test traces, so the patch takes and does not leak).

Limits: the losses, the averages and their gradients (port autograd
through the Cholesky and the kernels' Functions against ``jax.grad``) 1e-7
relative; the fixed-fan L-BFGS 1e-7 relative in the iterate after 5 steps,
and after 10 the loss 1e-9 and the iterate 1e-4 relative (by then the
loss is flat: the fan chooses among candidates whose losses agree to ~1e-15
absolute, so the two packages may step to different points of equal loss); one
``_run_stage`` and a whole ``Optimizer.optimize(opt_mode="ladder")`` 1e-6
relative in lengths, coherence parameters and averages, and 1e-5 relative
in the multipliers and the final error (each of their ~60 line searches
compares candidate losses that agree to ~1e-12, and the error is the loss
at a flat optimum), with the same accepted stage; the
Halton sweeps exactly the same candidate.  The port's optimized fit then
passes ``tests/test_opt.py``'s acceptance checks (population, energy and
purity within 5%, 15% for purity; bounds; fit quality; magnitudes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gple_tpu.gp import opt as jopt
from gple_tpu.observables import total_energy_each_surface
from gple_tpu.storage import Density as JDensity
from gple_tpu_torch import convert
from gple_tpu_torch.gp import opt
from gple_tpu_torch.ops import kernels as RK
from gple_tpu_torch.storage import fit_gp_states
from test_opt import MASS, MODEL, R0, SIGMA, sampled_density
from test_torch_kernels import _warm_torch_exp  # noqa: F401 (fixture)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The ladder is thousands of small tensor ops; with one process per
    core (the suite's workers) intra-op threads only contend for the cores.
    One thread per process for this module; the previous count after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

TOL_LOSS, TOL_FAN, TOL_STAGE, TOL_LAM = 1e-7, 1e-7, 1e-6, 1e-5
TOL_ERROR = TOL_LAM
#: L-BFGS steps of the compared runs: no other test traces this count, so the
#: patched JAX solver is the one compiled (once per problem: the stage test
#: and the cold stages of the optimizer share the static arguments)
OPT_STEPS = 5


@pytest.fixture(scope="module")
def jax_fixed_fan():
    """The JAX ladder on its fixed-fan inner solver, for this module only."""
    jax.clear_caches()
    saved = jopt._lbfgs_scan
    jopt._lbfgs_scan = jopt._lbfgs_fixed_fan
    yield
    jopt._lbfgs_scan = saved
    jax.clear_caches()


def rel(ours, theirs, tol, what):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    theirs = np.asarray(theirs)
    np.testing.assert_allclose(ours, theirs, rtol=tol,
                               atol=tol * max(float(np.abs(theirs).max()), 1e-300),
                               err_msg=what)


def _with_coherence(density, extra):
    """All three elements active: a quadrature coherence, a 1% upper surface."""
    def coh(pts, rho):
        x = np.asarray(pts[1])
        g = np.exp(-np.sum((x - R0) ** 2 / (2 * SIGMA**2), axis=1))
        r = np.array(rho)
        r[1] = 0.05 * np.stack([g * np.cos(x[:, 0]), g * np.sin(x[:, 0])], axis=-1)
        r[2] = 0.01 * r[0]
        return jnp.asarray(r)

    active = jnp.asarray([True, True, True])
    return (JDensity(points=density.points, rho=coh(density.points, density.rho),
                     active=active),
            JDensity(points=extra.points, rho=coh(extra.points, extra.rho), active=active))


@pytest.fixture(scope="module", params=["diagonal", "coherence"])
def problem(request):
    density, extra = sampled_density()
    if request.param == "coherence":
        density, extra = _with_coherence(density, extra)
    energies = total_energy_each_surface(MODEL, density, MASS)
    e0 = float(energies[0])
    kw = dict(model=MODEL, mass=MASS, total_energy=e0, purity=1.0, sigma_r0=SIGMA,
              opt_mode="ladder")
    jo = jopt.Optimizer(**kw)
    jdata, off_active = jo._pack_data(density, extra, energies)
    to = opt.Optimizer(**kw, device="cpu")
    tdata, _ = to._pack_data(convert.to_torch(density, "cpu"), convert.to_torch(extra, "cpu"),
                             torch.tensor(np.asarray(energies)))
    return dict(density=density, extra=extra, energies=energies, kw=kw, jdata=jdata,
                tdata=tdata, off_active=off_active)


def test_packed_bounds_and_targets_match(problem):
    for key in ("dlb", "dub", "olb", "oub", "targets", "dmask", "omask"):
        np.testing.assert_array_equal(problem["tdata"][key].numpy(),
                                      np.asarray(problem["jdata"][key]), err_msg=key)


def _params(problem, rng):
    dlb, dub = np.asarray(problem["jdata"]["dlb"]), np.asarray(problem["jdata"]["dub"])
    olb, oub = np.asarray(problem["jdata"]["olb"]), np.asarray(problem["jdata"]["oub"])
    diag = dlb + (dub - dlb) * rng.uniform(0.2, 0.6, size=dlb.shape)
    off = olb + (oub - olb) * rng.uniform(0.2, 0.6, size=olb.shape)
    return diag, off


@pytest.mark.parametrize("what", ["diag_loss", "off_loss", "population", "energy",
                                  "purity"])
def test_losses_and_gradients_match_jax_grad(problem, what):
    diag, off = _params(problem, np.random.default_rng(41))
    jdata, tdata = problem["jdata"], problem["tdata"]
    with_off = problem["off_active"]
    idx = {"population": 0, "energy": 1, "purity": 2}.get(what)

    def jfn(d, o):
        if what == "diag_loss":
            return jopt._diag_loss(d, jdata)
        if what == "off_loss":
            return jopt._off_loss(o, jdata)
        return jopt._raw_averages(d, o, jdata, with_off)[idx]

    def tfn(d, o):
        if what == "diag_loss":
            return opt._diag_loss(d, tdata)
        if what == "off_loss":
            return opt._off_loss(o, tdata)
        return opt._raw_averages(d, o, tdata, with_off)[idx]

    jval, (jgd, jgo) = jax.value_and_grad(jfn, argnums=(0, 1))(jnp.asarray(diag),
                                                                jnp.asarray(off))
    d, o = torch.tensor(diag, requires_grad=True), torch.tensor(off, requires_grad=True)
    val = tfn(d, o)
    gd, go = torch.autograd.grad(val, (d, o), allow_unused=True)
    rel(val, jval, TOL_LOSS, "value")
    rel(gd if gd is not None else torch.zeros_like(d), jgd, TOL_LOSS, "d/d diag lengths")
    rel(go if go is not None else torch.zeros_like(o), jgo, TOL_LOSS, "d/d off params")


def test_lbfgs_fixed_fan_matches(problem):
    jdata, tdata = problem["jdata"], problem["tdata"]
    dlb, dub = jdata["dlb"], jdata["dub"]
    z0 = np.asarray(jopt._bounds_to_sigmoid(jnp.asarray(np.tile(SIGMA, (2, 1))), dlb, dub))

    def jloss(z):
        return jopt._diag_loss(jopt._sigmoid_to_bounds(z, dlb, dub), jdata)

    def tloss(z):
        return opt._diag_loss(opt._sigmoid_to_bounds(z, tdata["dlb"], tdata["dub"]), tdata)

    for steps, tol in ((5, TOL_FAN), (10, 1e-4)):
        zj = jopt._lbfgs_fixed_fan(jloss, jnp.asarray(z0), steps)
        zt = opt._lbfgs_fixed_fan(tloss, torch.tensor(z0), steps)
        assert not np.allclose(np.asarray(zj), z0)
        rel(zt, zj, tol, f"iterate after {steps} steps")
        rel(tloss(zt[None])[0], jloss(zj), 1e-9, f"loss after {steps} steps")


def test_run_stage_matches(problem, jax_fixed_fan):
    jdata, tdata, off_active = problem["jdata"], problem["tdata"], problem["off_active"]
    diag, off = _params(problem, np.random.default_rng(42))
    lam0 = np.array([[0.5, -0.2, 0.1], [0.3, 0.0, -0.4]])
    ref = jopt._run_stage(jnp.asarray(diag), jnp.asarray(off), jnp.asarray(lam0), jdata,
                          off_active, OPT_STEPS, jopt.AL_OUTER)
    out = opt._run_stage(torch.tensor(diag), torch.tensor(off), torch.tensor(lam0), tdata,
                         off_active, OPT_STEPS, opt.AL_OUTER)
    for o, r, name in zip(out[:4], ref[:4], ("diag lengths", "off params", "error",
                                             "averages")):
        rel(o, r, TOL_ERROR if name == "error" else TOL_STAGE, name)
    rel(out[4], ref[4], TOL_LAM, "multipliers")


@pytest.fixture(scope="module")
def ladder_runs(problem, jax_fixed_fan):
    """Both packages' ``Optimizer.optimize`` from the same state (the warm
    ``local_previous`` stage of a reoptimization is ``test_run_stage_matches``
    with nonzero multipliers)."""
    kw = dict(problem["kw"], lbfgs_steps=OPT_STEPS)
    jo, to = jopt.Optimizer(**kw), opt.Optimizer(**kw, device="cpu")
    energies = problem["energies"]
    jres = jo.optimize(problem["density"], problem["extra"], energies)
    tres = to.optimize(convert.to_torch(problem["density"], "cpu"),
                       convert.to_torch(problem["extra"], "cpu"),
                       torch.tensor(np.asarray(energies)))
    return jo, to, [(jres, tres, jo._al_lam, to._al_lam)]


def test_optimize_ladder_matches(ladder_runs):
    jo, to, runs = ladder_runs
    for jres, tres, jlam, tlam in runs:
        assert tres.opt_type == jres.opt_type
        assert tres.steps == jres.steps == [OPT_STEPS]
        rel(tres.error, jres.error, TOL_ERROR, "error")
        rel(tlam, jlam, TOL_LAM, "multipliers")
    rel(to.diag_lengths, jo.diag_lengths, TOL_STAGE, "diag lengths")
    rel(to.off_params, jo.off_params, TOL_STAGE, "off params")
    rel(to.diag_magnitudes, jo.diag_magnitudes, TOL_STAGE, "diag magnitudes")
    rel(to.off_magnitude, jo.off_magnitude, TOL_STAGE, "off magnitude")


def test_ladder_fit_passes_the_acceptance_checks(ladder_runs, problem):
    """``tests/test_opt.py:67-110`` on the port's optimized parameters."""
    _, to, runs = ladder_runs
    density = convert.to_torch(problem["density"], "cpu")
    diag_params, off_params = to.fitted_params()
    states = fit_gp_states(diag_params, off_params, density, block_diag=False)
    e0 = problem["kw"]["total_energy"]
    energies = torch.tensor(np.asarray(problem["energies"]))
    target_energy = e0 if not problem["off_active"] else float(states.total_energy(energies))
    assert float(states.population()) == pytest.approx(1.0, rel=opt.AVERAGE_TOLERANCE)
    assert float(states.total_energy(energies)) == pytest.approx(target_energy,
                                                                 rel=opt.AVERAGE_TOLERANCE)
    assert float(states.purity()) == pytest.approx(1.0, rel=3 * opt.AVERAGE_TOLERANCE)
    lb, ub = opt.Optimizer.length_bounds(density.points[0].numpy())
    assert np.all(to.diag_lengths[0] >= lb - 1e-9) and np.all(to.diag_lengths[0] <= ub + 1e-9)
    mean, _, _ = RK.predict_real(_element(states.diag, 0), density.points[0])
    scale = float(density.rho[0][:, 0].max())
    np.testing.assert_allclose(mean.numpy(), density.rho[0][:, 0].numpy(), atol=2e-3 * scale)
    assert to.diag_magnitudes[0] > 0
    if not problem["off_active"]:
        assert to.diag_magnitudes[1] == 1.0 and to.off_magnitude == 1.0
    for _, tres, _, _ in runs:
        assert tres.opt_type in ("local_previous", "local_initial", "global")
        assert np.isfinite(tres.error)
    assert [st["tag"] for st in to.stages] == ["local_previous", "local_initial",
                                               "global"][:len(to.stages)]


def _element(state, i):
    if isinstance(state, tuple):
        return type(state)(*(_element(leaf, i) for leaf in state))
    return state[i]


def test_halton_sweeps_pick_the_same_candidates(problem):
    np.testing.assert_array_equal(opt._halton(64, 7), jopt._halton(64, 7))
    rel(opt._global_candidates(problem["tdata"]), jopt._global_candidates(problem["jdata"]),
        1e-12, "diagonal sweep")
    if problem["off_active"]:
        rel(opt._global_candidates_off(problem["tdata"]),
            jopt._global_candidates_off(problem["jdata"]), 1e-12, "coherence sweep")


def test_stage_acceptance_and_comparison_rules():
    """``_check_averages``, ``_accepts`` and ``_compare`` against the JAX
    package's on random stage results."""
    rng = np.random.default_rng(43)
    kw = dict(model=MODEL, mass=MASS, total_energy=0.22, purity=0.9, sigma_r0=SIGMA)
    jo, to = jopt.Optimizer(**kw), opt.Optimizer(**kw, device="cpu")
    for _ in range(50):
        avgs = np.array([1.0, 0.22, 0.9]) * rng.uniform(0.85, 1.15, size=3)
        np.testing.assert_array_equal(to._check_averages(avgs, True),
                                      jo._check_averages(avgs, True))
        a = dict(check=to._check_averages(avgs, True), error=rng.uniform())
        b = dict(check=np.where(rng.uniform(size=3) < 0.5, 0.0, rng.uniform(0, 0.3, 3)),
                 error=rng.uniform())
        assert to._accepts(a) == jo._accepts(a)
        assert to._compare(a, b) is jo._compare(a, b)
