"""PyTorch port: the zoom line-search L-BFGS against ``gple_tpu.gp.opt._lbfgs_zoom``.

``gple_tpu_torch.gp.opt._lbfgs_zoom`` is optax's ``lbfgs()`` (memory 10, the
scaled initial preconditioner, the zoom line search) translated formula for
formula.  On the CPU, in float64, against the JAX package's own
``_lbfgs_zoom`` (no patch: it is the solver its ladder and its validation
reach on the CPU):

* a 4-dimensional Rosenbrock function and an ill-conditioned 6-dimensional
  quadratic (eigenvalues from 1e-3 to 1e3): the iterate after each of the
  first 20 L-BFGS iterations, 1e-10 relative to its largest entry;
* the ladder's diagonal and coherence losses (``tests/test_opt.py``'s
  sampled cloud at N = 64, the coherence of ``tests/test_torch_ladder.py``)
  and one ``_fit_nll`` (the NLL fit of ``tests/test_full_ard.py``'s tilted
  snapshot, axis-aligned and full ARD): the final sigmoid-space iterate,
  1e-6 relative;
* the production DVR's post-crossing frame (SAC, x0 = -10, p0 = 30,
  sigma_p = 1.5, t = 980) on a coarse grid: the DVR in a reflective box
  [-12, 10] that the packet does not reach by then, its Wigner frame on every
  fourth grid point, both fits with the zoom -- lengths 1e-6 relative, both
  leave their start, and the population from the fitted parameters is within
  ``tests/test_validation.py``'s 2% of the grid's.

``_lbfgs_scan`` selects the solver: ``"zoom"`` by default, ``"fan"`` the
fixed fan (``tests/test_torch_ladder.py`` holds that one to JAX's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gple_tpu import validation as JV
from gple_tpu.gp import opt as JO
from gple_tpu_torch import convert
from gple_tpu_torch import validation as V
from gple_tpu_torch.gp import opt as O
from gple_tpu_torch.oracles import schrodinger as S
from gple_tpu_torch.utils import spans
from test_opt import MASS, MODEL, SIGMA, sampled_density
from test_torch_full_ard import _tilted_snapshot
from test_torch_kernels import _warm_torch_exp, one_torch_thread  # noqa: F401 (fixtures)
from test_torch_ladder import _with_coherence
from test_torch_mc import JaxKeys

TOL_ITERATE = 1e-10
TOL_FIT = 1e-6
#: iterations per solve of the ladder-loss comparisons
LOSS_STEPS = 12


def rel(ours, theirs):
    ours = ours.detach().cpu().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    theirs = np.asarray(theirs)
    return float(np.abs(ours - theirs).max() / max(np.abs(theirs).max(), 1e-300))


def _rosenbrock(z):
    """Works on a jax array (one point) and on a torch batch (..., 4)."""
    terms = 100.0 * (z[..., 1:] - z[..., :-1] ** 2) ** 2 + (1.0 - z[..., :-1]) ** 2
    return terms.sum(-1)


def _quadratic():
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.normal(size=(6, 6)))
    h = q @ np.diag(np.logspace(-3, 3, 6)) @ q.T
    b = rng.normal(size=6)
    th, tb = torch.tensor(h), torch.tensor(b)
    return (lambda z: 0.5 * z @ jnp.asarray(h) @ z - jnp.asarray(b) @ z,
            lambda z: 0.5 * torch.einsum("...i,ij,...j->...", z, th, z) - z @ tb)


PROBLEMS = {
    "rosenbrock": (_rosenbrock, _rosenbrock, np.array([-1.2, 1.0, -0.5, 0.8])),
    "quadratic": (*_quadratic(), np.ones(6)),
}


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_zoom_iterates_match_optax(name):
    """Every one of the first 20 iterates, 1e-10 relative; the solve moves."""
    jfn, tfn, z0 = PROBLEMS[name]
    # the step budget as a traced value: one compile for the 20 solves
    jzoom = jax.jit(lambda z, steps: JO._lbfgs_zoom(jfn, z, steps))
    totals = spans.Totals()
    for steps in range(1, 21):
        theirs = np.asarray(jzoom(jnp.asarray(z0), jnp.asarray(steps)))
        with spans.collect(totals):
            ours = O._lbfgs_zoom(tfn, torch.tensor(z0), steps)
        assert rel(ours, theirs) <= TOL_ITERATE, (steps, rel(ours, theirs))
    assert not np.allclose(theirs, z0)
    # one pull per line-search evaluation and one per iteration (which
    # carries a solve's first value)
    done = {k: totals.count("zoom." + k) for k in O.ZOOM_COUNTERS}
    assert done["solves"] == 20 and done["iterations"] == sum(range(1, 21))
    assert done["syncs"] == done["evaluations"] - done["solves"] + done["iterations"]


@pytest.fixture(scope="module")
def ladder_data():
    density, extra = _with_coherence(*sampled_density())
    from gple_tpu.observables import total_energy_each_surface

    energies = total_energy_each_surface(MODEL, density, MASS)
    kw = dict(model=MODEL, mass=MASS, total_energy=float(energies[0]), purity=1.0,
              sigma_r0=SIGMA, opt_mode="ladder")
    jdata, _ = JO.Optimizer(**kw)._pack_data(density, extra, energies)
    tdata, _ = O.Optimizer(**kw, device="cpu")._pack_data(
        convert.to_torch(density, "cpu"), convert.to_torch(extra, "cpu"),
        torch.tensor(np.asarray(energies)))
    return jdata, tdata


@pytest.mark.parametrize("what", ["diag_loss", "off_loss"])
def test_zoom_on_ladder_losses_matches(ladder_data, what):
    jdata, tdata = ladder_data
    if what == "diag_loss":
        lb, ub, start = "dlb", "dub", np.tile(SIGMA, (2, 1))

        def jfn(z):
            return JO._diag_loss(JO._sigmoid_to_bounds(z, jdata[lb], jdata[ub]), jdata)

        def tfn(z):
            return O._diag_loss(O._sigmoid_to_bounds(z, tdata[lb], tdata[ub]), tdata)
    else:
        lb, ub, start = "olb", "oub", np.r_[1.0, SIGMA, 1.0, SIGMA, 0.0]

        def jfn(z):
            return JO._off_loss(JO._sigmoid_to_bounds(z, jdata[lb], jdata[ub]), jdata)

        def tfn(z):
            return O._off_loss(O._sigmoid_to_bounds(z, tdata[lb], tdata[ub]), tdata)
    z0 = np.asarray(JO._bounds_to_sigmoid(jnp.asarray(start), jdata[lb], jdata[ub]))
    theirs = np.asarray(JO._lbfgs_zoom(jfn, jnp.asarray(z0), LOSS_STEPS))
    ours = O._lbfgs_scan(tfn, torch.tensor(z0), LOSS_STEPS)
    assert not np.allclose(theirs, z0)
    assert rel(ours, theirs) <= TOL_FIT, rel(ours, theirs)


@pytest.mark.parametrize("full_ard", [False, True], ids=["vector", "full_ard"])
def test_zoom_fit_nll_matches(full_ard):
    """One ``_fit_nll`` of the tilted snapshot's selection, both packages'
    default solver: the fitted lengths 1e-6 relative."""
    coords, vals, _ = _tilted_snapshot()
    feats, labels = JV.grid_weighted_selection(jax.random.PRNGKey(7), coords, vals, 160)
    std = np.asarray(feats).std(axis=0)
    lb, ub = np.maximum(std / np.sqrt(160), 1e-2), 2.0 * std
    theirs = JV._fit_nll(feats, labels, jnp.asarray(0.5 * std), jnp.asarray(lb),
                         jnp.asarray(ub), steps=20, full_ard=full_ard)
    t = torch.tensor
    ours = V._fit_nll(t(np.asarray(feats)), t(np.asarray(labels)), t(0.5 * std), t(lb), t(ub),
                      steps=20, full_ard=full_ard)
    assert rel(ours.params.lengths, theirs.params.lengths) <= TOL_FIT
    assert rel(ours.params.magnitude, theirs.params.magnitude) <= TOL_FIT


def test_lbfgs_scan_selects_the_solver():
    _, tfn, z0 = PROBLEMS["quadratic"]
    z = torch.tensor(z0)
    torch.testing.assert_close(O._lbfgs_scan(tfn, z, 5), O._lbfgs_zoom(tfn, z, 5), rtol=0,
                               atol=0)
    torch.testing.assert_close(O._lbfgs_scan(tfn, z, 5, "fan"), O._lbfgs_fixed_fan(tfn, z, 5),
                               rtol=0, atol=0)
    assert O.LINE_SEARCHES == ("zoom", "fan") and O.Optimizer.line_search == "zoom"
    with pytest.raises(ValueError, match="line_search"):
        O._lbfgs_scan(tfn, z, 5, "backtracking")


#: the production input's physics (tests' copy of ``entry.trajectory_config``)
PRODUCTION = dict(model="SAC", mass=2000.0, x0=-10.0, p0=30.0, sigma_p=1.5)
T_FRAME = 980.0
STRIDE = 4


@pytest.fixture(scope="module")
def frame_980():
    """The t = 980 frame of the production packet on a coarse grid: every
    fourth grid point of the lower surface's Wigner function."""
    cfg = S.DVRConfig(boundary="reflective", xmin=-12.0, xmax=10.0, dx_input=1.0,
                      output_time=T_FRAME, dt_input=1.0, **PRODUCTION)
    res = S.DVRSolver(cfg, "cpu").run(store_wigner=False, max_outputs=2)
    psi = torch.tensor(res.psis[-1])
    x, p = cfg.x_grid[::STRIDE], cfg.p_grid[::STRIDE]
    w = S.wigner_transform(psi, cfg.x_grid, cfg.p_grid, cfg.dx, cfg.boundary)
    frame = w[0, 0].real.numpy()[::STRIDE, ::STRIDE]
    gx, gp = np.meshgrid(x, p, indexing="ij")
    coords = np.stack([gx.ravel(), gp.ravel()], axis=-1)
    da = (x[1] - x[0]) * (p[1] - p[0])
    return res.times[-1], coords, frame.ravel(), da


@pytest.mark.parametrize("full_ard", [False, True], ids=["vector", "full_ard"])
def test_post_crossing_frame_fit_leaves_its_start(frame_980, full_ard):
    t, coords, vals, da = frame_980
    assert t == T_FRAME
    theirs = JV.screenshot_fit(jax.random.PRNGKey(5), coords, vals, da, full_ard=full_ard)
    ours = V.screenshot_fit(JaxKeys(jax.random.PRNGKey(5)), coords, vals, da,
                            full_ard=full_ard, device="cpu")
    lengths = ours.state.params.lengths.numpy()
    assert rel(lengths, theirs.state.params.lengths) <= TOL_FIT
    assert ours.population_prm == pytest.approx(theirs.population_prm, rel=TOL_FIT)
    # the starting point: lengths0 = std / 2 of the selection (cross term 0)
    feats, _ = V.grid_weighted_selection(JaxKeys(jax.random.PRNGKey(5)), coords, vals, 200)
    start = 0.5 * feats.std(axis=0)
    moved = 1.0 / np.abs(np.diagonal(lengths)) if full_ard else lengths
    assert np.max(np.abs(moved / start - 1.0)) > 1e-3
    assert ours.population_prm == pytest.approx(ours.population_grid, rel=0.02)
