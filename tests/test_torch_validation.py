"""PyTorch port: the GPR validation harness (``gple_tpu_torch.validation``) on the CPU.

* ``tests/test_validation.py``'s checks on the port, on frames of the port's
  own DVR oracle, with their bounds.
* ``nll_loss`` of a fit and its gradient with respect to the lengths (a
  vector) and to the full-ARD parameters (diagonal inverse lengths and the
  cross term of W) against ``jax.grad`` of ``gple_tpu.validation.nll_loss``
  on the same inputs, 1e-9 relative; batched over a candidate axis, as the
  line search evaluates it, against JAX's ``vmap``.
* ``grid_weighted_selection`` replays the JAX package's selection from the
  same key (``JaxKeys.randint``); ``input_gen`` writes the JAX package's file.

The NLL fit is thousands of small tensor ops: one intra-op thread per process.
"""

import filecmp
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gple_tpu import validation as JV
from gple_tpu.io import input_gen as JIG
from gple_tpu.ops import kernels as JRK
from gple_tpu_torch import validation as V
from gple_tpu_torch.config import GPLEConfig
from gple_tpu_torch.io.input_gen import cutoff_125, generate_input
from gple_tpu_torch.ops import kernels as RK
from gple_tpu_torch.oracles import DVRConfig, DVRSolver
from gple_tpu_torch.sampler.keys import RandomKeys
from test_torch_kernels import _warm_torch_exp, one_torch_thread  # noqa: F401 (fixtures)
from test_torch_mc import JaxKeys

CPU = "cpu"
TOL_NLL = 1e-9


@pytest.fixture(scope="module")
def dvr_frames():
    cfg = DVRConfig(model="SAC", boundary="reflective", mass=2000.0, x0=-4.0, p0=20.0,
                    sigma_p=1.0, xmin=-6.0, xmax=6.0, dx_input=1.0, output_time=250.0,
                    dt_input=1.0)
    return cfg, DVRSolver(cfg, CPU).run(store_wigner=True, max_outputs=3)


def t64(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float64, requires_grad=grad)


# -- tests/test_validation.py on the port --------------------------------------------------

def test_nll_decreases_with_fit_quality():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 2))
    y = np.exp(-0.5 * np.sum(x**2, axis=1))

    def fit(length):
        params = RK.KernelParams(t64(1.0), t64([length, length]), t64(0.01))
        return RK.fit_real(params, t64(x), t64(y))

    assert float(V.nll_loss(fit(1.0))) < float(V.nll_loss(fit(0.05)))


def test_screenshot_fit_quality(dvr_frames):
    """Fit one exact Wigner snapshot: small relative MSE, and the analytic
    population matches the grid population."""
    cfg, res = dvr_frames
    w = res.wigners[1][0, 0].real
    gx, gp = np.meshgrid(cfg.x_grid, cfg.p_grid, indexing="ij")
    coords = np.stack([gx.ravel(), gp.ravel()], axis=-1)
    da = cfg.dx * (cfg.p_grid[1] - cfg.p_grid[0])
    fit = V.screenshot_fit(RandomKeys(0, CPU), coords, w.ravel(), da, device=CPU)
    assert np.sqrt(fit.mse) / np.abs(w).max() < 5e-3
    assert fit.population_prm == pytest.approx(fit.population_grid, rel=0.02)
    assert np.isfinite(fit.nll)


def test_conservation_rescale_exact_two_surfaces():
    pops, energies = [0.55, 0.38], [0.2, 0.3]
    scale = V.conservation_rescale(pops, energies, 1.0, 0.25)
    assert np.dot(scale, pops) == pytest.approx(1.0, rel=1e-10)
    assert np.dot(scale, np.asarray(pops) * np.asarray(energies)) == pytest.approx(0.25,
                                                                                 rel=1e-10)
    np.testing.assert_array_equal(scale, JV.conservation_rescale(pops, energies, 1.0, 0.25))


def test_evolve_fit_tracks_trajectory(dvr_frames):
    """Warm-started fits across frames conserve the rescaled population and
    energy and track the exact grid values."""
    cfg, res = dvr_frames
    frames = res.wigners[:, [0, 1], [0, 1]].real
    out = V.evolve_fit(RandomKeys(1, CPU), res.times, frames, cfg.x_grid, cfg.p_grid, "SAC",
                       cfg.mass, n_points=150, device=CPU)
    assert len(out) == len(res.times)
    for fr in out:
        err = np.abs(fr.population_prm - fr.population_grid)
        tol = np.maximum(0.02, 0.15 * fr.population_grid)
        assert np.all(err < tol), (fr.population_prm, fr.population_grid)
        assert fr.population_rescaled.sum() == pytest.approx(1.0, rel=1e-8)
        assert fr.mse < 1e-5


def test_input_generator(tmp_path):
    assert cutoff_125(0.11) == pytest.approx(0.2)
    assert cutoff_125(8.2) == pytest.approx(10.0)
    assert cutoff_125(3626) == pytest.approx(5000.0)
    path = str(tmp_path / "input")
    fields = generate_input(-3.0, path=path, mass=2000.0, x0=-8.0)
    assert fields["p0"] == pytest.approx(math.sqrt(2 * 2000.0 * math.exp(-3.0)))
    assert fields["sigma_p0"] == pytest.approx(fields["p0"] / 20.0)
    cfg = GPLEConfig.from_input_file(path)
    assert cfg.mass == 2000.0 and cfg.x0 == -8.0
    assert cfg.p0 == pytest.approx(fields["p0"])


# -- parity with gple_tpu.validation --------------------------------------------------------

def test_input_generator_matches_jax(tmp_path):
    for ln_e, kw in ((-3.0, {}), (-1.2, dict(mass=1000.0, x0=-10.0, number_of_output=20,
                                             num_points=256))):
        ours = generate_input(ln_e, path=str(tmp_path / "ours"), **kw)
        theirs = JIG.generate_input(ln_e, path=str(tmp_path / "theirs"), **kw)
        assert ours == theirs
        assert filecmp.cmp(tmp_path / "ours", tmp_path / "theirs", shallow=False)


def _problem(seed=3, n=40):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 2)) * np.array([1.0, 1.5])
    c, s = np.cos(0.6), np.sin(0.6)
    y = 0.3 * np.exp(-0.5 * (((c * x[:, 0] + s * x[:, 1]) / 0.8) ** 2
                             + ((-s * x[:, 0] + c * x[:, 1]) / 1.6) ** 2))
    return x, y


def _jax_lengths(theta, full_ard):
    if not full_ard:
        return theta
    w = jnp.diag(1.0 / theta[:2])
    return w.at[1, 0].set(theta[2])


def _port_lengths(theta, full_ard):
    if not full_ard:
        return theta
    cross = torch.zeros(theta.shape[:-1] + (2, 2), dtype=theta.dtype)
    cross[..., 1, 0] = 1.0
    return torch.diag_embed(1.0 / theta[..., :2]) + theta[..., 2, None, None] * cross


@pytest.mark.parametrize("full_ard", [False, True], ids=["vector", "full_ard"])
def test_nll_loss_and_gradient_match_jax(full_ard):
    x, y = _problem()
    theta = np.array([0.9, 1.3, 0.35]) if full_ard else np.array([0.9, 1.3])

    def jloss(th):
        params = JRK.KernelParams(magnitude=jnp.asarray(1.0), lengths=_jax_lengths(th, full_ard),
                                  noise=jnp.asarray(1e-2))
        return JV.nll_loss(JRK.fit_real(params, jnp.asarray(x), jnp.asarray(y)))

    th = t64(theta, grad=True)
    params = RK.KernelParams(magnitude=t64(1.0), lengths=_port_lengths(th, full_ard),
                             noise=t64(1e-2))
    loss = V.nll_loss(RK.fit_real(params, t64(x), t64(y)))
    (grad,) = torch.autograd.grad(loss, th)
    ref_loss = float(jloss(jnp.asarray(theta)))
    ref_grad = np.asarray(jax.grad(jloss)(jnp.asarray(theta)))
    assert loss.item() == pytest.approx(ref_loss, rel=TOL_NLL)
    np.testing.assert_allclose(grad.numpy(), ref_grad, rtol=0,
                               atol=TOL_NLL * np.abs(ref_grad).max())


@pytest.mark.parametrize("full_ard", [False, True], ids=["vector", "full_ard"])
def test_batched_nll_matches_jax_vmap(full_ard):
    """The line search's candidate axis: lengths (F, D) or (F, D, D) against
    features broadcast to (F, N, D) -- a matrix batch must not be read as
    vector lengths."""
    x, y = _problem(seed=4, n=30)
    rng = np.random.default_rng(5)
    thetas = rng.uniform(0.6, 1.6, size=(4, 3 if full_ard else 2))
    if full_ard:
        thetas[:, 2] -= 1.1

    def jloss(th):
        params = JRK.KernelParams(magnitude=jnp.asarray(1.0), lengths=_jax_lengths(th, full_ard),
                                  noise=jnp.asarray(1e-2))
        return JV.nll_loss(JRK.fit_real(params, jnp.asarray(x), jnp.asarray(y)))

    th = t64(thetas)
    ones = torch.ones(4, dtype=torch.float64)
    params = RK.KernelParams(magnitude=ones, lengths=_port_lengths(th, full_ard),
                             noise=ones * 1e-2)
    feats = t64(x).expand(4, -1, -1)
    ours = V.nll_loss(RK.fit_real(params, feats, t64(y).expand(4, -1))).numpy()
    theirs = np.asarray(jax.vmap(jloss)(jnp.asarray(thetas)))
    np.testing.assert_allclose(ours, theirs, rtol=TOL_NLL)


def test_grid_weighted_selection_replays_jax():
    rng = np.random.default_rng(6)
    coords = rng.normal(size=(500, 2))
    values = np.where(rng.uniform(size=500) < 0.3, 0.0, rng.normal(size=500))
    key = jax.random.PRNGKey(11)
    jf, jl = JV.grid_weighted_selection(key, coords, values, 120)
    tf, tl = V.grid_weighted_selection(JaxKeys(key), coords, values, 120)
    np.testing.assert_array_equal(tf, np.asarray(jf))
    np.testing.assert_array_equal(tl, np.asarray(jl))
    # fewer nonzero values than points: the selection is padded from its own head
    few = np.zeros(500)
    few[:7] = 1.0
    jf, jl = JV.grid_weighted_selection(key, coords, few, 20)
    tf, tl = V.grid_weighted_selection(JaxKeys(key), coords, few, 20)
    np.testing.assert_array_equal(tf, np.asarray(jf))
    assert tf.shape == (14, 2) and np.all(tl == 1.0)


def test_random_keys_randint():
    key = RandomKeys(5, CPU)
    draws = {key.randint(0, 2**31 - 1) for _ in range(3)}
    assert len(draws) == 1 and 0 <= draws.pop() < 2**31 - 1
    assert RandomKeys(6, CPU).randint(0, 2**31 - 1) != RandomKeys(5, CPU).randint(0, 2**31 - 1)
    with pytest.raises(ValueError, match="batch"):
        key.split_stack(3).randint(0, 10)
