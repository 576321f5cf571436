"""PyTorch port: the full lower-triangular ARD matrix and its gradient, on the CPU.

* ``tests/test_full_ard.py``'s checks on the port: the matrix Gram reduces to
  the vector one and matches the naive formula; the population, <r>, purity,
  potential and kinetic integrals of a matrix-length fit match quadrature of
  its own prediction; the full-ARD snapshot fit beats the axis-aligned one on
  a tilted distribution.
* The Gram's points cotangent (``gram_kernels.gram_vjp_points_pair_plain``,
  the plain version of the ``rbf_gram_vjp_points`` kernel's pair call, both
  point sets at once, behind ``RBFGram``'s backward): ``gradcheck``, and its
  values against ``jax.grad`` of ``gple_tpu.ops.kernels.gram`` with respect
  to both point sets, vector and matrix lengths, B = 1-3, D = 1-4, Na != Nb,
  1e-12 relative.
* The integrals of a JAX matrix-length state carried across
  (``convert.to_torch``) against ``gple_tpu``'s, 1e-10 relative.
* ``screenshot_fit`` against ``gple_tpu.validation.screenshot_fit`` on the
  same tilted snapshot and key: with both packages' default solver (optax's
  zoom line search), unpatched; and with the fixed fan (the port's
  ``line_search="fan"``, patched into ``gple_tpu.validation`` with
  ``jax.clear_caches()`` around it): lengths 1e-6 relative, MSE and
  populations 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gple_tpu import validation as JV
from gple_tpu.gp import opt as JO
from gple_tpu.models import tully as JT
from gple_tpu.ops import kernels as JRK
from gple_tpu_torch import convert
from gple_tpu_torch import validation as V
from gple_tpu_torch.models import tully
from gple_tpu_torch.ops import gram_kernels as GK
from gple_tpu_torch.ops import kernels as K
from gple_tpu_torch.utils.constants import purity_factor
from test_torch_kernels import _warm_torch_exp, one_torch_thread  # noqa: F401 (fixtures)
from test_torch_mc import JaxKeys

TOL_FIT = 1e-6


def t64(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float64, requires_grad=grad)


def tilted_gaussian(coords, theta=0.6, sx=0.8, sp=1.6):
    """A rotated anisotropic Gaussian: correlated in x and p."""
    c, s = np.cos(theta), np.sin(theta)
    u = c * coords[:, 0] + s * coords[:, 1]
    v = -s * coords[:, 0] + c * coords[:, 1]
    return 0.3 * np.exp(-0.5 * ((u / sx) ** 2 + (v / sp) ** 2))


def _tilted_snapshot():
    g = np.linspace(-6.0, 6.0, 61)
    gx, gp = np.meshgrid(g, g, indexing="ij")
    coords = np.stack([gx.ravel(), gp.ravel()], axis=-1)
    return coords, tilted_gaussian(coords), (g[1] - g[0]) ** 2


def _port_fits(line_search):
    """The port's axis-aligned and full-ARD fits of the tilted snapshot, from
    the JAX key of ``tests/test_full_ard.py`` (the same selected points)."""
    coords, vals, da = _tilted_snapshot()
    key = JaxKeys(jax.random.PRNGKey(7))
    return {full: V.screenshot_fit(key, coords, vals, da, n_points=160, full_ard=full,
                                   device="cpu", line_search=line_search)
            for full in (False, True)}


@pytest.fixture(scope="module")
def tilted_fits():
    return _port_fits("zoom")


@pytest.fixture(scope="module")
def tilted_fits_fan():
    return _port_fits("fan")


# -- tests/test_full_ard.py on the port ----------------------------------------------------

def test_matrix_gram_reduces_to_vector():
    rng = np.random.default_rng(3)
    x = t64(rng.normal(size=(20, 2)))
    lengths = t64([0.7, 1.3])
    np.testing.assert_allclose(K.gram(torch.diag(1.0 / lengths), x, x).numpy(),
                               K.gram(lengths, x, x).numpy(), rtol=1e-12)


def test_matrix_gram_cross_term_naive():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(12, 2))
    w = np.array([[1.4, 0.0], [0.5, 0.9]])
    g = K.gram(t64(w), t64(x), t64(x)).numpy()
    for i in range(12):
        for j in range(12):
            d = w @ (x[i] - x[j])
            assert g[i, j] == pytest.approx(np.exp(-0.5 * np.dot(d, d)), rel=1e-12)


def _matrix_state(seed=0, w10=0.45):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(64, 2)) * np.array([1.0, 1.5])
    y = tilted_gaussian(x)
    w = np.array([[1.0 / 0.9, 0.0], [w10, 1.0 / 1.4]])
    params = K.KernelParams(magnitude=t64(0.5), lengths=t64(w), noise=t64(1e-2))
    return K.fit_real(params, t64(x), t64(y))


def _quadrature(state, fn):
    """Integrate fn(mean(r)) over a wide grid around the training points."""
    g = np.linspace(-12.0, 12.0, 241)
    da = (g[1] - g[0]) ** 2
    gx, gp = np.meshgrid(g, g, indexing="ij")
    coords = np.stack([gx.ravel(), gp.ravel()], -1)
    mean, _, _ = K.predict_real(state, t64(coords), with_variance=False)
    return float(np.sum(fn(mean.numpy(), coords)) * da)


def test_matrix_population_matches_quadrature():
    st = _matrix_state()
    assert float(K.population(st)) == pytest.approx(_quadrature(st, lambda m, r: m), rel=1e-6)


def test_matrix_r_average_matches_quadrature():
    st = _matrix_state()
    qx = _quadrature(st, lambda m, r: m * r[:, 0])
    qp = _quadrature(st, lambda m, r: m * r[:, 1])
    np.testing.assert_allclose(K.r_average(st).numpy(), [qx, qp], rtol=1e-5, atol=1e-10)


def test_matrix_purity_matches_quadrature():
    st = _matrix_state()
    quad = _quadrature(st, lambda m, r: m**2) * purity_factor(1)
    assert float(K.purity(st)) == pytest.approx(quad, rel=1e-6)


@pytest.mark.parametrize("w10", [0.0, 0.45])
def test_potential_energy_matches_quadrature(w10):
    st = _matrix_state(w10=w10)

    def weight(m, r):
        return m * tully.adiabatic_potential("SAC", t64(r[:, 0]))[:, 0].numpy()

    e_prm = float(V.potential_energy_prm(st, "SAC", 0))
    assert e_prm == pytest.approx(_quadrature(st, weight), rel=1e-5, abs=1e-12)


@pytest.mark.parametrize("w10", [0.0, 0.45])
def test_kinetic_energy_matches_quadrature(w10):
    st = _matrix_state(w10=w10)
    mass = 2000.0
    quad = _quadrature(st, lambda m, r: m * r[:, 1] ** 2 / (2.0 * mass))
    assert float(V.kinetic_energy_prm(st, mass)) == pytest.approx(quad, rel=1e-5)


def test_full_ard_beats_axis_aligned_on_tilted_snapshot(tilted_fits):
    axis, full = tilted_fits[False], tilted_fits[True]
    assert full.state.params.lengths.dim() == 2
    assert abs(float(full.state.params.lengths[1, 0])) > 1e-3  # used the tilt
    assert full.mse < 0.7 * axis.mse
    assert full.population_prm == pytest.approx(full.population_grid, rel=0.15)


# -- the points cotangent -------------------------------------------------------------------

def test_gradcheck_rbf_gram_points():
    rng = np.random.default_rng(31)
    args = (t64(rng.uniform(0.5, 2.0, size=(2, 2)), True), t64(rng.normal(size=(2, 7, 2)), True),
            t64(rng.normal(size=(2, 5, 2)), True))
    assert torch.autograd.gradcheck(GK.RBFGram.apply, args)


@pytest.mark.parametrize("lengths_kind", ["vector", "matrix"])
def test_points_cotangent_matches_jax_grad(lengths_kind):
    """d/dxa and d/dxb of sum(G * gout) through the port's Gram (vector
    lengths: RBFGram's points cotangent directly; matrix lengths: through
    z = W x) against ``jax.grad`` of ``gple_tpu.ops.kernels.gram``."""
    rng = np.random.default_rng(32)
    xa, xb, gout = rng.normal(size=(9, 2)), rng.normal(size=(6, 2)), rng.normal(size=(9, 6))
    lengths = (np.array([0.8, 1.3]) if lengths_kind == "vector"
               else np.array([[1.2, 0.0], [0.4, 0.7]]))

    def jf(l, a, b):
        return jnp.sum(JRK.gram(l, a, b) * gout)

    refs = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(lengths), jnp.asarray(xa),
                                          jnp.asarray(xb))
    l, a, b = t64(lengths, True), t64(xa, True), t64(xb, True)
    ours = torch.autograd.grad(torch.sum(K.gram(l, a, b) * t64(gout)), (l, a, b))
    for o, r in zip(ours, refs):
        r = np.asarray(r)
        np.testing.assert_allclose(o.numpy(), r, rtol=0, atol=1e-12 * np.abs(r).max())


#: (B, Na, Nb, D, lengths): vector lengths (B, D) or a lower-triangular W (B, D, D)
PAIR_CASES = [(1, 9, 6, 2, "vector"), (2, 7, 11, 1, "vector"), (3, 4, 9, 4, "vector"),
              (1, 6, 6, 2, "matrix"), (3, 5, 8, 3, "matrix"), (2, 12, 4, 4, "matrix")]


@pytest.mark.parametrize("batch,na,nb,d,kind", PAIR_CASES)
def test_points_pair_plain_matches_jax_grad(batch, na, nb, d, kind):
    """Both outputs of the pair's plain version against ``jax.grad`` of
    sum(G * gout) with respect to xa and xb (inputs from numpy).  Matrix
    lengths reach the pair as z = W x with unit lengths, so the cotangent of
    x is that of z times W."""
    rng = np.random.default_rng(35 + batch * 10 + d)
    xa, xb = rng.normal(size=(batch, na, d)), rng.normal(size=(batch, nb, d))
    gout = rng.normal(size=(batch, na, nb))
    if kind == "vector":
        lengths = rng.uniform(0.5, 2.0, size=(batch, d))
    else:
        lengths = np.tril(rng.normal(scale=0.4, size=(batch, d, d)), -1)
        lengths += np.einsum("bi,ij->bij", rng.uniform(0.6, 1.5, size=(batch, d)), np.eye(d))

    def jf(a, b):  # one Gram a batch entry, as the JAX package batches it
        return jnp.sum(jax.vmap(JRK.gram)(jnp.asarray(lengths), a, b) * gout)

    refs = jax.grad(jf, argnums=(0, 1))(jnp.asarray(xa), jnp.asarray(xb))
    g = t64(gout)
    if kind == "vector":
        ours = GK.gram_vjp_points_pair_plain(t64(lengths), t64(xa), t64(xb), g)
    else:
        w = t64(lengths)
        za, zb = (torch.einsum("bij,bnj->bni", w, t64(x)) for x in (xa, xb))
        dza, dzb = GK.gram_vjp_points_pair_plain(torch.ones(batch, d, dtype=torch.float64),
                                                 za, zb, g)
        ours = (dza @ w, dzb @ w)
    for o, r in zip(ours, refs):
        r = np.asarray(r)
        assert o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), r, rtol=0, atol=1e-12 * np.abs(r).max())


@pytest.mark.parametrize("want_a,want_b", [(True, False), (False, True)])
def test_points_pair_plain_one_side(want_a, want_b):
    """A side not asked for is None; the other equals the pair's."""
    rng = np.random.default_rng(36)
    l, xa, xb = t64(rng.uniform(0.5, 2.0, size=(2, 3))), t64(rng.normal(size=(2, 5, 3))), \
        t64(rng.normal(size=(2, 4, 3)))
    g = t64(rng.normal(size=(2, 5, 4)))
    both = GK.gram_vjp_points_pair_plain(l, xa, xb, g)
    one = GK.gram_vjp_points_pair_plain(l, xa, xb, g, want_a, want_b)
    for o, b, want in zip(one, both, (want_a, want_b)):
        assert (o is None) != want and (o is None or torch.equal(o, b))


def test_points_vjp_plain_matches_autograd():
    """The plain cotangent of each point set, the second one through the
    transposed cotangent, against autograd of the plain Gram."""
    rng = np.random.default_rng(33)
    l = t64(rng.uniform(0.5, 2.0, size=(3, 2)))
    xa, xb = t64(rng.normal(size=(3, 8, 2)), True), t64(rng.normal(size=(3, 5, 2)), True)
    g = t64(rng.normal(size=(3, 8, 5)))
    ra, rb = torch.autograd.grad(GK.gram_plain(l, xa, xb), (xa, xb), g)
    da = GK.gram_vjp_points_plain(l, xa.detach(), xb.detach(), g)
    db = GK.gram_vjp_points_plain(l, xb.detach(), xa.detach(), g.transpose(-1, -2))
    for ours, ref in ((da, ra), (db, rb)):
        assert ((ours - ref).abs().max() / ref.abs().max()).item() <= 1e-12


def test_matrix_state_integrals_match_jax():
    rng = np.random.default_rng(34)
    x = rng.normal(size=(50, 2)) * np.array([1.0, 1.5])
    w = jnp.asarray([[1.1, 0.0], [0.3, 0.8]])
    jst = JRK.fit_real(JRK.KernelParams(magnitude=jnp.asarray(0.7), lengths=w,
                                        noise=jnp.asarray(1e-2)),
                       jnp.asarray(x), jnp.asarray(tilted_gaussian(x)))
    st = convert.to_torch(jst, "cpu")
    assert st.params.lengths.shape == (2, 2)
    pairs = [(K.population(st), JRK.population(jst)), (K.r_average(st), JRK.r_average(jst)),
             (K.purity(st), JRK.purity(jst)),
             (V.kinetic_energy_prm(st, 2000.0), JV.kinetic_energy_prm(jst, 2000.0))]
    pairs += [(V.potential_energy_prm(st, "SAC", s), JV.potential_energy_prm(jst, "SAC", s))
              for s in (0, 1)]
    for ours, theirs in pairs:
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-10)
    back = convert.to_numpy(st)
    np.testing.assert_array_equal(back.params.lengths, np.asarray(jst.params.lengths))
    # a potential evaluated the JAX package's way, for the record of the models
    np.testing.assert_allclose(tully.adiabatic_potential("SAC", t64(x[:, 0])).numpy(),
                               np.asarray(JT.adiabatic_potential("SAC", jnp.asarray(x[:, 0]))),
                               rtol=1e-13)


def _check_fit_pair(ours, theirs):
    jl = np.asarray(theirs.state.params.lengths)
    np.testing.assert_allclose(ours.state.params.lengths.numpy(), jl, rtol=0,
                               atol=TOL_FIT * np.abs(jl).max())
    for name in ("mse", "population_grid", "population_prm"):
        assert getattr(ours, name) == pytest.approx(getattr(theirs, name), rel=TOL_FIT), name


@pytest.mark.parametrize("full_ard", [False, True], ids=["vector", "full_ard"])
def test_screenshot_fit_matches_jax(tilted_fits_fan, full_ard):
    """The same snapshot, key and solver: the JAX package's fit with its
    ``_lbfgs_scan`` (bound into ``gple_tpu.validation``) replaced by the
    fixed fan, against the port's ``line_search="fan"``."""
    coords, vals, da = _tilted_snapshot()
    saved = JV._lbfgs_scan
    JV._lbfgs_scan = JO._lbfgs_fixed_fan
    jax.clear_caches()
    try:
        theirs = JV.screenshot_fit(jax.random.PRNGKey(7), coords, vals, da, n_points=160,
                                   full_ard=full_ard)
    finally:
        JV._lbfgs_scan = saved
        jax.clear_caches()
    _check_fit_pair(tilted_fits_fan[full_ard], theirs)


@pytest.mark.parametrize("full_ard", [False, True], ids=["vector", "full_ard"])
def test_screenshot_fit_zoom_matches_jax(tilted_fits, full_ard):
    """Both packages' fit as they are: optax's zoom line search, unpatched."""
    coords, vals, da = _tilted_snapshot()
    theirs = JV.screenshot_fit(jax.random.PRNGKey(7), coords, vals, da, n_points=160,
                               full_ard=full_ard)
    _check_fit_pair(tilted_fits[full_ard], theirs)
