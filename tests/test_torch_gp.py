"""PyTorch port: the real and complex GP kernels, the refit, and conversion.

Same inputs (``numpy.random.default_rng``) go through ``gple_tpu`` (CPU, x64)
and ``gple_tpu_torch`` (CPU, plain kernel versions); each comparison states
its tolerance.  Inverses of the ~1e5-1e6-conditioned training kernels agree
to ~eps * cond relative between two LAPACK routes, so quantities built on
them (alpha, v, P, Q) get 1e-8, and everything else near f64 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gple_tpu import storage as JS
from gple_tpu.ops import complex_kernels as JCK
from gple_tpu.ops import kernels as JRK
from gple_tpu.ops import linalg as JLA
from gple_tpu_torch import convert
from gple_tpu_torch import storage as TS
from gple_tpu_torch.ops import complex_kernels as CK
from gple_tpu_torch.ops import kernels as RK
from test_torch_kernels import _warm_torch_exp, cloud, t64  # noqa: F401 (fixture)

N_TRAIN, N_TEST = 48, 70


def assert_tree_close(port, ref, tol, path="state"):
    """Compare a port container with a gple_tpu one, field by field:
    |port - ref| <= tol * max(1, max |ref|) for each field."""
    if hasattr(port, "_fields"):
        assert tuple(port._fields) == tuple(ref._fields), path
        for f in port._fields:
            assert_tree_close(getattr(port, f), getattr(ref, f), tol, f"{path}.{f}")
        return
    p = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    r = np.asarray(ref)
    scale = max(1.0, float(np.abs(r).max())) if r.size else 1.0
    np.testing.assert_allclose(p, r, atol=tol * scale, rtol=0, err_msg=path)


@pytest.fixture(scope="module")
def real_data():
    """Two diagonal elements' training sets and batched parameters."""
    rng = np.random.default_rng(11)
    x = cloud(rng, 2, N_TRAIN)
    y = np.exp(-0.5 * np.sum(((x - [-10.0, 30.0]) / [1 / 3, 1.5]) ** 2, axis=-1))
    y = y * np.array([[1.0], [1e-3]])
    xt = cloud(rng, 2, N_TEST)
    vals = dict(magnitude=[1.0, 0.8], lengths=[[0.33, 1.5], [0.4, 1.3]], noise=[1e-2, 2e-2])
    jp = JRK.KernelParams(**{k: jnp.asarray(v) for k, v in vals.items()})
    tp = RK.KernelParams(**{k: t64(v) for k, v in vals.items()})
    jstate = jax.vmap(JRK.fit_real)(jp, jnp.asarray(x), jnp.asarray(y))
    tstate = RK.fit_real(tp, t64(x), t64(y))
    return dict(x=x, y=y, xt=xt, jp=jp, tp=tp, jstate=jstate, tstate=tstate)


def complex_params(corr):
    vals = dict(magnitude=1.1, real_magnitude=0.9, real_lengths=[0.35, 1.4],
                imag_magnitude=1.2, imag_lengths=[0.3, 1.7], noise=1e-2, corr=corr)
    return (JCK.ComplexKernelParams(**{k: jnp.asarray(v) for k, v in vals.items()}),
            CK.ComplexKernelParams(**{k: t64(v) for k, v in vals.items()}))


@pytest.fixture(scope="module")
def complex_data():
    """A corr = 0 coherence training set and its block-diagonal fit."""
    rng = np.random.default_rng(12)
    x = cloud(rng, N_TRAIN)
    amp = np.exp(-0.5 * np.sum(((x - [-10.0, 30.0]) / [1 / 3, 1.5]) ** 2, axis=-1))
    phase = 0.7 * (x[:, 1] - 30.0)
    y = 1e-3 * np.stack([amp * np.cos(phase), amp * np.sin(phase)], axis=-1)
    jp, tp = complex_params(0.0)
    jstate = JCK.fit_complex(jp, jnp.asarray(x), jnp.asarray(y), block_diag=True)
    tstate = CK.fit_complex(tp, t64(x), t64(y), block_diag=True)
    return dict(x=x, y=y, xt=cloud(rng, N_TEST), jstate=jstate, tstate=tstate)


# -- real kernel -----------------------------------------------------------------------

@pytest.mark.parametrize("same", [True, False])
def test_kernel_matrix_matches(real_data, same):
    x, xt = real_data["x"], real_data["xt"]
    xb = x if same else xt
    ref = jax.vmap(lambda p, a, b: JRK.kernel_matrix(p, a, b, same))(
        real_data["jp"], jnp.asarray(x), jnp.asarray(xb))
    out = RK.kernel_matrix(real_data["tp"], t64(x), t64(xb), same)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-15)


def test_finish_real_fit_matches(real_data):
    x, y = real_data["x"], real_data["y"]
    k = np.asarray(jax.vmap(lambda p, a: JRK.kernel_matrix(p, a, a, True))(
        real_data["jp"], jnp.asarray(x)))
    kinv = np.asarray(jax.vmap(JLA.psd_inverse)(jnp.asarray(k)))
    ref = jax.vmap(JRK.finish_real_fit)(real_data["jp"], jnp.asarray(x), jnp.asarray(y),
                                        jnp.asarray(k), jnp.asarray(kinv))
    out = RK.finish_real_fit(real_data["tp"], t64(x), t64(y), t64(k), t64(kinv))
    # same K and K^-1 in: the refinement's residual rounding is amplified by
    # ||K^-1|| ~ 1e4
    assert_tree_close(out, ref, tol=1e-10)


def test_fit_real_matches(real_data):
    out, ref = real_data["tstate"], real_data["jstate"]
    assert_tree_close(out, ref, tol=1e-8)


def test_fit_real_zero_labels_stay_finite(real_data):
    """The 1e-30 clip: all-zero labels (an inactive element) give zeros, not NaN."""
    state = RK.fit_real(real_data["tp"], t64(real_data["x"]),
                        torch.zeros(2, N_TRAIN, dtype=torch.float64))
    assert torch.isfinite(state.rescale).all() and torch.all(state.alpha == 0)


@pytest.mark.parametrize("with_variance", [True, False])
def test_predict_real_matches(real_data, with_variance):
    xt = real_data["xt"]
    ref = jax.vmap(lambda s, q: JRK.predict_real(s, q, with_variance))(
        real_data["jstate"], jnp.asarray(xt))
    out = RK.predict_real(real_data["tstate"], t64(xt), with_variance)
    for o, r, name in zip(out, ref, ("mean", "variance", "cutoff")):
        if r is None:
            assert o is None
            continue
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-8 * max(1.0, np.abs(np.asarray(r)).max()),
                                   err_msg=name)


def test_cutoff_factor_matches():
    rng = np.random.default_rng(13)
    pred = rng.normal(size=200) * 3.0
    var = np.abs(rng.normal(size=200))
    var[:5] = 0.0
    pred[:3] = 0.0
    ref = np.asarray(JRK.cutoff_factor(jnp.asarray(pred), jnp.asarray(var)))
    out = RK.cutoff_factor(t64(pred), t64(var)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-15)
    assert np.all(np.isfinite(out))


@pytest.mark.parametrize("name", ["population", "r_average", "purity"])
def test_real_integrals_match(real_data, name):
    ref = np.asarray(jax.vmap(getattr(JRK, name))(real_data["jstate"]))
    out = getattr(RK, name)(real_data["tstate"]).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-8, atol=0)


def test_real_integrals_with_matrix_lengths():
    """Full-ARD characteristic matrices W go through the same kernels (z = W x)."""
    rng = np.random.default_rng(14)
    x = cloud(rng, 30)
    y = rng.uniform(0.1, 1.0, size=30)
    w = np.array([[3.0, 0.0], [0.2, 0.7]])
    jp = JRK.KernelParams(magnitude=jnp.asarray(1.0), lengths=jnp.asarray(w),
                          noise=jnp.asarray(1e-2))
    tp = RK.KernelParams(magnitude=t64(1.0), lengths=t64(w), noise=t64(1e-2))
    jstate = JRK.fit_real(jp, jnp.asarray(x), jnp.asarray(y))
    tstate = RK.fit_real(tp, t64(x), t64(y))
    for name in ("population", "purity"):
        np.testing.assert_allclose(getattr(RK, name)(tstate).numpy(),
                                   np.asarray(getattr(JRK, name)(jstate)), rtol=1e-8)
    xt = cloud(rng, 12)
    ref = JRK.predict_real(jstate, jnp.asarray(xt), False)[0]
    out = RK.predict_real(tstate, t64(xt), False)[0]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-8 * np.abs(np.asarray(ref)).max())


# -- complex kernel ----------------------------------------------------------------------

@pytest.mark.parametrize("corr", [0.0, 0.7])
@pytest.mark.parametrize("same", [True, False])
def test_covariance_matrices_match(corr, same):
    rng = np.random.default_rng(15)
    xa, xb = cloud(rng, 40), cloud(rng, 40)
    if same:
        xb = xa
    jp, tp = complex_params(corr)
    ref = JCK.covariance_matrices(jp, jnp.asarray(xa), jnp.asarray(xb), same)
    out = CK.covariance_matrices(tp, t64(xa), t64(xb), same)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=1e-15)


def test_finish_complex_fit_matches():
    rng = np.random.default_rng(16)
    x = cloud(rng, 40)
    y = 1e-3 * rng.normal(size=(40, 2))
    jp, tp = complex_params(0.0)
    k, kt_re, kt_im = (np.asarray(m) for m in JCK.covariance_matrices(
        jp, jnp.asarray(x), jnp.asarray(x), True))
    w = np.asarray(jax.vmap(JLA.psd_inverse)(jnp.stack([k + kt_re, k - kt_re])))
    ref = JCK.finish_complex_fit(jp, jnp.asarray(x), jnp.asarray(y), *map(jnp.asarray, (
        k, kt_re, kt_im, w[0], w[1])))
    out = CK.finish_complex_fit(tp, t64(x), t64(y), *map(t64, (k, kt_re, kt_im, w[0], w[1])))
    # same inverse blocks in: the refinement's residual rounding is amplified
    # by ||P|| ~ 1e4
    assert_tree_close(out, ref, tol=1e-10)


def test_fit_complex_block_diag_matches(complex_data):
    out, ref = complex_data["tstate"], complex_data["jstate"]
    for f in ("p_re", "p_im", "q_re", "q_im"):
        scale = np.abs(np.asarray(getattr(ref, f))).max() or 1.0
        np.testing.assert_allclose(getattr(out, f).numpy() / scale,
                                   np.asarray(getattr(ref, f)) / scale, atol=1e-8, err_msg=f)
    np.testing.assert_allclose(out.v.numpy(), np.asarray(ref.v), atol=1e-8)
    np.testing.assert_allclose(out.rescale.numpy(), np.asarray(ref.rescale), rtol=1e-15)


def test_complex_unported_paths_raise(complex_data):
    _, tp = complex_params(0.0)
    x, y = t64(complex_data["x"]), t64(complex_data["y"])
    # the chirp estimate is the complex kernel's one unported path
    for block_diag in (True, False):
        with pytest.raises(NotImplementedError, match="chirp"):
            CK.fit_complex(tp, x, y, chirp=True, block_diag=block_diag)


@pytest.mark.parametrize("with_variance", [True, False])
def test_predict_complex_matches(complex_data, with_variance):
    xt = complex_data["xt"]
    ref = JCK.predict_complex(complex_data["jstate"], jnp.asarray(xt), with_variance)
    out = CK.predict_complex(complex_data["tstate"], t64(xt), with_variance)
    for o, r, name in zip(out, ref, ("mean", "variance", "cutoff")):
        if r is None:
            assert o is None
            continue
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-8 * max(1.0, np.abs(np.asarray(r)).max()),
                                   err_msg=name)


@pytest.mark.parametrize("corr", [0.0, 0.7])
def test_purity_complex_matches(complex_data, corr):
    jp, tp = complex_params(corr)
    jstate = complex_data["jstate"]._replace(params=jp)
    tstate = complex_data["tstate"]._replace(params=tp)
    np.testing.assert_allclose(CK.purity_complex(tstate).numpy(),
                               np.asarray(JCK.purity_complex(jstate)), rtol=1e-8)


# -- the refit and the GPStates container ---------------------------------------------

@pytest.fixture(scope="module")
def density_pair():
    rng = np.random.default_rng(17)
    pts = cloud(rng, 3, 40)
    rho = np.zeros((3, 40, 2))
    amp = np.exp(-0.5 * np.sum(((pts - [-10.0, 30.0]) / [1 / 3, 1.5]) ** 2, axis=-1))
    rho[0, :, 0], rho[1, :, 1], rho[2, :, 0] = amp[0], 1e-3 * amp[1], 1e-3 * amp[2]
    active = np.array([True, True, True])
    jd = JS.Density(points=jnp.asarray(pts), rho=jnp.asarray(rho), active=jnp.asarray(active))
    return jd, convert.to_torch(jd, "cpu")


def _params():
    vals = dict(magnitude=[1.0, 1.0], lengths=[[1 / 3, 1.5]] * 2, noise=[1e-2, 1e-2])
    jd = JRK.KernelParams(**{k: jnp.asarray(v) for k, v in vals.items()})
    return jd, convert.to_torch(jd, "cpu")


@pytest.mark.parametrize("warm", [False, True])
def test_fit_gp_states_matches(density_pair, warm):
    jd, td = density_pair
    jdp, tdp = _params()
    jop, top = complex_params(0.0)
    jprev = JS.fit_gp_states(jdp, jop, jd, block_diag=True) if warm else None
    tprev = convert.to_torch(jprev, "cpu") if warm else None
    ref = JS.fit_gp_states(jdp, jop, jd, prev=jprev, block_diag=True)
    out = TS.fit_gp_states(tdp, top, td, prev=tprev, block_diag=True)
    np.testing.assert_allclose(out.diag.alpha.numpy(), np.asarray(ref.diag.alpha), atol=1e-8)
    np.testing.assert_allclose(out.offdiag.v.numpy(), np.asarray(ref.offdiag.v), atol=1e-8)
    np.testing.assert_allclose(out.diag.kinv.numpy() / 1e4, np.asarray(ref.diag.kinv) / 1e4,
                               atol=1e-8)
    assert_tree_close(out.diag.params, ref.diag.params, tol=0.0)
    np.testing.assert_array_equal(out.active.numpy(), np.asarray(ref.active))


def test_fit_gp_states_unported_paths_raise(density_pair):
    _, td = density_pair
    _, tdp = _params()
    _, top = complex_params(0.0)
    # the coherence booster is the refit's one unported path
    for block_diag in (True, False):
        with pytest.raises(NotImplementedError, match="off_extra"):
            TS.fit_gp_states(tdp, top, td, off_extra=(td.points[1], td.rho[1]),
                             block_diag=block_diag)


@pytest.fixture(scope="module")
def gps_pair(density_pair):
    jd, td = density_pair
    jdp, _ = _params()
    jop, _ = complex_params(0.0)
    jgps = JS.fit_gp_states(jdp, jop, jd._replace(active=jnp.asarray([True, True, False])),
                            block_diag=True)
    return jgps, convert.to_torch(jgps, "cpu")


@pytest.mark.parametrize("name", ["population", "population_each", "r_average", "purity"])
def test_gpstates_observables_match(gps_pair, name):
    jgps, tgps = gps_pair
    np.testing.assert_allclose(getattr(tgps, name)().numpy(),
                               np.asarray(getattr(jgps, name)()), rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("with_variance", [True, False])
@pytest.mark.parametrize("elem", [0, 1, 2])
def test_predict_element_matches(gps_pair, elem, with_variance):
    jgps, tgps = gps_pair
    rng = np.random.default_rng(18 + elem)
    q = cloud(rng, 25)
    ref = np.asarray(JS.predict_element(jgps, elem, jnp.asarray(q), with_variance))
    out = TS.predict_element(tgps, elem, t64(q), with_variance).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-8 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("with_variance", [True, False])
def test_make_distribution_matches(gps_pair, with_variance):
    jgps, tgps = gps_pair
    q = cloud(np.random.default_rng(21), 3, 25)
    ref = np.asarray(JS.make_distribution(jgps, with_variance)(jnp.asarray(q)))
    out = TS.make_distribution(tgps, with_variance)(t64(q)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-8 * np.abs(ref).max())
    assert np.all(out[2] == 0.0)  # the inactive element predicts zero


# -- conversion ---------------------------------------------------------------------------

def test_convert_round_trip(gps_pair):
    jgps, tgps = gps_pair
    assert type(tgps) is TS.GPStates and type(tgps.diag.params) is RK.KernelParams
    assert tgps.active.dtype == torch.bool and tgps.diag.alpha.dtype == torch.float64
    back = convert.to_numpy(tgps)
    assert_tree_close(back, jgps, tol=0.0)


def test_convert_rejects_mismatched_fields():
    from collections import namedtuple

    Density = namedtuple("Density", ["points", "rho"])
    with pytest.raises(ValueError, match="fields"):
        convert.to_torch(Density(points=np.zeros((3, 2, 2)), rho=np.zeros((3, 2, 2))), "cpu")
