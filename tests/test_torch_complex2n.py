"""PyTorch port: the coherence's full (2N, 2N) fit against ``gple_tpu``.

The constrained ladder learns the Re-Im correlation, so its coherence fits
go through the full embedding M = [[K + R, C], [C, K - R]] instead of the
block-diagonal (corr = 0) production path.  Same seeded numpy inputs (N = 48
training points, 70 test points) go through both packages on the CPU.

Limits: P and Q 1e-10 relative to the largest entry of the inverse W = M^-1
they are taken from, and v 1e-10 relative to its largest entry (two LAPACK
routes to the same (2N, 2N) inverse, conditioned ~1e5; Im P and Im Q are
differences of W's off-diagonal blocks, far below W's scale); the
prediction mean and variance, the LOOCV error, the optimal magnitude and the
purity 1e-9 relative; the refit ``fit_gp_states(block_diag=False)`` cold and
warm, alpha and v 1e-8 absolute (the limits of the block-diagonal refit test,
``tests/test_torch_gp.py``); a candidate batch of fits equals the fits one
by one to 1e-9 relative (a batched and an unbatched matrix-vector product
round differently, and the fit amplifies that by its conditioning).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gple_tpu import storage as JS
from gple_tpu.ops import complex_kernels as JCK
from gple_tpu.ops import kernels as JRK
from gple_tpu_torch import convert
from gple_tpu_torch import storage as TS
from gple_tpu_torch.ops import complex_kernels as CK
from test_torch_gp import complex_params
from test_torch_kernels import _warm_torch_exp, cloud, t64  # noqa: F401 (fixture)

N_TRAIN, N_TEST = 48, 70
CORRS = [0.5, -0.7, 1.0]

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The ladder is thousands of small tensor ops; with one process per
    core (the suite's workers) intra-op threads only contend for the cores.
    One thread per process for this module; the previous count after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

TOL_FIT, TOL_OBS, TOL_REFIT, TOL_BATCH = 1e-10, 1e-9, 1e-8, 1e-9


def rel_close(ours, theirs, tol, what, scale=None):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    theirs = np.asarray(theirs)
    scale = max(float(np.abs(theirs).max()), 1e-300) if scale is None else scale
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=tol * scale, err_msg=what)


@pytest.fixture(scope="module")
def coherence():
    rng = np.random.default_rng(31)
    x = cloud(rng, N_TRAIN)
    amp = np.exp(-0.5 * np.sum(((x - [-10.0, 30.0]) / [1 / 3, 1.5]) ** 2, axis=-1))
    phase = 0.7 * (x[:, 1] - 30.0)
    y = 1e-3 * np.stack([amp * np.cos(phase), amp * np.sin(phase)], axis=-1)
    xt = cloud(rng, N_TEST)
    yt = 1e-3 * np.stack([np.exp(-0.5 * np.sum(((xt - [-10.0, 30.0]) / [1 / 3, 1.5]) ** 2,
                                               axis=-1))] * 2, axis=-1)
    return x, y, xt, yt


@pytest.fixture(scope="module", params=CORRS)
def fits(request, coherence):
    x, y, _, _ = coherence
    jp, tp = complex_params(request.param)
    jstate = JCK.fit_complex(jp, jnp.asarray(x), jnp.asarray(y), block_diag=False)
    tstate = CK.fit_complex(tp, t64(x), t64(y), block_diag=False)
    return jstate, tstate


def test_full_fit_matches(fits):
    jstate, tstate = fits
    w = np.asarray(jstate.augmented_inverse())
    w_scale = float(np.abs(w).max())
    for f in ("p_re", "p_im", "q_re", "q_im"):
        rel_close(getattr(tstate, f), getattr(jstate, f), TOL_FIT, f, scale=w_scale)
    rel_close(tstate.augmented_inverse(), w, TOL_FIT, "augmented inverse")
    rel_close(tstate.v, jstate.v, TOL_FIT, "v")
    rel_close(tstate.rescale, jstate.rescale, 1e-15, "rescale")


@pytest.mark.parametrize("with_variance", [True, False])
def test_full_fit_predictions_match(fits, coherence, with_variance):
    jstate, tstate = fits
    xt = coherence[2]
    ref = JCK.predict_complex(jstate, jnp.asarray(xt), with_variance)
    out = CK.predict_complex(tstate, t64(xt), with_variance)
    for o, r, name in zip(out, ref, ("mean", "variance", "cutoff")):
        if r is None:
            assert o is None
        else:
            rel_close(o, r, TOL_OBS, name)


def test_full_fit_losses_and_integrals_match(fits, coherence):
    jstate, tstate = fits
    _, _, xt, yt = coherence
    rel_close(CK.loocv_error_complex(tstate), JCK.loocv_error_complex(jstate), TOL_OBS, "loocv")
    rel_close(CK.extra_set_error_complex(tstate, t64(xt), t64(yt)),
              JCK.extra_set_error_complex(jstate, jnp.asarray(xt), jnp.asarray(yt)), TOL_OBS,
              "extra-set error")
    rel_close(CK.optimal_magnitude_complex(tstate), JCK.optimal_magnitude_complex(jstate),
              TOL_OBS, "optimal magnitude")
    rel_close(CK.purity_complex(tstate), JCK.purity_complex(jstate), TOL_OBS, "purity")


def test_candidate_batch_equals_single_fits(coherence):
    """The ladder's fan: parameters with a leading batch axis, one batched fit."""
    x, y, xt, yt = coherence
    singles = [complex_params(c)[1] for c in CORRS]
    batch = CK.ComplexKernelParams(*(torch.stack([torch.as_tensor(getattr(p, f))
                                                  for p in singles])
                                     for f in CK.ComplexKernelParams._fields))
    bstate = CK.fit_complex(batch, t64(x), t64(y), block_diag=False)
    loo = CK.loocv_error_complex(bstate)
    extra = CK.extra_set_error_complex(bstate, t64(xt), t64(yt))
    pur = CK.purity_complex(bstate)
    mag = CK.optimal_magnitude_complex(bstate)
    assert loo.shape == extra.shape == pur.shape == mag.shape == (len(CORRS),)
    for i, p in enumerate(singles):
        s = CK.fit_complex(p, t64(x), t64(y), block_diag=False)
        rel_close(bstate.v[i], s.v, TOL_BATCH, "v")
        rel_close(loo[i], CK.loocv_error_complex(s), TOL_BATCH, "loocv")
        rel_close(extra[i], CK.extra_set_error_complex(s, t64(xt), t64(yt)), TOL_BATCH, "extra")
        rel_close(pur[i], CK.purity_complex(s), TOL_BATCH, "purity")
        rel_close(mag[i], CK.optimal_magnitude_complex(s), TOL_BATCH, "magnitude")


@pytest.mark.parametrize("corr", [0.0, 0.6])
def test_flat_parameters_match(corr):
    jp, tp = complex_params(corr)
    flat = tp.to_flat()
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jp.to_flat()))
    back = CK.ComplexKernelParams.from_flat(flat)
    jback = JCK.ComplexKernelParams.from_flat(jp.to_flat())
    for f in CK.ComplexKernelParams._fields:
        np.testing.assert_array_equal(getattr(back, f).numpy(), np.asarray(getattr(jback, f)))


@pytest.fixture(scope="module")
def densities():
    rng = np.random.default_rng(32)
    pts = cloud(rng, 3, 40)
    rho = np.zeros((3, 40, 2))
    amp = np.exp(-0.5 * np.sum(((pts - [-10.0, 30.0]) / [1 / 3, 1.5]) ** 2, axis=-1))
    rho[0, :, 0], rho[2, :, 0] = amp[0], 1e-2 * amp[2]
    rho[1, :, 0], rho[1, :, 1] = 3e-2 * amp[1] * np.cos(pts[1, :, 1]), 3e-2 * amp[1]
    jd = JS.Density(points=jnp.asarray(pts), rho=jnp.asarray(rho),
                    active=jnp.asarray([True, True, True]))
    # the next tick's cloud: every point moved a little
    jd2 = jd._replace(points=jd.points + 1e-3 * jnp.asarray(rng.normal(size=pts.shape)))
    return jd, jd2


@pytest.mark.parametrize("warm", [False, True])
def test_full_refit_matches(densities, warm):
    jd, jd2 = densities
    vals = dict(magnitude=[1.0, 0.9], lengths=[[1 / 3, 1.5], [0.4, 1.3]], noise=[1e-2, 1e-2])
    jdp = JRK.KernelParams(**{k: jnp.asarray(v) for k, v in vals.items()})
    tdp = convert.to_torch(jdp, "cpu")
    jop, top = complex_params(1.0)
    jprev = JS.fit_gp_states(jdp, jop, jd, block_diag=False) if warm else None
    tprev = convert.to_torch(jprev, "cpu") if warm else None
    ref = JS.fit_gp_states(jdp, jop, jd2, prev=jprev, block_diag=False)
    out = TS.fit_gp_states(tdp, top, convert.to_torch(jd2, "cpu"), prev=tprev,
                           block_diag=False)
    np.testing.assert_allclose(out.diag.alpha.numpy(), np.asarray(ref.diag.alpha),
                               atol=TOL_REFIT)
    np.testing.assert_allclose(out.offdiag.v.numpy(), np.asarray(ref.offdiag.v),
                               atol=TOL_REFIT)
    rel_close(out.offdiag.augmented_inverse(), ref.offdiag.augmented_inverse(), TOL_FIT, "W")
    rel_close(out.population(), ref.population(), TOL_OBS, "population")
    rel_close(out.purity(), ref.purity(), TOL_OBS, "purity")
