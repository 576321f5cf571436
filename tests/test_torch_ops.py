"""PyTorch port against ``gple_tpu``: the kernels' plain versions, linalg, RI.

Inputs come from ``numpy.random.default_rng`` and go to both packages; the
JAX side runs as its own tests run it (CPU, x64, Pallas in interpret mode).
The kernel wrappers' dispatch and the CUDA kernels themselves are tested in
``tests/test_torch_kernels.py``, which needs no JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gple_tpu.ops import complex_kernels as JCK
from gple_tpu.ops import kernels as JRK
from gple_tpu.ops import linalg as JLA
from gple_tpu.ops.pallas_gram import gram_pallas, predict_mean_pallas
from gple_tpu.utils import ri as jri
from gple_tpu_torch.ops import complex_kernels as CK
from gple_tpu_torch.ops import gram_kernels as GK
from gple_tpu_torch.ops import linalg as LA
from gple_tpu_torch.utils import ri
from test_torch_kernels import _warm_torch_exp, cloud, t64  # noqa: F401 (fixture)

@pytest.fixture(scope="module")
def pallas_data():
    """The ragged sizes of tests/test_pallas.py: 200 train, 300 test points."""
    rng = np.random.default_rng(0)
    return (rng.normal(size=(200, 2)), rng.normal(size=(300, 2)), np.array([0.8, 1.7]),
            rng.normal(size=200))


# -- plain versions against the Pallas kernels (float32, interpret mode) -----------

def test_gram_plain_matches_gram_pallas_f32(pallas_data):
    x_train, x_test, lengths, _ = pallas_data
    ref = np.asarray(gram_pallas(jnp.asarray(lengths), jnp.asarray(x_test),
                                 jnp.asarray(x_train), interpret=True))
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    out = GK.gram_plain(f32(lengths), f32(x_test), f32(x_train)).numpy()
    assert out.shape == ref.shape == (300, 200)
    # f32: the Pallas expansion form |a|^2 + |b|^2 - 2ab vs the difference form
    np.testing.assert_allclose(out, ref, atol=5e-6, rtol=2e-5)


def test_predict_mean_plain_matches_predict_mean_pallas_f32(pallas_data):
    x_train, x_test, lengths, alpha = pallas_data
    mag = 1.3
    ref = np.asarray(predict_mean_pallas(jnp.asarray(lengths), jnp.asarray(mag),
                                         jnp.asarray(x_test), jnp.asarray(x_train),
                                         jnp.asarray(alpha), interpret=True))
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    out = mag**2 * GK.predict_mean_plain(f32(lengths), f32(x_test), f32(x_train),
                                         f32(alpha)[:, None])[:, 0].numpy()
    np.testing.assert_allclose(out, ref, atol=5e-6 * np.abs(ref).max(), rtol=2e-5)


# -- plain versions against the JAX f64 gram -----------------------------------------

@pytest.mark.parametrize("kind", ["vector", "matrix"])
def test_gram_matches_jax_gram_f64_batched(kind):
    from gple_tpu_torch.ops import kernels as RK

    rng = np.random.default_rng(1)
    xa, xb = cloud(rng, 3, 37), cloud(rng, 3, 29)
    if kind == "vector":
        lengths = np.array([1 / 3, 1.5]) * rng.uniform(0.5, 2.0, size=(3, 2))
    else:
        lengths = np.tril(rng.normal(size=(3, 2, 2))) + 2.0 * np.eye(2)
    ref = np.asarray(jax.vmap(JRK.gram)(jnp.asarray(lengths), jnp.asarray(xa),
                                        jnp.asarray(xb)))
    out = RK.gram(t64(lengths), t64(xa), t64(xb)).numpy()
    assert out.shape == (3, 37, 29)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-13)


def test_predict_mean_matches_jax_kernel_matmul_f64():
    rng = np.random.default_rng(2)
    lengths = np.array([[0.4, 1.2], [0.3, 2.0]])
    xt, xtr = cloud(rng, 2, 50), cloud(rng, 2, 40)
    alpha = rng.normal(size=(2, 40, 2))
    ref = np.stack([np.asarray(JRK.gram(jnp.asarray(lengths[b]), jnp.asarray(xt[b]),
                                        jnp.asarray(xtr[b])) @ alpha[b]) for b in range(2)])
    out = GK.predict_mean_rbf(t64(lengths), t64(xt), t64(xtr), t64(alpha)).numpy()
    # f64: only the summation order differs
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-13 * np.abs(ref).max())


@pytest.mark.parametrize("corr", [0.0, 0.7])
def test_complex_mean_matches_mean_ri(corr):
    rng = np.random.default_rng(3)
    xt, xtr = cloud(rng, 60), cloud(rng, 45)
    v = rng.normal(size=(45, 2))
    vals = dict(magnitude=1.2, real_magnitude=0.9, real_lengths=[0.35, 1.4],
                imag_magnitude=1.1, imag_lengths=[0.3, 1.8], noise=1e-2, corr=corr)
    jp = JCK.ComplexKernelParams(**{k: jnp.asarray(x) for k, x in vals.items()})
    tp = CK.ComplexKernelParams(**{k: t64(x) for k, x in vals.items()})
    k_star, kt_re, kt_im = JCK.covariance_matrices(jp, jnp.asarray(xt), jnp.asarray(xtr),
                                                   same=False)
    ref = np.asarray(JCK._mean_ri(k_star, kt_re, kt_im, jnp.asarray(v)))
    out = CK.complex_mean(tp, t64(xt), t64(xtr), t64(v)).numpy()
    # the fused identity regroups the sums: f64 rounding only
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-13 * np.abs(ref).max())


# -- linalg interface ----------------------------------------------------------------------

def _spd(rng, batch, n):
    x = cloud(rng, batch, n)
    g = np.asarray(jax.vmap(JRK.gram)(jnp.asarray([[0.4, 1.6]] * batch), jnp.asarray(x),
                                      jnp.asarray(x)))
    return g + 1e-4 * np.eye(n)


@pytest.mark.parametrize("fn", ["psd_inverse", "psd_inverse_batched", "psd_inverse_warm",
                                "psd_inverse_warm_batched"])
def test_psd_inverses_match_jax(fn):
    rng = np.random.default_rng(6)
    ks = _spd(rng, 3, 30)
    k = ks if fn.endswith("batched") else ks[0]
    args = (k, np.zeros_like(k)) if "warm" in fn else (k,)
    ref = np.asarray(getattr(JLA, fn)(*map(jnp.asarray, args)))
    out = getattr(LA, fn)(*map(t64, args)).numpy()
    np.testing.assert_array_equal(out, np.swapaxes(out, -1, -2))
    # cond(K) ~ 1e5-1e6: two LAPACK inverses agree to ~eps * cond relative
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-9 * np.abs(ref).max())


def test_refine_solve_matches_jax():
    rng = np.random.default_rng(7)
    ks = _spd(rng, 2, 25)
    y = rng.normal(size=(2, 25))
    kinv = np.linalg.inv(ks) * (1 + 1e-6)
    ref = np.stack([np.asarray(JLA.refine_solve(jnp.asarray(kinv[b]), jnp.asarray(ks[b]),
                                                jnp.asarray(y[b]), iters=3))
                    for b in range(2)])
    out = LA.refine_solve(t64(kinv), t64(ks), t64(y), iters=3).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-9, atol=1e-12)


# -- RI helpers --------------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["conj", "mul", "abs2", "absval", "phase_mul", "matvec",
                                  "rmatvec", "vdot_re", "scale"])
def test_ri_helpers_match_jax(name):
    rng = np.random.default_rng(8)
    a, b = rng.normal(size=(6, 2)), rng.normal(size=(6, 2))
    m_re, m_im = rng.normal(size=(6, 6)), rng.normal(size=(6, 6))
    theta, s = rng.normal(size=6), rng.normal(size=6)
    args = {"conj": (a,), "mul": (a, b), "abs2": (a,), "absval": (a,),
            "phase_mul": (a, theta), "matvec": (m_re, m_im, a), "rmatvec": (m_re, a),
            "vdot_re": (a, b), "scale": (a, s)}[name]
    ref = np.asarray(getattr(jri, name)(*map(jnp.asarray, args)))
    out = getattr(ri, name)(*map(t64, args)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-15, atol=1e-15)


def test_ri_complex_round_trip():
    z = torch.tensor([1.0 + 2.0j, -0.5j], dtype=torch.complex128)
    packed = ri.from_complex(z)
    np.testing.assert_array_equal(packed.numpy(), [[1.0, 2.0], [0.0, -0.5]])
    assert torch.equal(ri.to_complex(packed), z)
    np.testing.assert_array_equal(ri.ri(t64([1.0, 2.0])).numpy(), [[1.0, 0.0], [2.0, 0.0]])
