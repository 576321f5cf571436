"""Complex Gaussian-process kernel for the off-diagonal density-matrix element.

Counterpart of :mod:`gple_tpu.ops.complex_kernels`.  The complex GP over
f = f_R + i f_I uses a covariance and a pseudo-covariance built from three
real RBF kernels (real, imaginary, and their correlation):

    K        = sigma^2 (K_R + K_I + sigma_n^2 I)
    K-tilde  = sigma^2 (K_R - K_I + 2 i corr K_C)

with the correlation kernel's (magnitude, lengths) derived from the real and
imaginary ones.  Complex values keep the trailing-axis-2 RI layout and every
complex matrix is an explicit (re, im) pair of float64 matrices.

The three sub-grams of a covariance always share their points, so they are
built by ONE ``gram_rbf`` launch over three length sets, and the mean-only
predict is ONE ``predict_mean_rbf`` launch (see :func:`complex_mean`).

Both fits are ported: the block-diagonal (corr = 0) path of the production
step, two (N, N) SPD inverses, and the full 2N embedding of any corr, one
(2N, 2N) SPD inverse of M = [[K + R, C], [C, K - R]].  Either fit takes
``chirp=True``: the labels are demodulated by the fringe wavevector of
:func:`estimate_chirp` (plain torch: an (N, N) distance matrix and an
argmin, no kernel), the envelope is fitted, and the predictions are
remodulated by the stored ``chirp_k``.
The optimizer's ``extra_set_error_complex`` is the fused mean
(:func:`complex_mean`), one launch for the 5N extra points.

Every function takes parameters with leading batch axes (``real_lengths
(..., D)``, the scalars ``(...)``) against shared points ``(N, D)``: the
constrained ladder evaluates its candidate fan as one batched fit (one Gram
launch, one batched Cholesky).  Unbatched operands keep the plain
matrix-vector products of the production path.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gple_tpu_torch.ops.gram_kernels import gram_rbf, predict_mean_rbf
from gple_tpu_torch.ops.kernels import RESCALE_MAXIMUM, cutoff_factor, positive_prod
from gple_tpu_torch.ops.linalg import psd_inverse, psd_inverse_warm
from gple_tpu_torch.utils import ri
from gple_tpu_torch.utils.constants import purity_factor


class ComplexKernelParams(NamedTuple):
    """(global magnitude, (m_R, l_R), (m_I, l_I), noise, corr); ``corr`` is the
    real-imaginary correlation strength in [-1, 1] (1 = the reference kernel)."""

    magnitude: torch.Tensor
    real_magnitude: torch.Tensor
    real_lengths: torch.Tensor   # (..., PhaseDim)
    imag_magnitude: torch.Tensor
    imag_lengths: torch.Tensor   # (..., PhaseDim)
    noise: torch.Tensor
    corr: torch.Tensor = 1.0

    def to_flat(self) -> torch.Tensor:
        """(magnitude, m_R, l_R, m_I, l_I, noise, corr) along the last axis."""
        ref = self.real_lengths
        batch = ref.shape[:-1]

        def one(v):
            v = torch.as_tensor(v, dtype=ref.dtype, device=ref.device)
            return v.expand(batch)[..., None]

        return torch.cat([one(self.magnitude), one(self.real_magnitude), ref,
                          one(self.imag_magnitude), self.imag_lengths, one(self.noise),
                          one(self.corr)], dim=-1)

    @classmethod
    def from_flat(cls, flat: torch.Tensor) -> "ComplexKernelParams":
        d = (flat.shape[-1] - 5) // 2
        return cls(magnitude=flat[..., 0], real_magnitude=flat[..., 1],
                   real_lengths=flat[..., 2: 2 + d], imag_magnitude=flat[..., 2 + d],
                   imag_lengths=flat[..., 3 + d: 3 + 2 * d], noise=flat[..., -2],
                   corr=flat[..., -1])


def _sc(v):
    """A per-batch scalar (...) broadcast against (..., N, M) matrices."""
    return v[..., None, None] if isinstance(v, torch.Tensor) else v


def _sv(v):
    """A per-batch scalar (...) broadcast against (..., N) vectors."""
    return v[..., None] if isinstance(v, torch.Tensor) else v


def _mv(m, v):
    """(..., N, M) @ (..., M) -> (..., N); a plain matrix-vector product when
    both are unbatched."""
    if m.dim() == 2 and v.dim() == 1:
        return m @ v
    return (m @ v[..., None])[..., 0]


def _dot(u, w):
    """sum(u * w) over the last axis; a plain dot product when unbatched."""
    if u.dim() == 1 and w.dim() == 1:
        return u @ w
    return torch.sum(u * w, dim=-1)


def _matvec(m_re, m_im, v):
    """(complex matrix as two real parts) @ (RI vector), batched."""
    vr, vi = v[..., 0], v[..., 1]
    return torch.stack([_mv(m_re, vr) - _mv(m_im, vi), _mv(m_re, vi) + _mv(m_im, vr)], dim=-1)


def _rmatvec(m_re, v):
    """(real matrix) @ (RI vector), batched."""
    return torch.stack([_mv(m_re, v[..., 0]), _mv(m_re, v[..., 1])], dim=-1)


def correlation_params(p: ComplexKernelParams):
    """Derived correlation-kernel (magnitude, lengths)."""
    lr2, li2 = p.real_lengths**2, p.imag_lengths**2
    sum_sq = lr2 + li2
    corr_mag = torch.sqrt(
        p.real_magnitude
        * p.imag_magnitude
        * positive_prod(2.0 * p.real_lengths * p.imag_lengths / sum_sq)
    )
    corr_len = torch.sqrt(sum_sq / 2.0)
    return corr_mag, corr_len


def sub_gram_lengths(p: ComplexKernelParams):
    """(..., 3, PhaseDim) lengths of the real, imaginary and correlation sub-grams."""
    _, cl = correlation_params(p)
    return torch.stack([p.real_lengths, p.imag_lengths, cl], dim=-2)


def covariance_from_grams(p: ComplexKernelParams, g_r, g_i, g_c, same: bool):
    """(K, Kt_re, Kt_im) from the three unit sub-grams (..., Na, Nb)."""
    cm, _ = correlation_params(p)
    kr = _sc(p.real_magnitude**2) * g_r
    ki = _sc(p.imag_magnitude**2) * g_i
    kc = _sc(cm**2) * g_c
    noise = _sc(p.noise**2) * torch.eye(g_r.shape[-1], dtype=g_r.dtype, device=g_r.device) \
        if same else 0.0
    mag2 = _sc(p.magnitude**2)
    k = mag2 * (kr + ki + noise)
    kt_re = mag2 * (kr - ki)
    kt_im = mag2 * 2.0 * _sc(p.corr) * kc
    return k, kt_re, kt_im


def covariance_matrices(p: ComplexKernelParams, xa, xb, same: bool):
    """(K, Kt_re, Kt_im): covariance (real) and pseudo-covariance parts."""
    g = gram_rbf(sub_gram_lengths(p), xa[..., None, :, :], xb[..., None, :, :])
    return covariance_from_grams(p, g[..., 0, :, :], g[..., 1, :, :], g[..., 2, :, :], same)


def augmented_matrix(k, kt_re, kt_im):
    """The real SPD embedding M = [[K + R, C], [C, K - R]] (..., 2N, 2N) of the
    augmented system [[K, Kt], [Kt*, K]], Kt = R + iC."""
    return torch.cat([torch.cat([k + kt_re, kt_im], dim=-1),
                      torch.cat([kt_im, k - kt_re], dim=-1)], dim=-2)


class ComplexTrainState(NamedTuple):
    params: ComplexKernelParams
    features: torch.Tensor   # (N, PhaseDim)
    labels: torch.Tensor     # (N, 2) RI, rescaled
    rescale: torch.Tensor
    p_re: torch.Tensor       # (N, N) Re of upper-left augmented inverse
    p_im: torch.Tensor       # (N, N) Im (antisymmetric: P Hermitian)
    q_re: torch.Tensor       # (N, N) Re of lower-left augmented inverse
    q_im: torch.Tensor
    v: torch.Tensor          # (N, 2) RI upper augmented solve
    chirp_k: torch.Tensor    # (PhaseDim,) fringe wavevector (zeros: no chirp)

    def diag_blocks(self):
        """(W11, W22) of the SPD embedding -- the warm starts for the
        ``block_diag`` fit path (corr = 0)."""
        return self.p_re + self.q_re, self.p_re - self.q_re

    def augmented_inverse(self):
        """W = M^-1 of the real SPD embedding, rebuilt from the stored P/Q
        blocks -- the warm start of the full 2N refit."""
        w11 = self.p_re + self.q_re
        w22 = self.p_re - self.q_re
        w21 = self.p_im - self.q_im
        w12 = -(self.p_im + self.q_im)
        return torch.cat([torch.cat([w11, w12], dim=-1), torch.cat([w21, w22], dim=-1)],
                         dim=-2)


def estimate_chirp(features, labels_ri):
    """|label|-weighted least-squares estimate of the local fringe
    wavevector k of an (N, 2) RI field on (N, D) features, without phase
    unwrapping (``gple_tpu/ops/complex_kernels.py:166-205``): for
    y = A e^{i k.r}, angle(y_i conj(y_j)) = k . (r_i - r_j) for each point's
    nearest neighbour j in the std-normalized metric, solved as a D x D
    weighted least squares, three passes each measuring the residual
    increment after demodulating the current estimate.  All-zero labels give
    k = 0 through the ridge term."""
    r = features
    amp = ri.absval(labels_ri)
    scale = torch.std(r, dim=0, correction=0) + 1e-30
    z = r / scale
    d2 = torch.sum((z[:, None, :] - z[None, :, :]) ** 2, dim=-1)
    eye = torch.eye(r.shape[0], dtype=r.dtype, device=r.device)
    j = torch.argmin(d2 + eye * 1e30, dim=1)
    dr = r - r[j]
    w = amp * amp[j]
    a = torch.einsum("n,ni,nj->ij", w, dr, dr) + 1e-12 * torch.eye(
        r.shape[-1], dtype=r.dtype, device=r.device)
    k = torch.zeros(r.shape[-1], dtype=r.dtype, device=r.device)
    for _ in range(3):
        y = ri.phase_mul(labels_ri, -(r @ k))
        yj = y[j]
        re = y[..., 0] * yj[..., 0] + y[..., 1] * yj[..., 1]
        im = y[..., 1] * yj[..., 0] - y[..., 0] * yj[..., 1]
        b = torch.einsum("n,ni,n->i", w, dr, torch.atan2(im, re))
        k = k + torch.linalg.solve(a, b)
    return k


def fit_complex(params: ComplexKernelParams, features, labels,
                chirp: bool = False, w_warm=None,
                block_diag: bool = False) -> ComplexTrainState:
    """Factorize the augmented training system.  ``block_diag`` (the caller
    guarantees corr = 0): M = blockdiag(K + R, K - R), two (N, N) SPD
    inverses, ``w_warm`` the (W11, W22) pair of
    :meth:`ComplexTrainState.diag_blocks`.  Otherwise the full (2N, 2N)
    embedding :func:`augmented_matrix`, ``w_warm`` the
    :meth:`ComplexTrainState.augmented_inverse` of a previous fit.  The
    direct inverse needs no warm start and ignores it."""
    k64, kt_re64, kt_im64 = covariance_matrices(params, features, features, same=True)
    if not block_diag:
        m = augmented_matrix(k64, kt_re64, kt_im64)
        w = psd_inverse(m) if w_warm is None else psd_inverse_warm(m, w_warm)
        return finish_complex_fit_full(params, features, labels, k64, kt_re64, kt_im64, w,
                                       chirp=chirp)
    b = torch.stack([k64 + kt_re64, k64 - kt_re64])
    w = psd_inverse(b) if w_warm is None else psd_inverse_warm(b, torch.stack(w_warm))
    return finish_complex_fit(params, features, labels, k64, kt_re64, kt_im64,
                              w[0], w[1], chirp=chirp)


def _rescaled_labels(features, labels, chirp: bool):
    """(rescale (...), rescaled labels, chirp_k (D,)): max |label| -> 10;
    with ``chirp`` (unbatched) the labels demodulated by
    :func:`estimate_chirp` of the rescaled labels, else chirp_k = 0."""
    rescale = RESCALE_MAXIMUM / torch.clamp(torch.amax(ri.absval(labels), dim=-1), min=1e-30)
    y = labels * _sc(rescale)
    if not chirp:
        return rescale, y, torch.zeros(features.shape[-1], dtype=features.dtype,
                                       device=features.device)
    chirp_k = estimate_chirp(features, y)
    return rescale, ri.phase_mul(y, -(features @ chirp_k)), chirp_k


def finish_complex_fit(params: ComplexKernelParams, features, labels,
                       k64, kt_re64, kt_im64, w11, w22,
                       chirp: bool = False) -> ComplexTrainState:
    """Block-diagonal (corr = 0) state assembly after the two SPD inverses:
    P/Q from the W blocks, then the refined augmented solve."""
    rescale, y, chirp_k = _rescaled_labels(features, labels, chirp)
    p_re = 0.5 * (w11 + w22)
    q_re = 0.5 * (w11 - w22)
    p_im = torch.zeros_like(p_re)
    q_im = torch.zeros_like(q_re)
    return _assemble_complex_state(params, features, y, rescale, chirp_k,
                                   k64, kt_re64, kt_im64, p_re, p_im, q_re, q_im)


def finish_complex_fit_full(params: ComplexKernelParams, features, labels,
                            k64, kt_re64, kt_im64, w, chirp: bool = False) -> ComplexTrainState:
    """Full-embedding state assembly after the (2N, 2N) SPD inverse W = M^-1:

        P = [(W11 + W22) + i (W21 - W12)] / 2
        Q = [(W11 - W22) - i (W21 + W12)] / 2

    then the refined augmented solve."""
    rescale, y, chirp_k = _rescaled_labels(features, labels, chirp)
    n = features.shape[-2]
    w11, w12 = w[..., :n, :n], w[..., :n, n:]
    w21, w22 = w[..., n:, :n], w[..., n:, n:]
    p_re = 0.5 * (w11 + w22)
    p_im = 0.5 * (w21 - w12)
    q_re = 0.5 * (w11 - w22)
    q_im = -0.5 * (w21 + w12)
    return _assemble_complex_state(params, features, y, rescale, chirp_k,
                                   k64, kt_re64, kt_im64, p_re, p_im, q_re, q_im)


def _assemble_complex_state(params, features, y, rescale, chirp_k,
                            k64, kt_re64, kt_im64,
                            p_re, p_im, q_re, q_im) -> ComplexTrainState:
    # enforce the exact symmetries (P Hermitian, Q complex symmetric)
    p_re = 0.5 * (p_re + p_re.transpose(-1, -2))
    p_im = 0.5 * (p_im - p_im.transpose(-1, -2))
    q_re = 0.5 * (q_re + q_re.transpose(-1, -2))
    q_im = 0.5 * (q_im + q_im.transpose(-1, -2))

    # v = P y + conj(Q y), refined against the augmented system
    # [[K, Kt], [Kt*, K*]] [v; v*] = [y; y*]
    def apply_augmented_inverse(w):
        return _matvec(p_re, p_im, w) + ri.conj(_matvec(q_re, q_im, w))

    def apply_augmented(vv):
        return _rmatvec(k64, vv) + _matvec(kt_re64, kt_im64, ri.conj(vv))

    v = apply_augmented_inverse(y)
    for _ in range(4):
        v = v + apply_augmented_inverse(y - apply_augmented(v))
    return ComplexTrainState(params=params, features=features, labels=y, rescale=rescale,
                             p_re=p_re, p_im=p_im, q_re=q_re, q_im=q_im, v=v,
                             chirp_k=chirp_k)


def loocv_error_complex(state: ComplexTrainState):
    """Complex leave-one-out CV error (complex_kernel.cpp:270-286), (...)."""
    pd = torch.diagonal(state.p_re, dim1=-2, dim2=-1)   # P Hermitian: diagonal real
    qd = torch.stack([torch.diagonal(state.q_re, dim1=-2, dim2=-1),
                      torch.diagonal(state.q_im, dim1=-2, dim2=-1)], dim=-1)
    denom = pd**2 - ri.abs2(qd)
    num = ri.scale(state.v, pd) - ri.conj(ri.mul(qd, state.v))
    return torch.sum(ri.abs2(num) / denom**2, dim=-1)


def optimal_magnitude_complex(state: ComplexTrainState):
    """sqrt(Re(y^H v) / N) (complex_kernel.h:190-204), (...)."""
    within = ri.vdot_re(state.labels, state.v) / state.labels.shape[-2]
    return torch.sqrt(torch.abs(within))


def extra_set_error_complex(state: ComplexTrainState, test_features, test_labels):
    """Squared prediction error on a held-out RI set (complex_kernel.cpp:645-646),
    through the fused mean, (...)."""
    mean = complex_mean(state.params, test_features, state.features, state.v)
    return torch.sum(ri.abs2(mean - test_labels * _sc(state.rescale)), dim=-1)


def _mean_ri(k_star, kt_re, kt_im, v):
    """K_* v + Kt_* conj(v): K_* real, Kt_* = (kt_re, kt_im)."""
    return _rmatvec(k_star, v) + _matvec(kt_re, kt_im, ri.conj(v))


def complex_mean(p: ComplexKernelParams, test_features, features, v):
    """:func:`_mean_ri` of the test cross-covariances, fused: with v = a + ib,

        Re = 2 s^2 m_R^2 G_R a + 2 s^2 corr c_m^2 G_C b
        Im = 2 s^2 m_I^2 G_I b + 2 s^2 corr c_m^2 G_C a

    as ONE ``predict_mean_rbf`` launch over the three length sets with two
    right-hand sides each ([a, 0], [0, b], [b, a]); the cross-grams are never
    materialised.  Returns (M, 2) RI."""
    cm, _ = correlation_params(p)
    a, b = v[..., 0], v[..., 1]
    zero = torch.zeros_like(a)
    rhs = torch.stack([torch.stack([a, zero], -1), torch.stack([zero, b], -1),
                       torch.stack([b, a], -1)], dim=-3)             # (..., 3, N, 2)
    s = predict_mean_rbf(sub_gram_lengths(p), test_features[..., None, :, :],
                         features[..., None, :, :], rhs)             # (..., 3, M, 2)
    two_s2 = 2.0 * p.magnitude**2
    coupling = _sv(two_s2 * p.corr * cm**2)
    re = _sv(two_s2 * p.real_magnitude**2) * s[..., 0, :, 0] + coupling * s[..., 2, :, 0]
    im = _sv(two_s2 * p.imag_magnitude**2) * s[..., 1, :, 1] + coupling * s[..., 2, :, 1]
    return torch.stack([re, im], dim=-1)


def predict_complex(state: ComplexTrainState, test_features, with_variance: bool = True):
    """Mean, variance, cutoff prediction at test points.

    Returns RI means: ``(mean_raw (M, 2), var (M,), cutoff_raw (M, 2))``;
    ``with_variance=False`` runs the fused mean and returns ``None`` for the
    variance."""
    p = state.params
    rescale = _sc(state.rescale)
    if not with_variance:
        mean = complex_mean(p, test_features, state.features, state.v)
        mean = ri.phase_mul(mean, test_features @ state.chirp_k)
        return mean / rescale, None, mean / rescale
    k_star, kt_re, kt_im = covariance_matrices(p, test_features, state.features, same=False)
    mean = _mean_ri(k_star, kt_re, kt_im, state.v)
    # re-modulate the envelope prediction to the lab frame (no-op at chirp_k = 0)
    mean = ri.phase_mul(mean, test_features @ state.chirp_k)
    # self-covariance k(x, x) = sigma^2 (m_R^2 + m_I^2 + noise^2)
    self_k = _sv(p.magnitude**2 * (p.real_magnitude**2 + p.imag_magnitude**2 + p.noise**2))
    pr, pi = state.p_re, state.p_im
    qr, qi = state.q_re, state.q_im
    # Re(K_* P K_*^H): K_* real
    t1 = torch.sum((k_star @ pr) * k_star, dim=-1)
    # Re(Kt_* conj(P) Kt_*^H)
    w_re, w_im = ri.matmul(kt_re, kt_im, pr, -pi)
    t2 = torch.sum(w_re * kt_re + w_im * kt_im, dim=-1)
    # Re(Kt_* Q K_*^T)
    w_re, _ = ri.matmul(kt_re, kt_im, qr, qi)
    t3 = torch.sum(w_re * k_star, dim=-1)
    # Re(K_* conj(Q) conj(Kt_*)^T)
    u_re, u_im = k_star @ qr, -(k_star @ qi)
    t4 = torch.sum(u_re * kt_re + u_im * kt_im, dim=-1)
    var = self_k - t1 - t2 - t3 - t4
    cut = cutoff_factor(ri.absval(mean), var)
    return mean / rescale, var, ri.scale(mean, cut) / rescale


# -- purity via five auxiliary kernels ------------------------------------------------

def _aux_self(mag, lengths):
    """Auxiliary params of one kernel: (mag^2 sqrt(prod l), sqrt(2) l), batched."""
    return mag**2 * torch.sqrt(positive_prod(lengths)), math.sqrt(2.0) * lengths


def _aux_mixed(mag_a, len_a, mag_b, len_b):
    """Mixed auxiliary params of two kernels."""
    mag = mag_a * mag_b / torch.sqrt(
        torch.sqrt(positive_prod(0.5 * (1.0 / len_a**2 + 1.0 / len_b**2)))
    )
    return mag, torch.sqrt(len_a**2 + len_b**2)


def purity_complex(state: ComplexTrainState):
    """(2 pi hbar)^Dim * 2 pi^Dim sigma^4 [Re(v^H K1 v) + Re(v^T K2 v)] / rescale^2
    with K1 = K_R' + K_I' + 2 corr^2 K_C', K2 = K_R' - K_I' - 2i corr (K_RC + K_IC);
    the five auxiliary grams come from one ``gram_rbf`` launch."""
    p = state.params
    x = state.features
    d = x.shape[-1] // 2
    cm, cl = correlation_params(p)
    aux = [
        _aux_self(p.real_magnitude, p.real_lengths),
        _aux_self(p.imag_magnitude, p.imag_lengths),
        _aux_self(cm, cl),
        _aux_mixed(p.real_magnitude, p.real_lengths, cm, cl),
        _aux_mixed(p.imag_magnitude, p.imag_lengths, cm, cl),
    ]
    g = gram_rbf(torch.stack([lengths for _, lengths in aux], dim=-2), x[..., None, :, :],
                 x[..., None, :, :])
    krp, kip, kcp, krc, kic = (_sc(mag**2) * g[..., i, :, :] for i, (mag, _) in enumerate(aux))
    k1 = krp + kip + 2.0 * _sc(p.corr**2) * kcp
    k2_re = krp - kip
    k2_im = -2.0 * _sc(p.corr) * (krc + kic)
    a, b = state.v[..., 0], state.v[..., 1]
    # Re(v^H K1 v), K1 real symmetric
    quad1 = _dot(a, _mv(k1, a)) + _dot(b, _mv(k1, b))
    # Re(v^T K2 v) = a^T C a - b^T C b - 2 a^T D b  (C = k2_re, D = k2_im sym)
    quad2 = _dot(a, _mv(k2_re, a)) - _dot(b, _mv(k2_re, b)) - 2.0 * _dot(a, _mv(k2_im, b))
    factor = purity_factor(d) * 2.0 * math.pi**d * p.magnitude**4
    return factor * (quad1 + quad2) / state.rescale**2
