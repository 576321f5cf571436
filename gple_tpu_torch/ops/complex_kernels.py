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

Ported so far: the block-diagonal (corr = 0) fit that the production step
uses.  The full 2N embedding of ``fit_complex`` and the chirp estimate
(``estimate_chirp``) are not: ``block_diag=False`` and ``chirp=True`` raise
``NotImplementedError``.  The optimizer's ``extra_set_error_complex`` is the
fused mean (:func:`complex_mean`), one launch for the 5N extra points.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gple_tpu_torch.ops.gram_kernels import gram_rbf, predict_mean_rbf
from gple_tpu_torch.ops.kernels import RESCALE_MAXIMUM, cutoff_factor
from gple_tpu_torch.ops.linalg import psd_inverse, psd_inverse_warm
from gple_tpu_torch.utils import ri
from gple_tpu_torch.utils.constants import purity_factor


class ComplexKernelParams(NamedTuple):
    """(global magnitude, (m_R, l_R), (m_I, l_I), noise, corr); ``corr`` is the
    real-imaginary correlation strength in [-1, 1] (1 = the reference kernel)."""

    magnitude: torch.Tensor
    real_magnitude: torch.Tensor
    real_lengths: torch.Tensor   # (PhaseDim,)
    imag_magnitude: torch.Tensor
    imag_lengths: torch.Tensor   # (PhaseDim,)
    noise: torch.Tensor
    corr: torch.Tensor = 1.0


def correlation_params(p: ComplexKernelParams):
    """Derived correlation-kernel (magnitude, lengths)."""
    lr2, li2 = p.real_lengths**2, p.imag_lengths**2
    sum_sq = lr2 + li2
    corr_mag = torch.sqrt(
        p.real_magnitude
        * p.imag_magnitude
        * torch.prod(2.0 * p.real_lengths * p.imag_lengths / sum_sq, dim=-1)
    )
    corr_len = torch.sqrt(sum_sq / 2.0)
    return corr_mag, corr_len


def sub_gram_lengths(p: ComplexKernelParams):
    """(3, PhaseDim) lengths of the real, imaginary and correlation sub-grams."""
    _, cl = correlation_params(p)
    return torch.stack([p.real_lengths, p.imag_lengths, cl])


def covariance_from_grams(p: ComplexKernelParams, g_r, g_i, g_c, same: bool):
    """(K, Kt_re, Kt_im) from the three unit sub-grams."""
    cm, _ = correlation_params(p)
    kr = p.real_magnitude**2 * g_r
    ki = p.imag_magnitude**2 * g_i
    kc = cm**2 * g_c
    noise = p.noise**2 * torch.eye(g_r.shape[-1], dtype=g_r.dtype, device=g_r.device) \
        if same else 0.0
    k = p.magnitude**2 * (kr + ki + noise)
    kt_re = p.magnitude**2 * (kr - ki)
    kt_im = p.magnitude**2 * 2.0 * p.corr * kc
    return k, kt_re, kt_im


def covariance_matrices(p: ComplexKernelParams, xa, xb, same: bool):
    """(K, Kt_re, Kt_im): covariance (real) and pseudo-covariance parts."""
    g = gram_rbf(sub_gram_lengths(p), xa, xb)
    return covariance_from_grams(p, g[0], g[1], g[2], same)


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


def fit_complex(params: ComplexKernelParams, features, labels,
                chirp: bool = False, w_warm=None,
                block_diag: bool = False) -> ComplexTrainState:
    """Factorize the augmented training system, block-diagonal path only
    (caller guarantees corr = 0): M = blockdiag(K + R, K - R), two (N, N)
    SPD inverses."""
    if not block_diag:
        raise NotImplementedError("fit_complex: only the block_diag (corr = 0) path "
                                  "is ported; the full 2N embedding is not")
    k64, kt_re64, kt_im64 = covariance_matrices(params, features, features, same=True)
    b = torch.stack([k64 + kt_re64, k64 - kt_re64])
    w = psd_inverse(b) if w_warm is None else psd_inverse_warm(b, torch.stack(w_warm))
    return finish_complex_fit(params, features, labels, k64, kt_re64, kt_im64,
                              w[0], w[1], chirp=chirp)


def finish_complex_fit(params: ComplexKernelParams, features, labels,
                       k64, kt_re64, kt_im64, w11, w22,
                       chirp: bool = False) -> ComplexTrainState:
    """Block-diagonal (corr = 0) state assembly after the two SPD inverses:
    P/Q from the W blocks, then the refined augmented solve."""
    if chirp:
        raise NotImplementedError("finish_complex_fit: chirp=True (estimate_chirp) "
                                  "is not ported")
    rescale = RESCALE_MAXIMUM / torch.clamp(torch.amax(ri.absval(labels)), min=1e-30)
    y = labels * rescale
    chirp_k = torch.zeros(features.shape[-1], dtype=features.dtype, device=features.device)
    p_re = 0.5 * (w11 + w22)
    q_re = 0.5 * (w11 - w22)
    p_im = torch.zeros_like(p_re)
    q_im = torch.zeros_like(q_re)
    return _assemble_complex_state(params, features, y, rescale, chirp_k,
                                   k64, kt_re64, kt_im64, p_re, p_im, q_re, q_im)


def _assemble_complex_state(params, features, y, rescale, chirp_k,
                            k64, kt_re64, kt_im64,
                            p_re, p_im, q_re, q_im) -> ComplexTrainState:
    # enforce the exact symmetries (P Hermitian, Q complex symmetric)
    p_re = 0.5 * (p_re + p_re.T)
    p_im = 0.5 * (p_im - p_im.T)
    q_re = 0.5 * (q_re + q_re.T)
    q_im = 0.5 * (q_im + q_im.T)

    # v = P y + conj(Q y), refined against the augmented system
    # [[K, Kt], [Kt*, K*]] [v; v*] = [y; y*]
    def apply_augmented_inverse(w):
        return ri.matvec(p_re, p_im, w) + ri.conj(ri.matvec(q_re, q_im, w))

    def apply_augmented(vv):
        return ri.rmatvec(k64, vv) + ri.matvec(kt_re64, kt_im64, ri.conj(vv))

    v = apply_augmented_inverse(y)
    for _ in range(4):
        v = v + apply_augmented_inverse(y - apply_augmented(v))
    return ComplexTrainState(params=params, features=features, labels=y, rescale=rescale,
                             p_re=p_re, p_im=p_im, q_re=q_re, q_im=q_im, v=v,
                             chirp_k=chirp_k)


def loocv_error_complex(state: ComplexTrainState):
    """Complex leave-one-out CV error (complex_kernel.cpp:270-286)."""
    pd = torch.diagonal(state.p_re)          # P Hermitian: diagonal real
    qd = torch.stack([torch.diagonal(state.q_re), torch.diagonal(state.q_im)], dim=-1)
    denom = pd**2 - ri.abs2(qd)
    num = ri.scale(state.v, pd) - ri.conj(ri.mul(qd, state.v))
    return torch.sum(ri.abs2(num) / denom**2)


def optimal_magnitude_complex(state: ComplexTrainState):
    """sqrt(Re(y^H v) / N) (complex_kernel.h:190-204)."""
    within = ri.vdot_re(state.labels, state.v) / state.labels.shape[0]
    return torch.sqrt(torch.abs(within))


def extra_set_error_complex(state: ComplexTrainState, test_features, test_labels):
    """Squared prediction error on a held-out RI set (complex_kernel.cpp:645-646),
    through the fused mean."""
    mean = complex_mean(state.params, test_features, state.features, state.v)
    return torch.sum(ri.abs2(mean - test_labels * state.rescale))


def _mean_ri(k_star, kt_re, kt_im, v):
    """K_* v + Kt_* conj(v): K_* real, Kt_* = (kt_re, kt_im)."""
    return ri.rmatvec(k_star, v) + ri.matvec(kt_re, kt_im, ri.conj(v))


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
                       torch.stack([b, a], -1)])                     # (3, N, 2)
    s = predict_mean_rbf(sub_gram_lengths(p), test_features, features, rhs)  # (3, M, 2)
    two_s2 = 2.0 * p.magnitude**2
    coupling = two_s2 * p.corr * cm**2
    re = two_s2 * p.real_magnitude**2 * s[0, :, 0] + coupling * s[2, :, 0]
    im = two_s2 * p.imag_magnitude**2 * s[1, :, 1] + coupling * s[2, :, 1]
    return torch.stack([re, im], dim=-1)


def predict_complex(state: ComplexTrainState, test_features, with_variance: bool = True):
    """Mean, variance, cutoff prediction at test points.

    Returns RI means: ``(mean_raw (M, 2), var (M,), cutoff_raw (M, 2))``;
    ``with_variance=False`` runs the fused mean and returns ``None`` for the
    variance."""
    p = state.params
    if not with_variance:
        mean = complex_mean(p, test_features, state.features, state.v)
        mean = ri.phase_mul(mean, test_features @ state.chirp_k)
        return mean / state.rescale, None, mean / state.rescale
    k_star, kt_re, kt_im = covariance_matrices(p, test_features, state.features, same=False)
    mean = _mean_ri(k_star, kt_re, kt_im, state.v)
    # re-modulate the envelope prediction to the lab frame (no-op at chirp_k = 0)
    mean = ri.phase_mul(mean, test_features @ state.chirp_k)
    # self-covariance k(x, x) = sigma^2 (m_R^2 + m_I^2 + noise^2)
    self_k = p.magnitude**2 * (p.real_magnitude**2 + p.imag_magnitude**2 + p.noise**2)
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
    return mean / state.rescale, var, ri.scale(mean, cut) / state.rescale


# -- purity via five auxiliary kernels ------------------------------------------------

def _aux_self(mag, lengths):
    """Auxiliary params of one kernel: (mag^2 sqrt(prod l), sqrt(2) l)."""
    return mag**2 * torch.sqrt(torch.prod(lengths, dim=-1)), math.sqrt(2.0) * lengths


def _aux_mixed(mag_a, len_a, mag_b, len_b):
    """Mixed auxiliary params of two kernels."""
    mag = mag_a * mag_b / torch.sqrt(
        torch.sqrt(torch.prod(0.5 * (1.0 / len_a**2 + 1.0 / len_b**2), dim=-1))
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
    g = gram_rbf(torch.stack([lengths for _, lengths in aux]), x, x)
    krp, kip, kcp, krc, kic = (mag**2 * g[i] for i, (mag, _) in enumerate(aux))
    k1 = krp + kip + 2.0 * p.corr**2 * kcp
    k2_re = krp - kip
    k2_im = -2.0 * p.corr * (krc + kic)
    a, b = state.v[..., 0], state.v[..., 1]
    # Re(v^H K1 v), K1 real symmetric
    quad1 = a @ (k1 @ a) + b @ (k1 @ b)
    # Re(v^T K2 v) = a^T C a - b^T C b - 2 a^T D b  (C = k2_re, D = k2_im sym)
    quad2 = a @ (k2_re @ a) - b @ (k2_re @ b) - 2.0 * (a @ (k2_im @ b))
    factor = purity_factor(d) * 2.0 * math.pi**d * p.magnitude**4
    return factor * (quad1 + quad2) / state.rescale**2
