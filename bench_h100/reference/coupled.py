"""The coherence as a complex GP whose real and imaginary parts are
correlated (corr != 0, the reference program's kernel has corr = 1): the
coupled fit of the (2N, 2N) joint system, written from the equations.

f = f_R + i f_I at magnitude s has the joint prior

    cov(f_R, f_R) = s^2 m_R^2 k_R,  cov(f_I, f_I) = s^2 m_I^2 k_I,
    cov(f_R, f_I) = s^2 corr c_m^2 k_C,

k_X(x, x') = exp(-1/2 sum_d ((x_d - x'_d) / l_X,d)^2), and the correlation
kernel's magnitude and lengths from the reference program's complex kernel
(``complex_kernel.cpp``): c_m^2 = m_R m_I prod_d 2 l_R,d l_I,d / (l_R,d^2 +
l_I,d^2), l_C^2 = (l_R^2 + l_I^2) / 2.  With v = a + ib the augmented
system [[K, K~], [K~*, K*]] [v; v*] = [y; y*] (K = E f f*, K~ = E f f) is
the real system M [a; b] = [Re y; Im y], M twice the joint prior plus the
noise s^2 sigma_n^2 on its diagonal; the mean at x is M_*(x) [a; b], the
posterior variance of f there the prior's trace s^2 (m_R^2 + m_I^2 +
sigma_n^2) less half the trace of M_* M^-1 M_*^T.  The leave-one-out
residual of a point is the inverse of its (2, 2) block of M^-1 times its
two entries of [a; b].  The purity integral is (2 pi)^d int |f|^2 dx over
the phase space of dimension D = 2d, each product of two Gaussian kernels
integrated in closed form."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from bench_h100.reference import gp as GP


class CoupledGP(NamedTuple):
    s: torch.Tensor        # global magnitude
    m_re: torch.Tensor
    l_re: torch.Tensor     # (D,)
    m_im: torch.Tensor
    l_im: torch.Tensor     # (D,)
    corr: torch.Tensor
    x: torch.Tensor        # (N, D)
    y: torch.Tensor        # (N, 2) rescaled labels
    rescale: torch.Tensor
    w: torch.Tensor        # (2N, 2N) M^-1
    ab: torch.Tensor       # (2N,) [a; b]


def correlation(m_re, l_re, m_im, l_im):
    """(c_m^2, l_C) of the correlation kernel."""
    sq = l_re ** 2 + l_im ** 2
    return m_re * m_im * torch.prod(2.0 * l_re * l_im / sq), torch.sqrt(sq / 2.0)


def joint(gp_or_params, xa, xb):
    """Twice the joint prior covariance of (f_R at xa, f_I at xa) with
    (f_R at xb, f_I at xb): (2 Na, 2 Nb), no noise.  Takes a
    :class:`CoupledGP` or a tuple (s, m_re, l_re, m_im, l_im, corr)."""
    s, m_re, l_re, m_im, l_im, corr = tuple(gp_or_params)[:6]
    c2, l_c = correlation(m_re, l_re, m_im, l_im)
    two = 2.0 * s ** 2
    rr = two * m_re ** 2 * GP.unit_gram(l_re, xa, xb)
    ii = two * m_im ** 2 * GP.unit_gram(l_im, xa, xb)
    ri = two * corr * c2 * GP.unit_gram(l_c, xa, xb)
    return torch.cat([torch.cat([rr, ri], dim=1), torch.cat([ri, ii], dim=1)], dim=0)


def fit(s, off, x, labels) -> CoupledGP:
    """The coupled fit at magnitude ``s`` of the coherence parameters ``off``
    (m_R, l_R (D), m_I, l_I (D), corr) to the points (N, D) and RI labels
    (N, 2), rescaled to max |label| = 10; the solve refined four times."""
    d = x.shape[1]
    params = (s, off[0], off[1:1 + d], off[1 + d], off[2 + d:2 + 2 * d], off[2 + 2 * d])
    n = x.shape[0]
    eye = torch.eye(2 * n, dtype=x.dtype, device=x.device)
    m = joint(params, x, x) + s ** 2 * GP.NOISE ** 2 * eye
    w = GP.spd_inverse(m)
    amp = torch.sqrt(labels[:, 0] ** 2 + labels[:, 1] ** 2)
    rescale = GP.RESCALE / torch.clamp(torch.max(amp), min=1e-30)
    y = labels * rescale
    ab = GP.refined_solve(w, m, torch.cat([y[:, 0], y[:, 1]]), 4)
    return CoupledGP(*params, x, y, rescale, w, ab)


def _mean_blocks(gp: CoupledGP, xt, with_variance: bool):
    """(mean (Mb, 2) rescaled, variance (Mb,) or None) block by block."""
    for xb in torch.split(xt, GP.BLOCK):
        ms = joint(gp, xb, gp.x)
        flat = ms @ gp.ab
        mb = xb.shape[0]
        mean = torch.stack([flat[:mb], flat[mb:]], dim=-1)
        var = None
        if with_variance:
            prior = gp.s ** 2 * (gp.m_re ** 2 + gp.m_im ** 2 + GP.NOISE ** 2)
            quad = torch.sum((ms @ gp.w) * ms, dim=-1)
            var = prior - 0.5 * (quad[:mb] + quad[mb:])
        yield mean, var


def predict(gp: CoupledGP, xt, with_variance: bool):
    """(M, 2) RI prediction in label units: the mean, or with
    ``with_variance`` the cutoff mean (:func:`gp.cutoff` of |mean|)."""
    outs = []
    for mean, var in _mean_blocks(gp, xt, with_variance):
        if with_variance:
            mean = mean * GP.cutoff(torch.hypot(mean[:, 0], mean[:, 1]), var)[:, None]
        outs.append(mean / gp.rescale)
    return torch.cat(outs)


def loocv(gp: CoupledGP):
    """Sum over the points of |(2, 2) block of M^-1|^-1 [a_i; b_i]|^2."""
    n = gp.x.shape[0]
    w11 = torch.diagonal(gp.w[:n, :n])
    w22 = torch.diagonal(gp.w[n:, n:])
    w12 = torch.diagonal(gp.w[:n, n:])
    a, b = gp.ab[:n], gp.ab[n:]
    det = w11 * w22 - w12 ** 2
    r_re = (w22 * a - w12 * b) / det
    r_im = (w11 * b - w12 * a) / det
    return torch.sum(r_re ** 2 + r_im ** 2)


def extra_error(gp: CoupledGP, xe, ye):
    """Squared error of the mean at the extra points (M, D) against their RI
    labels (M, 2), in rescaled units."""
    err = torch.zeros((), dtype=xe.dtype, device=xe.device)
    for (mean, _), yb in zip(_mean_blocks(gp, xe, False), torch.split(ye, GP.BLOCK)):
        err = err + torch.sum((mean - yb * gp.rescale) ** 2)
    return err


def _overlap(l1, l2, x):
    """int k_1(z, x_i) k_2(z, x_j) dz over the D-dimensional phase space,
    (N, N): (2 pi)^(D/2) prod(l1 l2 / sqrt(l1^2 + l2^2)) times the unit Gram
    at lengths sqrt(l1^2 + l2^2)."""
    width = torch.sqrt(l1 ** 2 + l2 ** 2)
    scale = (2.0 * math.pi) ** (x.shape[1] / 2.0) * torch.prod(l1 * l2 / width)
    return scale * GP.unit_gram(width, x, x)


def purity(gp: CoupledGP):
    """(2 pi)^d int |f|^2 dx / rescale^2, with Re f = sum_j (c_R k_R a_j +
    c_C k_C b_j) and Im f = sum_j (c_I k_I b_j + c_C k_C a_j), c_X twice the
    scaled magnitudes."""
    n, dim = gp.x.shape
    c2, l_c = correlation(gp.m_re, gp.l_re, gp.m_im, gp.l_im)
    two = 2.0 * gp.s ** 2
    c_r, c_i, c_c = two * gp.m_re ** 2, two * gp.m_im ** 2, two * gp.corr * c2
    a, b = gp.ab[:n], gp.ab[n:]
    quad = lambda u, l1, l2, v: u @ (_overlap(l1, l2, gp.x) @ v)
    re2 = (c_r ** 2 * quad(a, gp.l_re, gp.l_re, a) + 2.0 * c_r * c_c * quad(a, gp.l_re, l_c, b)
           + c_c ** 2 * quad(b, l_c, l_c, b))
    im2 = (c_i ** 2 * quad(b, gp.l_im, gp.l_im, b) + 2.0 * c_i * c_c * quad(b, gp.l_im, l_c, a)
           + c_c ** 2 * quad(a, l_c, l_c, a))
    return (2.0 * math.pi) ** (dim // 2) * (re2 + im2) / gp.rescale ** 2


def magnitude(gp: CoupledGP):
    """The maximum-likelihood magnitude at unit magnitude: sqrt(|Re(y^H v)| / N)."""
    n = gp.x.shape[0]
    return torch.sqrt(torch.abs(gp.y[:, 0] @ gp.ab[:n] + gp.y[:, 1] @ gp.ab[n:]) / n)
