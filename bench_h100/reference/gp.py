"""Gaussian-process fits, predictions and phase-space integrals of one
trajectory state: the two diagonal elements as real GPs, the coherence as a
complex GP with independent real and imaginary kernels (corr = 0), whose
augmented system splits into two real SPD systems.

Kernel: k(x, x') = s^2 exp(-1/2 sum_d ((x_d - x'_d) / l_d)^2), noise
s^2 sigma_n^2 on the diagonal; labels rescaled to max |y| = 10; each solve
refined against its matrix."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

NOISE = 1e-2
RESCALE = 10.0
#: predictions below two standard deviations are smoothly suppressed
CONNECT = 2.0
#: rows of test points a block of a prediction takes
BLOCK = 4096


def unit_gram(lengths, xa, xb):
    """exp(-1/2 |(xa - xb) / l|^2), (Na, Nb)."""
    za, zb = xa / lengths, xb / lengths
    d2 = torch.sum((za[:, None, :] - zb[None, :, :]) ** 2, dim=-1)
    return torch.exp(-0.5 * d2)


def spd_inverse(k):
    chol = torch.linalg.cholesky(k)
    inv = torch.cholesky_inverse(chol)
    return 0.5 * (inv + inv.T)


def refined_solve(kinv, k, y, iters: int):
    x = kinv @ y
    for _ in range(iters):
        x = x + kinv @ (y - k @ x)
    return x


class RealGP(NamedTuple):
    mag: torch.Tensor
    lengths: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor        # rescaled labels
    rescale: torch.Tensor
    kinv: torch.Tensor
    alpha: torch.Tensor


def fit_real(mag, lengths, x, labels) -> RealGP:
    n = x.shape[0]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    k = mag ** 2 * (unit_gram(lengths, x, x) + NOISE ** 2 * eye)
    kinv = spd_inverse(k)
    rescale = RESCALE / torch.clamp(torch.max(torch.abs(labels)), min=1e-30)
    y = labels * rescale
    return RealGP(mag, lengths, x, y, rescale, kinv, refined_solve(kinv, k, y, 3))


def cutoff(value, var):
    """1 where |value| >= 2 sqrt(var), 0 below sqrt(var), a smooth cubic between."""
    t = torch.abs(value) / torch.sqrt(torch.clamp(var, min=1e-30))
    c = CONNECT
    mid = (3.0 * c - 2.0 * t - 1.0) * (t - 1.0) ** 2 / (c - 1.0) ** 3
    return torch.where(t >= c, 1.0, torch.where(t <= 1.0, 0.0, mid))


def predict_real(gp: RealGP, xt, with_variance: bool):
    """Raw mean, or with ``with_variance`` the cutoff mean, in label units, (M,)."""
    outs = []
    for xb in torch.split(xt, BLOCK):
        ks = gp.mag ** 2 * unit_gram(gp.lengths, xb, gp.x)
        mean = ks @ gp.alpha
        if with_variance:
            var = gp.mag ** 2 * (1.0 + NOISE ** 2) - torch.sum((ks @ gp.kinv) * ks, dim=-1)
            mean = mean * cutoff(mean, var)
        outs.append(mean / gp.rescale)
    return torch.cat(outs)


def population_real(gp: RealGP):
    d = gp.x.shape[-1] // 2
    return (2 * math.pi) ** d * gp.mag ** 2 * torch.prod(gp.lengths) * torch.sum(gp.alpha) \
        / gp.rescale


def r_average_real(gp: RealGP):
    d = gp.x.shape[-1] // 2
    return (2 * math.pi) ** d * gp.mag ** 2 * torch.prod(gp.lengths) * (gp.x.T @ gp.alpha) \
        / gp.rescale


def purity_real(gp: RealGP):
    """(2 pi)^d pi^d alpha^T K1 alpha / rescale^2, K1 = s^4 prod(l) k at sqrt(2) l."""
    d = gp.x.shape[-1] // 2
    k1 = gp.mag ** 4 * torch.prod(gp.lengths) * unit_gram(math.sqrt(2.0) * gp.lengths, gp.x, gp.x)
    return (2 * math.pi) ** d * math.pi ** d * (gp.alpha @ (k1 @ gp.alpha)) / gp.rescale ** 2


def magnitude_real(gp: RealGP):
    """The maximum-likelihood magnitude at unit magnitude: sqrt(|y . alpha| / N)."""
    return torch.sqrt(torch.abs(gp.y @ gp.alpha) / gp.y.shape[0])


class ComplexGP(NamedTuple):
    """f = f_R + i f_I, f_R ~ GP(0, s^2 m_R^2 k_R), f_I ~ GP(0, s^2 m_I^2 k_I)
    independent: the covariance of f is A + B, its pseudo-covariance A - B
    (A, B the scaled real and imaginary kernels), so the augmented system of
    f and its conjugate splits into the real systems 2A + noise for Re and
    2B + noise for Im."""
    s: torch.Tensor
    m_re: torch.Tensor
    l_re: torch.Tensor
    m_im: torch.Tensor
    l_im: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor        # (N, 2) rescaled labels
    rescale: torch.Tensor
    inv_re: torch.Tensor   # (2A + noise)^-1
    inv_im: torch.Tensor   # (2B + noise)^-1
    a: torch.Tensor        # solve of the real part
    b: torch.Tensor        # solve of the imaginary part


def fit_complex(s, m_re, l_re, m_im, l_im, x, labels) -> ComplexGP:
    n = x.shape[0]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    noise = s ** 2 * NOISE ** 2 * eye
    ka = 2.0 * s ** 2 * m_re ** 2 * unit_gram(l_re, x, x) + noise
    kb = 2.0 * s ** 2 * m_im ** 2 * unit_gram(l_im, x, x) + noise
    inv_re, inv_im = spd_inverse(ka), spd_inverse(kb)
    amp = torch.sqrt(labels[:, 0] ** 2 + labels[:, 1] ** 2)
    rescale = RESCALE / torch.clamp(torch.max(amp), min=1e-30)
    y = labels * rescale
    a = refined_solve(inv_re, ka, y[:, 0], 4)
    b = refined_solve(inv_im, kb, y[:, 1], 4)
    return ComplexGP(s, m_re, l_re, m_im, l_im, x, y, rescale, inv_re, inv_im, a, b)


def predict_complex(gp: ComplexGP, xt, with_variance: bool):
    """(M, 2) RI prediction in label units: raw mean, or the cutoff mean."""
    outs = []
    for xb in torch.split(xt, BLOCK):
        ka = gp.s ** 2 * gp.m_re ** 2 * unit_gram(gp.l_re, xb, gp.x)
        kb = gp.s ** 2 * gp.m_im ** 2 * unit_gram(gp.l_im, xb, gp.x)
        mean = torch.stack([2.0 * (ka @ gp.a), 2.0 * (kb @ gp.b)], dim=-1)
        if with_variance:
            prior = gp.s ** 2 * (gp.m_re ** 2 + gp.m_im ** 2 + NOISE ** 2)
            var = prior - 2.0 * torch.sum((ka @ gp.inv_re) * ka, dim=-1) \
                - 2.0 * torch.sum((kb @ gp.inv_im) * kb, dim=-1)
            mean = mean * cutoff(torch.hypot(mean[:, 0], mean[:, 1]), var)[:, None]
        outs.append(mean / gp.rescale)
    return torch.cat(outs)


def purity_complex(gp: ComplexGP):
    """(2 pi)^d 2 pi^d s^4 * 2 (a^T K_R' a + b^T K_I' b) / rescale^2, K' the
    sqrt(2)-widened kernels with magnitude m^4 prod(l)."""
    d = gp.x.shape[-1] // 2
    kr = gp.m_re ** 4 * torch.prod(gp.l_re) * unit_gram(math.sqrt(2.0) * gp.l_re, gp.x, gp.x)
    ki = gp.m_im ** 4 * torch.prod(gp.l_im) * unit_gram(math.sqrt(2.0) * gp.l_im, gp.x, gp.x)
    quad = 2.0 * (gp.a @ (kr @ gp.a) + gp.b @ (ki @ gp.b))
    return (2 * math.pi) ** d * 2.0 * math.pi ** d * gp.s ** 4 * quad / gp.rescale ** 2


def magnitude_complex(gp: ComplexGP):
    """sqrt(|Re(y^H v)| / N) at unit magnitude."""
    return torch.sqrt(torch.abs(gp.y[:, 0] @ gp.a + gp.y[:, 1] @ gp.b) / gp.y.shape[0])
