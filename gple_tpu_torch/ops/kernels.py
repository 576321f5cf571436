"""Real Gaussian-process kernel for the diagonal density-matrix elements.

Counterpart of :mod:`gple_tpu.ops.kernels`:

* k(x, x') = sigma_f^2 (exp(-1/2 sum_d ((x_d - x'_d)/l_d)^2) + sigma_n^2 delta)
* label rescaling to max = 10, K^-1 and the refined K^-1 y
* predictive mean / variance / smoothstep cutoff
* analytic population / <r> / purity integrals

Where JAX wrote each function for one element and ``vmap``-ed it, these take
batched leaves directly: a ``RealTrainState`` whose leaves carry a leading
element axis (as ``GPStates.diag`` does) predicts and integrates all its
elements at once, which is what lets one kernel launch serve both diagonal
elements.  Because of that batching, vector and matrix lengths cannot be told
apart by rank alone; functions that see only the lengths take ``matrix``.

Every Gram goes through :func:`gple_tpu_torch.ops.gram_kernels.gram_rbf` and
the mean-only predict through ``predict_mean_rbf`` (the CUDA kernels on the
GPU).  The precision is float64: the JAX package's f32 TPU predict branch
(``predict_impl``) is not ported.  ``loocv_error``, ``extra_set_error`` and
``optimal_magnitude`` belong to the optimizer and come with it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gple_tpu_torch.ops.gram_kernels import gram_rbf, predict_mean_rbf
from gple_tpu_torch.ops.linalg import psd_inverse, psd_inverse_warm, refine_solve
from gple_tpu_torch.utils.constants import purity_factor

#: rescale target: max |label| -> 10
RESCALE_MAXIMUM = 10.0
#: cutoff connecting point: predictions below 2 sigma are suppressed
CONNECTING_POINT = 2.0


class KernelParams(NamedTuple):
    """(magnitude, lengths, noise); leaves may carry leading batch axes."""

    magnitude: torch.Tensor   # (...) sigma_f
    lengths: torch.Tensor     # (..., PhaseDim) or (..., PhaseDim, PhaseDim)
    noise: torch.Tensor       # (...) relative noise sigma_n


def _col(s):
    """A per-batch scalar broadcast against (..., N, M) matrices."""
    return s[..., None, None]


def _kernel_operands(lengths, xa, xb):
    """(lengths, xa, xb) as the kernels take them.  Vector lengths ``(..., D)``
    pass through (z = x / l).  Matrix lengths ``(..., D, D)``, of the same rank
    as the features, are a full characteristic matrix W: z = W x is applied
    here and the kernel gets unit lengths."""
    if lengths.dim() == xa.dim():
        za = torch.einsum("...ij,...nj->...ni", lengths, xa)
        zb = torch.einsum("...ij,...nj->...ni", lengths, xb)
        return torch.ones_like(za[..., 0, :]), za, zb
    return lengths, xa, xb


def gram(lengths, xa, xb):
    """Unit-magnitude RBF Gram matrix exp(-1/2 |z_a - z_b|^2), (..., Na, Nb),
    for vector or matrix lengths (see :func:`_kernel_operands`)."""
    return gram_rbf(*_kernel_operands(lengths, xa, xb))


def effective_length_product(lengths, matrix: bool = False):
    """prod of characteristic lengths -- the Gaussian-integral volume factor;
    1/prod(|diag W|) for a characteristic matrix W."""
    if matrix:
        return 1.0 / torch.abs(torch.prod(torch.diagonal(lengths, dim1=-2, dim2=-1), dim=-1))
    return torch.prod(lengths, dim=-1)


def purity_aux_lengths(lengths, matrix: bool = False):
    """The sqrt(2)-widened characteristic of the purity auxiliary kernel
    exp(-1/4 |z_i - z_j|^2): sqrt(2) l, or W / sqrt(2) for a matrix."""
    if matrix:
        return lengths / math.sqrt(2.0)
    return math.sqrt(2.0) * lengths


def scale_gram(params: KernelParams, g, same: bool):
    """sigma_f^2 (G + sigma_n^2 I[same]) from a unit Gram ``g``."""
    if same:
        g = g + _col(params.noise**2) * torch.eye(g.shape[-1], dtype=g.dtype, device=g.device)
    return _col(params.magnitude**2) * g


def kernel_matrix(params: KernelParams, xa, xb, same: bool):
    """Full kernel sigma_f^2 (G + sigma_n^2 I[same]), (..., Na, Nb)."""
    return scale_gram(params, gram(params.lengths, xa, xb), same)


class RealTrainState(NamedTuple):
    """Everything cached from one training-set factorization (leaves may carry
    a leading element axis)."""

    params: KernelParams
    features: torch.Tensor   # (..., N, PhaseDim)
    labels: torch.Tensor     # (..., N) rescaled real labels
    rescale: torch.Tensor    # (...) labels = raw * rescale
    kinv: torch.Tensor       # (..., N, N) K^-1
    alpha: torch.Tensor      # (..., N) K^-1 labels (rescaled)


def finish_real_fit(params: KernelParams, features, labels_raw, k, kinv) -> RealTrainState:
    """State assembly after the SPD inverse: label rescale + refined alpha."""
    labels_real = torch.real(labels_raw)
    # the clip guards all-zero labels (inactive elements): an unbounded rescale
    # overflows every rescale**2 downstream, and 0 * inf = NaN
    rescale = RESCALE_MAXIMUM / torch.clamp(
        torch.amax(torch.abs(labels_real), dim=-1), min=1e-30)
    y = labels_real * rescale[..., None]
    alpha = refine_solve(kinv, k, y, iters=3)
    return RealTrainState(params=params, features=features, labels=y, rescale=rescale,
                          kinv=kinv, alpha=alpha)


def fit_real(params: KernelParams, features, labels_raw, kinv_warm=None) -> RealTrainState:
    """Factorize the training kernel; ``kinv_warm`` selects the warm inverse."""
    k = kernel_matrix(params, features, features, same=True)
    kinv = psd_inverse(k) if kinv_warm is None else psd_inverse_warm(k, kinv_warm)
    return finish_real_fit(params, features, labels_raw, k, kinv)


def predict_real(state: RealTrainState, test_features, with_variance: bool = True):
    """Mean, variance and cutoff prediction at ``test_features`` (..., M, D).

    Returns ``(mean_raw, variance, cutoff_raw)``: means unscaled back to label
    units, variance in rescaled units.  ``with_variance=False`` runs the fused
    mean (one ``predict_mean_rbf`` launch for every element of the batch) and
    returns ``None`` for the variance."""
    p = state.params
    mag2 = p.magnitude**2
    rescale = state.rescale[..., None]
    if not with_variance:
        lengths, xt, xtr = _kernel_operands(p.lengths, test_features, state.features)
        g_alpha = predict_mean_rbf(lengths, xt, xtr, state.alpha[..., None])[..., 0]
        mean_scaled = mag2[..., None] * g_alpha
        return mean_scaled / rescale, None, mean_scaled / rescale
    k_star = kernel_matrix(p, test_features, state.features, same=False)
    mean_scaled = (k_star @ state.alpha[..., None])[..., 0]
    # var_i = k(x_i, x_i) - k_star_i K^-1 k_star_i^T
    self_k = mag2 * (1.0 + p.noise**2)
    var = self_k[..., None] - torch.sum((k_star @ state.kinv) * k_star, dim=-1)
    cut = cutoff_factor(mean_scaled, var)
    return mean_scaled / rescale, var, mean_scaled * cut / rescale


def cutoff_factor(prediction, variance):
    """Smoothstep suppression of low-signal predictions: 1 where |pred| >= 2
    sqrt(var), 0 where |pred| <= sqrt(var), a smooth cubic in between."""
    c = CONNECTING_POINT
    # the 1e-30 floor keeps t finite for zero-mean zero-variance rows
    # (inactive elements), as in the JAX package
    var = torch.clamp(variance, min=1e-30)
    t = torch.abs(prediction) / torch.sqrt(var)
    mid = (3.0 * c - 2.0 * t - 1.0) * (t - 1.0) ** 2 / (c - 1.0) ** 3
    return torch.where(t >= c, 1.0, torch.where(t <= 1.0, 0.0, mid))


# -- analytic phase-space integrals -----------------------------------------------

def _dim(state: RealTrainState) -> int:
    return state.features.shape[-1] // 2


def _is_matrix(state: RealTrainState) -> bool:
    return state.params.lengths.dim() == state.features.dim()


def _integral_factor(state: RealTrainState):
    return (2.0 * math.pi) ** _dim(state) * state.params.magnitude**2 \
        * effective_length_product(state.params.lengths, _is_matrix(state))


def population(state: RealTrainState):
    """integral f(r) dr = (2 pi)^Dim sigma_f^2 prod(l) sum(alpha) / rescale."""
    return _integral_factor(state) * torch.sum(state.alpha, dim=-1) / state.rescale


def r_average(state: RealTrainState):
    """integral r f(r) dr, shape (..., PhaseDim)."""
    moment = (state.features.transpose(-1, -2) @ state.alpha[..., None])[..., 0]
    return _integral_factor(state)[..., None] * moment / state.rescale[..., None]


def purity(state: RealTrainState):
    """(2 pi hbar)^Dim integral f^2 dr via the sqrt(2)-widened auxiliary kernel:
    (2 pi hbar)^Dim pi^Dim alpha^T K1 alpha / rescale^2 with
    K1 = sigma_f^4 prod(l) exp(-1/4 sum((dx/l)^2))."""
    d = _dim(state)
    matrix = _is_matrix(state)
    lengths = state.params.lengths
    aux_mag_sq = state.params.magnitude**4 * effective_length_product(lengths, matrix)
    k1 = _col(aux_mag_sq) * gram(purity_aux_lengths(lengths, matrix),
                                 state.features, state.features)
    a = state.alpha[..., None]
    quad = (a.transpose(-1, -2) @ (k1 @ a))[..., 0, 0]
    return purity_factor(d) * math.pi**d * quad / state.rescale**2
