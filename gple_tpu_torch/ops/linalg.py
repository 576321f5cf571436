"""Positive-definite linear algebra: the interface of :mod:`gple_tpu.ops.linalg`.

Every inverse is the direct Cholesky inverse, the JAX package's CPU branch
(``_direct_inverse``): batched ``torch.linalg.cholesky_ex`` and
``torch.cholesky_inverse``, then symmetrisation.  A matrix that is not
positive definite gives NaN, as the JAX package's Cholesky does, instead of
an error: the constrained ladder's losses map NaN to a large value and move
on, and no host sync checks the factorization.  The warm-start variants
ignore the warm start, as that CPU branch does.  Autograd differentiates the
Cholesky route directly, so no custom derivative rule is needed.

Not ported: the Newton-Schulz chain and its matmul-only triangular inverse
(``_ns_scan``, ``_newton_schulz_*``, ``triangular_inverse_lower``,
``_chol_matmul_inverse``).  They exist because XLA:TPU's triangular solves
hung at compile time and its Cholesky was slow; on the GPU the f64 Cholesky
is a library call.
"""

from __future__ import annotations

import torch


def _direct_inverse(k):
    chol, info = torch.linalg.cholesky_ex(k)
    chol = torch.where((info == 0)[..., None, None], chol, float("nan"))
    kinv = torch.cholesky_inverse(chol)
    return 0.5 * (kinv + kinv.transpose(-1, -2))


def psd_inverse(k):
    """Inverse of a symmetric positive-definite (..., N, N) matrix."""
    return _direct_inverse(k)


def psd_inverse_batched(ks):
    """:func:`psd_inverse` over a (B, N, N) stack."""
    return _direct_inverse(ks)


def psd_inverse_warm(k, x_warm):
    """:func:`psd_inverse`; the warm start ``x_warm`` is not needed by the
    direct factorization and is ignored."""
    del x_warm
    return _direct_inverse(k)


def psd_inverse_warm_batched(ks, xs_warm):
    """:func:`psd_inverse_warm` over (B, N, N) stacks."""
    del xs_warm
    return _direct_inverse(ks)


def refine_solve(kinv, k, y, iters: int = 5):
    """Iterative refinement of x = K^-1 y given an approximate inverse:
    x += X (y - K x).  ``y`` is (..., N), batched like ``kinv`` (..., N, N)."""

    def mv(m, v):
        return (m @ v[..., None])[..., 0]

    x = mv(kinv, y)
    for _ in range(iters):
        x = x + mv(kinv, y - mv(k, x))
    return x
