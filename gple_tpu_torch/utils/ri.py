"""Real-imaginary (RI) representation of complex values, in PyTorch.

Counterpart of :mod:`gple_tpu.utils.ri`.  The port keeps the trailing-axis-2
layout ``z[..., 0] = Re, z[..., 1] = Im`` so every container maps onto the JAX
package field for field; complex dtypes appear only at the edges
(:func:`from_complex`, :func:`to_complex`).
"""

from __future__ import annotations

import torch


def ri(re, im=None):
    """Pack (re, im) into an RI tensor; im defaults to zero."""
    if im is None:
        im = torch.zeros_like(re)
    im = torch.as_tensor(im, dtype=re.dtype, device=re.device)
    return torch.stack([re, torch.broadcast_to(im, re.shape)], dim=-1)


def from_complex(z):
    return torch.stack([z.real, z.imag], dim=-1)


def to_complex(z):
    return torch.complex(z[..., 0], z[..., 1])


def re(z):
    return z[..., 0]


def im(z):
    return z[..., 1]


def conj(z):
    return torch.stack([z[..., 0], -z[..., 1]], dim=-1)


def add(a, b):
    return a + b


def mul(a, b):
    """Elementwise complex multiply."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return torch.stack([ar * br - ai * bi, ar * bi + ai * br], dim=-1)


def scale(a, s):
    """Multiply by a real scalar/tensor (broadcast over the RI axis)."""
    return a * torch.as_tensor(s)[..., None]


def abs2(z):
    return z[..., 0] ** 2 + z[..., 1] ** 2


def absval(z):
    return torch.hypot(z[..., 0], z[..., 1])


def phase_mul(z, theta):
    """Multiply by e^{i theta} (theta real, broadcast against z[..., 0])."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack(
        [z[..., 0] * c - z[..., 1] * s, z[..., 0] * s + z[..., 1] * c], dim=-1
    )


def matvec(m_re, m_im, v):
    """(complex matrix as two real parts) @ (RI vector) -> RI vector."""
    vr, vi = v[..., 0], v[..., 1]
    return torch.stack([m_re @ vr - m_im @ vi, m_re @ vi + m_im @ vr], dim=-1)


def rmatvec(m_re, v):
    """(real matrix) @ (RI vector)."""
    return torch.stack([m_re @ v[..., 0], m_re @ v[..., 1]], dim=-1)


def matmul(a_re, a_im, b_re, b_im):
    """Complex matmul from real parts -> (re, im)."""
    return a_re @ b_re - a_im @ b_im, a_re @ b_im + a_im @ b_re


def vdot_re(a, b):
    """Re(a^H b) = sum(a_re b_re + a_im b_im)."""
    return torch.sum(a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1], dim=-1)
