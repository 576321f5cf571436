"""The coupled (2N, 2N) coherence fit of the plain reference
(:mod:`bench_h100.reference.coupled`) against the program's full-embedding
complex GP at N = 64 on the CPU, and the block-diagonal fit (corr = 0) of
:func:`follow.fit` pinned to the plain one it always made."""

import pytest
import torch

from bench_h100.reference import coupled as CP
from bench_h100.reference import follow as F
from bench_h100.reference import gp as GP
from gple_tpu_torch.ops import complex_kernels as CK

N = 64


def _cloud(gen, n):
    """A coherence-like cloud near x = -4, p = 20 and its chirped RI labels."""
    x = torch.stack([-4.0 + 0.7 * torch.randn(n, generator=gen, dtype=torch.float64),
                     20.0 + torch.randn(n, generator=gen, dtype=torch.float64)], dim=-1)
    env = torch.exp(-0.5 * ((x[:, 0] + 4.0) / 0.8) ** 2 - 0.5 * ((x[:, 1] - 20.0) / 1.2) ** 2)
    phase = 1.3 * x[:, 0] + 0.2 * x[:, 1]
    labels = 0.03 * env[:, None] * torch.stack([torch.cos(phase), torch.sin(phase)], dim=-1)
    return x, labels


def _case(corr: float, s: float):
    gen = torch.Generator().manual_seed(2147484301)
    x, labels = _cloud(gen, N)
    xe, ye = _cloud(gen, 5 * N)
    xt = x + 0.3 * torch.randn(x.shape, generator=gen, dtype=torch.float64)
    off = torch.tensor([1.7, 0.45, 0.9, 0.6, 0.35, 1.2, corr], dtype=torch.float64)
    params = CK.ComplexKernelParams(
        magnitude=torch.tensor(s, dtype=torch.float64), real_magnitude=off[0],
        real_lengths=off[1:3], imag_magnitude=off[3], imag_lengths=off[4:6],
        noise=torch.tensor(GP.NOISE, dtype=torch.float64), corr=off[6])
    prog = CK.fit_complex(params, x, labels, block_diag=False)
    ref = CP.fit(torch.tensor(s, dtype=torch.float64), off, x, labels)
    return prog, ref, (xt, xe, ye)


def _close(got, want, rtol=1e-10, scale=None):
    scale = float(torch.max(torch.abs(want))) if scale is None else float(scale)
    assert float(torch.max(torch.abs(got - want))) <= rtol * scale, (got, want)


@pytest.mark.parametrize("corr", [1.0, 0.4])
@pytest.mark.parametrize("s", [1.0, 40.0])
def test_coupled_fit_against_the_program(corr, s):
    prog, ref, (xt, xe, ye) = _case(corr, s)
    _close(torch.cat([ref.ab[:N, None], ref.ab[N:, None]], dim=1), prog.v)
    mean, var, cut = CK.predict_complex(prog, xt, with_variance=True)
    ref_mean, ref_var = next(CP._mean_blocks(ref, xt, True))
    _close(ref_mean / ref.rescale, mean)
    # the variance is the prior less a quadratic form of about its size:
    # its rounding is the prior's
    prior = ref.s ** 2 * (ref.m_re ** 2 + ref.m_im ** 2 + GP.NOISE ** 2)
    _close(ref_var, var, scale=prior)
    # the cutoff's slope in the variance magnifies the variance's rounding
    # where it bites: the cutoff mean at the program's variance is the program's
    amp = torch.hypot(ref_mean[:, 0], ref_mean[:, 1])
    _close(ref_mean * GP.cutoff(amp, var)[:, None] / ref.rescale, cut)
    _close(CP.predict(ref, xt, False), mean)
    _close(CP.loocv(ref), CK.loocv_error_complex(prog))
    _close(CP.extra_error(ref, xe, ye), CK.extra_set_error_complex(prog, xe, ye))
    _close(CP.purity(ref), CK.purity_complex(prog))
    _close(CP.magnitude(ref), CK.optimal_magnitude_complex(prog))


def test_coupled_at_corr_zero_is_the_block_diagonal_fit():
    """Both references agree where both apply: corr = 0."""
    _, ref, (xt, _, _) = _case(0.0, 3.0)
    gen = torch.Generator().manual_seed(2147484301)
    x, labels = _cloud(gen, N)
    off = torch.tensor([1.7, 0.45, 0.9, 0.6, 0.35, 1.2], dtype=torch.float64)
    s = torch.tensor(3.0, dtype=torch.float64)
    bd = GP.fit_complex(s, off[0], off[1:3], off[3], off[4:6], x, labels)
    _close(CP.predict(ref, xt, True), GP.predict_complex(bd, xt, True))
    _close(CP.purity(ref), GP.purity_complex(bd))
    _close(CP.magnitude(ref), GP.magnitude_complex(bd))


def _params(corr: float):
    t = lambda v: torch.tensor(v, dtype=torch.float64)
    return F.Params(t([[0.3, 0.8], [0.4, 0.9]]), t([1.1, 0.7]),
                    t([1.7, 0.45, 0.9, 0.6, 0.35, 1.2, corr]), t(2.5))


def test_follow_fit_at_corr_zero_is_bit_identical():
    """At corr = 0 ``follow.fit`` makes the block-diagonal fit it always
    made, bit for bit: the moment cells' check computes what it computed."""
    gen = torch.Generator().manual_seed(2147484302)
    pts = torch.stack([_cloud(gen, N)[0] for _ in range(3)])
    rho = torch.stack([torch.rand(N, 2, generator=gen, dtype=torch.float64) for _ in range(3)])
    params = _params(0.0)
    fits = F.fit(params, pts, rho, (True, True, True))
    o = params.off
    want = GP.fit_complex(params.off_mag, o[0], o[1:3], o[3], o[4:6], pts[1], rho[1])
    assert isinstance(fits.off, GP.ComplexGP)
    for got, ref in zip(fits.off, want):
        assert torch.equal(got, ref)
    pred = F.dist(fits, True)(pts)
    assert torch.equal(pred[1], GP.predict_complex(want, pts[1], True))
    coupled = F.fit(_params(1.0), pts, rho, (True, True, True))
    assert isinstance(coupled.off, CP.CoupledGP)
