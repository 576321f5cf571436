"""Metropolis phase-space sampler (counterpart of :mod:`gple_tpu.sampler.mc`).

* initial Gaussian phase-space distribution             -- ``mc.cpp:30-50``
* Metropolis Markov chains, all walkers in one step     -- ``mc.cpp:143-188``
* displacement tuning over a log grid of 16 candidates  -- ``mc.cpp:288-331``
* autocorrelation-based step-count tuning               -- ``mc.cpp:197-279``
* extra-point jittering                                 -- ``mc.cpp:59-120``
* new-element point seeding                             -- ``mc.cpp:407-537``

Distribution functions follow ``dist_fn(dist_params, pts (M, PhaseDim)) ->
(M, 2) RI``.  A chain step is one Python-loop iteration that evaluates the
distribution once for every walker; the 16 displacement candidates ride on a
leading axis (the JAX package's ``vmap``) and are evaluated in the same call.
Random numbers come from the ``key`` argument (:mod:`.keys`), split where the
JAX package splits its key; a chain draws all its steps' proposals and
acceptance numbers up front.  As in the JAX package, acceptance ratios are
float32 (``jnp.mean`` of a bool array) and the autocorrelation FFT runs in
float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from gple_tpu_torch.utils import ri

#: Metropolis acceptance-ratio window (mc.cpp:19-21)
MAX_ACCEPT_RATIO = 0.5
MIN_ACCEPT_RATIO = 0.15
#: candidate maximum displacements (mc.cpp:298)
POSSIBLE_DISPLACEMENTS = (
    1e-4, 2e-4, 5e-4, 1e-3, 2e-3, 5e-3, 0.01, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0,
)
#: choose the minimal step whose |autocorr| < factor * min|autocorr| (mc.h:55)
ABOVE_MIN_FACTOR = 1.1


@dataclasses.dataclass
class MCParameters:
    """Per-element tuned sampler parameters (reference mc.h:46-92)."""

    num_steps: int = 200
    displacement: float = 1.0


def initial_distribution(r0, sigma_r0, pts, row, col, populations, phase_factors):
    """Initial Gaussian phase-space density of element (row, col) at ``pts``
    (M, PhaseDim), returned as an RI tensor (M, 2)."""
    r0 = torch.as_tensor(r0, dtype=pts.dtype, device=pts.device)
    sig = torch.as_tensor(sigma_r0, dtype=pts.dtype, device=pts.device)
    dim = r0.shape[0] // 2
    gauss = torch.exp(-0.5 * torch.sum(((pts - r0) / sig) ** 2, dim=-1)) / (
        (2.0 * math.pi) ** dim * torch.prod(sig)
    )
    pops = torch.as_tensor(populations, dtype=pts.dtype, device=pts.device)
    phases = torch.as_tensor(phase_factors, dtype=pts.dtype, device=pts.device)
    weight = pops[row] * pops[col] / torch.sum(pops**2)
    return ri.phase_mul(ri.ri(gauss * weight), phases[row] - phases[col])


def _weights(dist_fn, dist_params, pts):
    """|dist| at walkers of any leading shape (..., M, D), in one call."""
    flat = pts.reshape(-1, pts.shape[-1])
    return ri.absval(dist_fn(dist_params, flat)).reshape(pts.shape[:-1])


def markov_chain(key, dist_fn, dist_params, n_steps: int, pts, record: bool,
                 displacement):
    """Advance all walkers ``n_steps`` Metropolis steps simultaneously.

    ``pts`` is (*key.batch, M, PhaseDim); ``displacement`` a number or a
    tensor of the key's batch shape.  Returns ``(final_pts, accept_mask
    (*batch, n_steps, M), chain or None)`` where ``chain`` is the recorded
    (*batch, n_steps + 1, M, PhaseDim) positions when ``record``."""
    nb = len(key.batch)
    k1, k2 = key.split_stack(n_steps).split(2)
    if isinstance(displacement, torch.Tensor):
        displacement = displacement[..., None]         # against the step axis
    steps = k1.uniform(pts.shape[-2:], low=-displacement, high=displacement)
    draws = k2.uniform(pts.shape[-2:-1])
    cur = pts
    w_cur = _weights(dist_fn, dist_params, cur)
    accepts, chain = [], [cur]
    for i in range(n_steps):
        prop = cur + steps.select(nb, i)
        w_new = _weights(dist_fn, dist_params, prop)
        accept = (w_new > w_cur) | (w_new > draws.select(nb, i) * w_cur)
        cur = torch.where(accept[..., None], prop, cur)
        w_cur = torch.where(accept, w_new, w_cur)
        accepts.append(accept)
        if record:
            chain.append(cur)
    accepts = torch.stack(accepts, dim=nb)
    return cur, accepts, (torch.stack(chain, dim=nb) if record else None)


def _accept_ratio(accepts, dim):
    """Mean of a bool mask in float32 as the JAX package's compiled
    ``jnp.mean`` gives it: the exact count times the float32 reciprocal of
    the number of entries (XLA turns the division by a constant into that
    product, which can differ from a division in the last bit)."""
    dims = (dim,) if isinstance(dim, int) else tuple(dim)
    n = 1
    for d in dims:
        n *= accepts.shape[d]
    return torch.sum(accepts, dim=dims, dtype=torch.float32) * float(
        np.float32(1.0) / np.float32(n))


def _round_up_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _displacement_sweep(key, dist_fn, dist_params, pts):
    """Acceptance ratio of each candidate displacement, all 16 chains batched."""
    n_steps = pts.shape[-1] * 500  # mc.cpp:297
    disps = torch.tensor(POSSIBLE_DISPLACEMENTS, dtype=pts.dtype, device=pts.device)
    batch = len(POSSIBLE_DISPLACEMENTS)
    _, accepts, _ = markov_chain(key.split_stack(batch), dist_fn, dist_params, n_steps,
                                 pts.expand((batch,) + pts.shape), False, disps)
    return _accept_ratio(accepts, (1, 2))


def tune_displacement(key, dist_fn, dist_params, pts) -> float:
    """Pick the largest displacement whose acceptance falls inside
    [0.15, 0.5]; all 16 candidates evaluated in one batched sweep
    (reference mc.cpp:288-331 walks them sequentially largest-first)."""
    accs = _displacement_sweep(key, dist_fn, dist_params, pts).cpu().numpy()
    ok = (accs > MIN_ACCEPT_RATIO) & (accs < MAX_ACCEPT_RATIO)
    for i in reversed(range(len(POSSIBLE_DISPLACEMENTS))):
        if ok[i]:
            return POSSIBLE_DISPLACEMENTS[i]
    # no candidate in window: fall back to the best-acceptance candidate
    return POSSIBLE_DISPLACEMENTS[int(np.argmin(np.abs(accs - 0.3)))]


def _autocorrelation_sweep(key, dist_fn, dist_params, pts, displacement):
    """Run the long tuning chain; return (autocorr (L/2,), cum_acc (L,))."""
    max_steps = pts.shape[-1] * 1000  # MaxNOMC, mc.cpp:206
    _, accepts, chain = markov_chain(key, dist_fn, dist_params, max_steps, pts, True,
                                     displacement)
    length = max_steps + 1
    centered = chain - torch.mean(chain, dim=0, keepdim=True)       # (L, M, D)
    # FFT autocorrelation over the step axis, sum_i c_i . c_{i+j}, in float32
    # like the JAX package (a tuning statistic, not an observable)
    nfft = 2 * length
    f = torch.fft.rfft(centered.to(torch.float32), n=nfft, dim=0)
    raw = torch.fft.irfft(f * torch.conj(f), n=nfft, dim=0)[:length].to(chain.dtype)
    raw = torch.sum(raw, dim=-1)                                    # dot over dims
    denom = length - torch.arange(length, dtype=chain.dtype, device=chain.device)
    ac = torch.mean(raw, dim=1) / denom                             # avg over walkers
    counts = torch.arange(1, max_steps + 1, dtype=torch.float32, device=chain.device)
    cum_acc = torch.cumsum(_accept_ratio(accepts, 1), dim=0) / counts
    return ac[: length // 2], cum_acc


def tune_steps(key, dist_fn, dist_params, pts, displacement) -> int:
    """Autocorrelation-based step count (reference mc.cpp:197-279): smallest
    lag whose |autocorr| is within 1.1x of the minimum, subject to the
    acceptance window, rounded up to a power of two."""
    ac, cum_acc = _autocorrelation_sweep(key, dist_fn, dist_params, pts, displacement)
    ac = np.abs(ac.cpu().numpy())
    cum_acc = cum_acc.cpu().numpy()
    length = ac.shape[0]
    min_start, min_step, min_val = 0, 0, 0.0
    for _ in range(64):
        min_start = min_step + 1
        if min_start >= length:
            min_start = 1
            min_step = int(np.argmin(ac))
            min_val = ac[min_step]
            break
        rel = int(np.argmin(ac[min_start:]))
        min_step = min_start + rel
        min_val = ac[min_step]
        acc = cum_acc[min(min_step, cum_acc.shape[0]) - 1]
        if MIN_ACCEPT_RATIO < acc < MAX_ACCEPT_RATIO:
            break
    for i_step in range(min_start, min_step):
        if ac[i_step] <= ABOVE_MIN_FACTOR * min_val:
            min_step = i_step
            break
    return _round_up_pow2(max(1, min_step))


def _probe_acceptance(key, dist_fn, dist_params, pts, n_steps, displacement):
    _, accepts, _ = markov_chain(key, dist_fn, dist_params, n_steps, pts, False,
                                 displacement)
    return _accept_ratio(accepts, tuple(range(accepts.dim())))


def element_monte_carlo(key, dist_fn, dist_params, pts, params: MCParameters, tune=True,
                        walk=None) -> Tuple[torch.Tensor, torch.Tensor, MCParameters]:
    """Tune then walk all points of one element (reference mc.cpp:339-374).

    ``tune``: True runs the full displacement + autocorrelation tuning, False
    reuses the stored parameters, "auto" probes the current displacement with
    a 100-step chain and re-tunes only when its acceptance left the window.
    ``walk``: optional (walk_fn, walk_params) Metropolis target for the tuning
    sweeps and the chains; the returned labels always come from ``dist_fn``.
    Returns (new_points, new_rho, updated MCParameters)."""
    walk_fn, walk_params = walk if walk is not None else (dist_fn, dist_params)
    k0, k1, k2, k3 = key.split(4)
    if tune == "auto":
        acc = float(_probe_acceptance(k0, walk_fn, walk_params, pts, 100,
                                      params.displacement))
        tune = not (MIN_ACCEPT_RATIO < acc < MAX_ACCEPT_RATIO)
    if tune:
        params.displacement = tune_displacement(k1, walk_fn, walk_params, pts)
        params.num_steps = tune_steps(k2, walk_fn, walk_params, pts, params.displacement)
    final, _, _ = markov_chain(k3, walk_fn, walk_params, params.num_steps, pts, False,
                               params.displacement)
    return final, dist_fn(dist_params, final), params


def jitter_points(key, pts, n_extra: int):
    """``n_extra`` points: the cloud's points in turn plus per-dimension
    N(0, std) noise (the unlabeled half of :func:`generate_extra_points_element`)."""
    n = pts.shape[0]
    std = torch.sqrt(torch.clamp(
        torch.mean(pts**2, dim=0) - torch.mean(pts, dim=0) ** 2, min=0.0))
    base = pts[torch.arange(n_extra, device=pts.device) % n]
    return base + key.normal(base.shape) * std


def generate_extra_points_element(key, pts, n_extra: int, dist_fn, dist_params):
    """Jitter existing points with per-dimension N(0, std) noise and label by
    the current distribution (reference mc.cpp:59-120)."""
    new_pts = jitter_points(key, pts, n_extra)
    return new_pts, dist_fn(dist_params, new_pts)


def seed_new_element(key, candidate_pts, num_points: int, dist_fn, dist_params,
                     params: MCParameters, walk=None):
    """Seed a newly-populated element (reference mc.cpp:407-537): evaluate the
    predicted density at every candidate coordinate, keep the ``num_points``
    with largest |rho| (ties in index order, as ``jax.lax.top_k``; zero-density
    picks are replaced by the best point), then random-walk them into place.
    ``walk`` stands in for ``dist_fn`` during the chains only."""
    score = ri.abs2(dist_fn(dist_params, candidate_pts))
    order = torch.sort(score, descending=True, stable=True).indices
    top_idx = order[:num_points]
    top_score = score[top_idx]
    chosen = torch.where((top_score > 0.0)[:, None], candidate_pts[top_idx],
                         candidate_pts[top_idx[0]])
    return element_monte_carlo(key, dist_fn, dist_params, chosen, params, tune=True,
                               walk=walk)
