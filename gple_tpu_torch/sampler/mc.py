"""Metropolis phase-space sampler (counterpart of :mod:`gple_tpu.sampler.mc`).

* initial Gaussian phase-space distribution             -- ``mc.cpp:30-50``
* Metropolis Markov chains, all walkers in one step     -- ``mc.cpp:143-188``
* displacement tuning over a log grid of 16 candidates  -- ``mc.cpp:288-331``
* autocorrelation-based step-count tuning               -- ``mc.cpp:197-279``
* extra-point jittering                                 -- ``mc.cpp:59-120``
* new-element point seeding                             -- ``mc.cpp:407-537``

Distribution functions follow ``dist_fn(dist_params, pts (M, PhaseDim)) ->
(M, 2) RI``.  A chain step evaluates the distribution once for every walker;
the 16 displacement candidates ride on a leading axis (the JAX package's
``vmap``) and are evaluated in the same call.  Random numbers come from the
``key`` argument (:mod:`.keys`), split where the JAX package splits its key;
a chain draws all its steps' proposals and acceptance numbers up front.  As
in the JAX package, acceptance ratios are float32 (``jnp.mean`` of a bool
array) and the autocorrelation FFT runs in float32.

Chains as graphs.  The JAX package compiles each chain into one ``lax.scan``
program.  Here a chain runs in blocks of steps: :func:`_chain_block` advances
the walkers ``n`` steps on a static state (:class:`_ChainState`), and a
:class:`Chains` cache keeps, per static key (the distribution function, the
shapes of its parameters and walkers, the batch, ``record``), one
:class:`gple_tpu_torch.ops.graphs.Graph` of it for each block length it has
met: ``CHAIN_BLOCK`` steps, and one power of two below it for each set bit
of a chain's remainder.  On a CUDA device each graph is captured at its first
call and replayed after it, so a 2,000-step chain is ~33 host launches of
graphs instead of ~10^5 of single ops; on the CPU the same function runs
eagerly.  Before each block the host copies its draws into the state and,
after it, the block's accept mask (and positions, with ``record``) out; a
walk's labels at its final points are one more graph of the same cache.
Results equal the straight loop (:func:`_chain_loop`) bit for bit: the same
ops on the same draws.  Every chain function takes a ``chains`` argument:
a :class:`Chains` runs the chain as its blocks' graphs (the driver passes
the one it keeps for its run), ``None`` runs the straight loop, one host
launch an op (the baseline the graphs are held to).  The graphs' kind is
``walk`` in their spans; the host reads of the tuning's results are ``wait``
spans (:mod:`gple_tpu_torch.utils.spans`).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gple_tpu_torch.ops import graphs as GR
from gple_tpu_torch.utils import ri, spans

#: Metropolis acceptance-ratio window (mc.cpp:19-21)
MAX_ACCEPT_RATIO = 0.5
MIN_ACCEPT_RATIO = 0.15
#: candidate maximum displacements (mc.cpp:298)
POSSIBLE_DISPLACEMENTS = (
    1e-4, 2e-4, 5e-4, 1e-3, 2e-3, 5e-3, 0.01, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0,
)
#: choose the minimal step whose |autocorr| < factor * min|autocorr| (mc.h:55)
ABOVE_MIN_FACTOR = 1.1
#: steps of a chain's longest captured block (a power of two)
CHAIN_BLOCK = 64


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


class _ChainState(NamedTuple):
    """The static tensors a chain's graphs read and write."""

    params: object              # the distribution's parameters, copied in per chain
    cur: torch.Tensor           # (*batch, M, D) the walkers
    w_cur: torch.Tensor         # (*batch, M) |dist| at the walkers
    steps: torch.Tensor         # (*batch, CHAIN_BLOCK, M, D) a block's proposal steps
    draws: torch.Tensor         # (*batch, CHAIN_BLOCK, M) a block's acceptance numbers
    accepts: torch.Tensor       # (*batch, CHAIN_BLOCK, M) bool, a block's accept mask
    chain: Optional[torch.Tensor]   # (*batch, CHAIN_BLOCK, M, D) positions (record)


def _chain_start(S: _ChainState, dist_fn) -> None:
    """|dist| at the walkers, the weights a chain starts from."""
    S.w_cur.copy_(_weights(dist_fn, S.params, S.cur))


def _chain_block(S: _ChainState, dist_fn, n: int, record: bool) -> None:
    """``n`` Metropolis steps of every walker on ``S`` in place, with the
    block's first ``n`` draws: the body of a chain's graph of length ``n``."""
    nb = S.cur.dim() - 2
    cur, w_cur = S.cur, S.w_cur
    accepts, chain = [], []
    for i in range(n):
        prop = cur + S.steps.select(nb, i)
        w_new = _weights(dist_fn, S.params, prop)
        accept = (w_new > w_cur) | (w_new > S.draws.select(nb, i) * w_cur)
        cur = torch.where(accept[..., None], prop, cur)
        w_cur = torch.where(accept, w_new, w_cur)
        accepts.append(accept)
        if record:
            chain.append(cur)
    S.accepts.narrow(nb, 0, n).copy_(torch.stack(accepts, dim=nb))
    if record:
        S.chain.narrow(nb, 0, n).copy_(torch.stack(chain, dim=nb))
    S.cur.copy_(cur)
    S.w_cur.copy_(w_cur)


def _blocks(n_steps: int) -> list:
    """Block lengths of an ``n_steps`` chain: whole ``CHAIN_BLOCK`` blocks,
    then the remainder's set bits, largest first."""
    full, rest = divmod(n_steps, CHAIN_BLOCK)
    return [CHAIN_BLOCK] * full + [1 << b for b in reversed(range(CHAIN_BLOCK.bit_length()))
                                   if rest >> b & 1]


def _signature(tree):
    """The static part of a parameter tree: its types and its tensors'
    shapes, dtypes and devices.  A parameter that is not a tensor would be
    frozen into a captured graph, so it is refused."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__,) + tuple(_signature(t) for t in tree)
    if tree is None:
        return None
    raise TypeError(f"a chain's distribution parameters must be tensors, not "
                    f"{type(tree).__name__}")


class _ChainProgram:
    """The static state and the graphs of one static key."""

    def __init__(self, dist_fn, dist_params, pts, record: bool):
        batch, (m, d) = tuple(pts.shape[:-2]), tuple(pts.shape[-2:])
        like = dict(dtype=pts.dtype, device=pts.device)
        block = batch + (CHAIN_BLOCK, m)
        self.S = _ChainState(
            params=GR.clone(dist_params), cur=torch.zeros(pts.shape, **like),
            w_cur=torch.zeros(batch + (m,), **like), steps=torch.zeros(block + (d,), **like),
            draws=torch.zeros(block, **like),
            accepts=torch.zeros(block, dtype=torch.bool, device=pts.device),
            chain=torch.zeros(block + (d,), **like) if record else None)
        self.dist_fn, self.record = dist_fn, record
        self.start = GR.Graph(partial(_chain_start, self.S, dist_fn), self.S, "walk")
        #: block length -> its graph, made at the first chain that needs it
        self.blocks = {}

    def graphs(self) -> list:
        return [self.start, *self.blocks.values()]

    def run(self, dist_params, pts, steps, draws, n_steps: int):
        S, record = self.S, self.record
        nb = S.cur.dim() - 2
        GR.copy_(S.params, dist_params)
        S.cur.copy_(pts)
        self.start()
        accepts = torch.empty(pts.shape[:nb] + (n_steps,) + pts.shape[nb:-1],
                              dtype=torch.bool, device=pts.device)
        chain = None
        if record:
            chain = torch.empty(pts.shape[:nb] + (n_steps + 1,) + pts.shape[nb:],
                                dtype=pts.dtype, device=pts.device)
            chain.select(nb, 0).copy_(pts)
        at = 0
        for n in _blocks(n_steps):
            if n not in self.blocks:
                self.blocks[n] = GR.Graph(partial(_chain_block, S, self.dist_fn, n, record), S,
                                          "walk")
            S.steps.narrow(nb, 0, n).copy_(steps.narrow(nb, at, n))
            S.draws.narrow(nb, 0, n).copy_(draws.narrow(nb, at, n))
            self.blocks[n]()
            accepts.narrow(nb, at, n).copy_(S.accepts.narrow(nb, 0, n))
            if record:
                chain.narrow(nb, at + 1, n).copy_(S.chain.narrow(nb, 0, n))
            at += n
        return S.cur.clone(), accepts, chain


def _label(S, dist_fn) -> None:
    """The distribution at the points ``S[1]`` into ``S[2]``: the body of a
    walk's labelling graph."""
    params, pts, out = S
    out.copy_(dist_fn(params, pts))


class _LabelProgram:
    """The static state and the graph of one labelling key."""

    def __init__(self, dist_fn, dist_params, pts):
        self.S = (GR.clone(dist_params), torch.zeros_like(pts),
                  torch.zeros(pts.shape[:-1] + (2,), dtype=pts.dtype, device=pts.device))
        self.graph = GR.Graph(partial(_label, self.S, dist_fn), self.S, "walk")

    def graphs(self) -> list:
        return [self.graph]

    def run(self, dist_params, pts):
        params, static_pts, out = self.S
        GR.copy_(params, dist_params)
        static_pts.copy_(pts)
        self.graph()
        return out.clone()


class Chains:
    """A cache of chain programs (static state and graphs) by static key:
    the distribution function, its parameters' shapes, the walkers' shape
    (batch included) and ``record``.  The driver keeps one for its run, so
    its walks of the same distribution at the same shapes replay the graphs
    captured by the first."""

    def __init__(self):
        self.programs = {}

    def program(self, dist_fn, dist_params, pts, record: bool) -> _ChainProgram:
        key = (dist_fn, _signature(dist_params), tuple(pts.shape), pts.dtype, pts.device,
               bool(record))
        if key not in self.programs:
            self.programs[key] = _ChainProgram(dist_fn, dist_params, pts, record)
        return self.programs[key]

    def labels(self, dist_fn, dist_params, pts):
        """``dist_fn(dist_params, pts)``, a walk's labels, as one graph replay."""
        key = ("labels", dist_fn, _signature(dist_params), tuple(pts.shape), pts.dtype,
               pts.device)
        if key not in self.programs:
            self.programs[key] = _LabelProgram(dist_fn, dist_params, pts)
        return self.programs[key].run(dist_params, pts)

    def graphs(self) -> list:
        return [g for p in self.programs.values() for g in p.graphs()]

    @property
    def pool_bytes(self) -> int:
        """Device memory the graphs' private pools reserved (0 on the CPU)."""
        return sum(g.pool_bytes for g in self.graphs())


def markov_chain(key, dist_fn, dist_params, n_steps: int, pts, record: bool,
                 displacement, chains: Optional[Chains] = None):
    """Advance all walkers ``n_steps`` Metropolis steps simultaneously.

    ``pts`` is (*key.batch, M, PhaseDim); ``displacement`` a number or a
    tensor of the key's batch shape.  Returns ``(final_pts, accept_mask
    (*batch, n_steps, M), chain or None)`` where ``chain`` is the recorded
    (*batch, n_steps + 1, M, PhaseDim) positions when ``record``.  Runs as
    blocks of ``chains``, or as the straight loop without it (module
    docstring)."""
    k1, k2 = key.split_stack(n_steps).split(2)
    if isinstance(displacement, torch.Tensor):
        displacement = displacement[..., None]         # against the step axis
    steps = k1.uniform(pts.shape[-2:], low=-displacement, high=displacement)
    draws = k2.uniform(pts.shape[-2:-1])
    if chains is None:
        return _chain_loop(dist_fn, dist_params, n_steps, pts, record, steps, draws)
    return chains.program(dist_fn, dist_params, pts, record).run(
        dist_params, pts, steps, draws, n_steps)


def _chain_loop(dist_fn, dist_params, n_steps: int, pts, record: bool, steps, draws):
    """:func:`markov_chain` as one straight loop over its draws: one host
    launch an op, the plain version the chain's graphs are held to."""
    nb = pts.dim() - 2
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


def _displacement_sweep(key, dist_fn, dist_params, pts, chains=None):
    """Acceptance ratio of each candidate displacement, all 16 chains batched."""
    n_steps = pts.shape[-1] * 500  # mc.cpp:297
    with spans.span("wait"):
        disps = torch.tensor(POSSIBLE_DISPLACEMENTS, dtype=pts.dtype, device=pts.device)
    batch = len(POSSIBLE_DISPLACEMENTS)
    _, accepts, _ = markov_chain(key.split_stack(batch), dist_fn, dist_params, n_steps,
                                 pts.expand((batch,) + pts.shape), False, disps, chains)
    return _accept_ratio(accepts, (1, 2))


def tune_displacement(key, dist_fn, dist_params, pts, chains=None) -> float:
    """Pick the largest displacement whose acceptance falls inside
    [0.15, 0.5]; all 16 candidates evaluated in one batched sweep
    (reference mc.cpp:288-331 walks them sequentially largest-first)."""
    accs = _displacement_sweep(key, dist_fn, dist_params, pts, chains)
    with spans.span("wait"):
        accs = accs.cpu().numpy()
    ok = (accs > MIN_ACCEPT_RATIO) & (accs < MAX_ACCEPT_RATIO)
    for i in reversed(range(len(POSSIBLE_DISPLACEMENTS))):
        if ok[i]:
            return POSSIBLE_DISPLACEMENTS[i]
    # no candidate in window: fall back to the best-acceptance candidate
    return POSSIBLE_DISPLACEMENTS[int(np.argmin(np.abs(accs - 0.3)))]


def _autocorrelation_sweep(key, dist_fn, dist_params, pts, displacement, chains=None):
    """Run the long tuning chain; return (autocorr (L/2,), cum_acc (L,))."""
    max_steps = pts.shape[-1] * 1000  # MaxNOMC, mc.cpp:206
    _, accepts, chain = markov_chain(key, dist_fn, dist_params, max_steps, pts, True,
                                     displacement, chains)
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


def tune_steps(key, dist_fn, dist_params, pts, displacement, chains=None) -> int:
    """Autocorrelation-based step count (reference mc.cpp:197-279): smallest
    lag whose |autocorr| is within 1.1x of the minimum, subject to the
    acceptance window, rounded up to a power of two."""
    ac, cum_acc = _autocorrelation_sweep(key, dist_fn, dist_params, pts, displacement,
                                         chains)
    with spans.span("wait"):
        ac, cum_acc = np.abs(ac.cpu().numpy()), cum_acc.cpu().numpy()
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


def _probe_acceptance(key, dist_fn, dist_params, pts, n_steps, displacement, chains=None):
    _, accepts, _ = markov_chain(key, dist_fn, dist_params, n_steps, pts, False,
                                 displacement, chains)
    return _accept_ratio(accepts, tuple(range(accepts.dim())))


def element_monte_carlo(key, dist_fn, dist_params, pts, params: MCParameters, tune=True,
                        walk=None, chains: Optional[Chains] = None,
                        ) -> Tuple[torch.Tensor, torch.Tensor, MCParameters]:
    """Tune then walk all points of one element (reference mc.cpp:339-374).

    ``tune``: True runs the full displacement + autocorrelation tuning, False
    reuses the stored parameters, "auto" probes the current displacement with
    a 100-step chain and re-tunes only when its acceptance left the window.
    ``walk``: optional (walk_fn, walk_params) Metropolis target for the tuning
    sweeps and the chains; the returned labels always come from ``dist_fn``.
    ``chains``: the :class:`Chains` whose graphs run the chains and the
    labels, or None for the straight loop and call.
    Returns (new_points, new_rho, updated MCParameters).  The probe and the
    final chain share their graphs (the same static key); the labels are one
    more graph."""
    walk_fn, walk_params = walk if walk is not None else (dist_fn, dist_params)
    k0, k1, k2, k3 = key.split(4)
    if tune == "auto":
        acc = _probe_acceptance(k0, walk_fn, walk_params, pts, 100, params.displacement,
                                chains)
        with spans.span("wait"):
            acc = float(acc)
        tune = not (MIN_ACCEPT_RATIO < acc < MAX_ACCEPT_RATIO)
    if tune:
        params.displacement = tune_displacement(k1, walk_fn, walk_params, pts, chains)
        params.num_steps = tune_steps(k2, walk_fn, walk_params, pts, params.displacement,
                                      chains)
    final, _, _ = markov_chain(k3, walk_fn, walk_params, params.num_steps, pts, False,
                               params.displacement, chains)
    if chains is None:
        return final, dist_fn(dist_params, final), params
    return final, chains.labels(dist_fn, dist_params, final), params


def jitter_points(key, pts, n_extra: int):
    """``n_extra`` points: the cloud's points in turn plus per-dimension
    N(0, std) noise (the unlabeled half of :func:`generate_extra_points_element`)."""
    return jitter_with(key.normal((n_extra, pts.shape[-1])), pts)


def jitter_with(noise, pts):
    """:func:`jitter_points` with its standard normal draws ``noise``
    (n_extra, D) made beforehand, as a CUDA graph needs them: no draw is made
    here."""
    n = pts.shape[0]
    std = torch.sqrt(torch.clamp(
        torch.mean(pts**2, dim=0) - torch.mean(pts, dim=0) ** 2, min=0.0))
    base = pts[torch.arange(noise.shape[0], device=pts.device) % n]
    return base + noise * std


def generate_extra_points_element(key, pts, n_extra: int, dist_fn, dist_params):
    """Jitter existing points with per-dimension N(0, std) noise and label by
    the current distribution (reference mc.cpp:59-120)."""
    new_pts = jitter_points(key, pts, n_extra)
    return new_pts, dist_fn(dist_params, new_pts)


def seed_new_element(key, candidate_pts, num_points: int, dist_fn, dist_params,
                     params: MCParameters, walk=None, chains: Optional[Chains] = None):
    """Seed a newly-populated element (reference mc.cpp:407-537): evaluate the
    predicted density at every candidate coordinate, keep the ``num_points``
    with largest |rho| (ties in index order, as ``jax.lax.top_k``; zero-density
    picks are replaced by the best point), then random-walk them into place.
    ``walk`` stands in for ``dist_fn`` during the chains only; ``chains`` as
    in :func:`element_monte_carlo`."""
    score = ri.abs2(dist_fn(dist_params, candidate_pts))
    order = torch.sort(score, descending=True, stable=True).indices
    top_idx = order[:num_points]
    top_score = score[top_idx]
    chosen = torch.where((top_score > 0.0)[:, None], candidate_pts[top_idx],
                         candidate_pts[top_idx[:1]])     # not [0]: a host pull
    # the straight route passes no ``chains``, so a stand-in walk need not take it
    graphed = {} if chains is None else {"chains": chains}
    return element_monte_carlo(key, dist_fn, dist_params, chosen, params, tune=True,
                               walk=walk, **graphed)
