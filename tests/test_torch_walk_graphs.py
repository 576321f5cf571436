"""PyTorch port: the Metropolis chains as blocks of captured graphs.

``gple_tpu_torch.sampler.mc`` runs a chain as replays of per-block graphs
(``CHAIN_BLOCK`` steps, then a power of two for each set bit of the
remainder) over a static state; on the CPU the same block functions run
eagerly.  Checked here, with one intra-op thread:

* the block route equals the straight loop (``chains=None``) bit for
  bit, at 1, 2, 100, 1,000 and 2,000 steps, with and without ``record``, and
  batched x16 as the displacement sweep runs it;
* the functions a graph captures make no host-to-device copy
  (``aten.lift_fresh``) and no host pull (``aten._local_scalar_dense``) for
  the initial distribution, the walk surrogate and an exact GP predictor;
* the tuned and ``"auto"`` walks and the seeding walk through one
  :class:`Chains` replay ``gple_tpu.sampler.mc`` on the same ``jax.random``
  draws (``JaxKeys``), and a second walk adds no program;
* (on the card the graphed walk is held to the eager one by
  ``tests/test_torch_graphs.py``, which imports no JAX).
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gple_tpu import driver as JD
from gple_tpu.sampler import mc as jmc
from gple_tpu_torch import driver as TD
from gple_tpu_torch.entry import crossing_config, example_state
from gple_tpu_torch.ops import graphs as GR
from gple_tpu_torch.sampler import mc
from gple_tpu_torch.sampler.keys import RandomKeys
from test_torch_kernels import _warm_torch_exp, one_torch_thread  # noqa: F401 (fixtures)
from test_torch_mc import R0, SIGMA, JaxKeys, jax_init_params, t64, torch_init_params

M = 8
TOL_POINTS = 1e-12          # test_torch_mc.py's: walker positions against JAX's
FORBIDDEN = ("aten.lift_fresh", "aten._local_scalar_dense")




def _cloud(seed, m=M):
    rng = np.random.default_rng(seed)
    return np.array(R0) + rng.normal(size=(m, 2)) * np.array(SIGMA) * 1.5


def _surrogate(device="cpu"):
    """A walk surrogate like ``driver._walk_surrogate``'s: a smooth bump on
    a 256^2 grid over the cloud's doubled box."""
    lo = torch.tensor([R0[0] - 2.0, R0[1] - 8.0], dtype=torch.float64, device=device)
    hi = torch.tensor([R0[0] + 2.0, R0[1] + 8.0], dtype=torch.float64, device=device)
    xs = torch.linspace(-1.0, 1.0, TD._SURR_RES, dtype=torch.float64, device=device)
    grid = torch.exp(-4.0 * (xs[:, None] ** 2 + xs[None, :] ** 2))
    return TD._surrogate_dist, (grid, lo, hi)


def _both(fn):
    """``fn(chains)`` through the straight loop and through the graph route."""
    chains = mc.Chains()
    return fn(None), fn(chains), chains


def _assert_equal(a, b):
    for x, y in zip(GR.leaves(a), GR.leaves(b)):
        assert x.shape == y.shape and torch.equal(x, y)


@pytest.mark.parametrize("record", [False, True])
@pytest.mark.parametrize("n_steps", [1, 2, 100, 1000, 2000])
def test_block_route_equals_the_straight_loop(n_steps, record):
    dist_fn, params = _surrogate()
    pts = t64(_cloud(n_steps))
    key = RandomKeys(n_steps, "cpu")
    loop, blocks, chains = _both(
        lambda chains: mc.markov_chain(key, dist_fn, params, n_steps, pts, record, 0.3,
                                       chains))
    _assert_equal(loop, blocks)
    assert (blocks[2] is None) == (not record)
    if n_steps >= 100:
        assert 0 < blocks[1].sum() < blocks[1].numel()      # both outcomes occur
    (program,) = chains.programs.values()
    assert sorted(program.blocks) == sorted(set(mc._blocks(n_steps)))
    assert sum(mc._blocks(n_steps)) == n_steps


@pytest.mark.parametrize("record,n_steps", [(False, 1000), (True, 100)])
def test_batched_block_route_equals_the_straight_loop(record, n_steps):
    """16 chains on a leading axis, each with its own displacement, as
    ``_displacement_sweep`` runs them."""
    dist_fn, params = TD.INIT_DIST_ELEMS[0], torch_init_params()
    pts = t64(_cloud(3))
    batch = len(mc.POSSIBLE_DISPLACEMENTS)
    disps = torch.tensor(mc.POSSIBLE_DISPLACEMENTS, dtype=torch.float64)
    key = RandomKeys(4, "cpu").split_stack(batch)
    loop, blocks, _ = _both(lambda chains: mc.markov_chain(
        key, dist_fn, params, n_steps, pts.expand((batch,) + pts.shape), record, disps,
        chains))
    _assert_equal(loop, blocks)
    assert blocks[1].shape == (batch, n_steps, M)
    assert len(set(mc._accept_ratio(blocks[1], (1, 2)).tolist())) > 2


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(str(func))
        return func(*args, **(kwargs or {}))


def _exact_predictor():
    """``GPLEDriver._new_pt_dists[1]`` (the coherence's backward-branching
    predictor, the walk target with ``mc_walk_surrogate=False``) on a fitted
    example state."""
    density, gps = example_state(16, "cpu", torch.Generator().manual_seed(2))
    drv = TD.GPLEDriver(crossing_config(), device="cpu")
    return drv._new_pt_dists[1], gps, density.points[1]


@pytest.mark.parametrize("dist", ["initial", "surrogate", "exact"])
def test_captured_functions_copy_and_pull_nothing(dist):
    if dist == "initial":
        dist_fn, params, pts = TD.INIT_DIST_ELEMS[0], torch_init_params(), t64(_cloud(5))
    elif dist == "surrogate":
        (dist_fn, params), pts = _surrogate(), t64(_cloud(5))
    else:
        dist_fn, params, pts = _exact_predictor()
    program = mc._ChainProgram(dist_fn, params, pts, record=True)
    S = program.S
    GR.copy_(S.params, params)
    S.cur.copy_(pts)
    S.steps.uniform_(-0.1, 0.1)
    S.draws.uniform_()
    ops = _Ops()
    with torch.inference_mode():
        # a capture runs its function once first (evolve's cached tables are
        # made then), and records the second run
        for mode in (torch.inference_mode(), ops):
            with mode:
                mc._chain_start(S, dist_fn)
                mc._chain_block(S, dist_fn, 3, True)
    assert ops.names and not [n for n in ops.names if any(f in n for f in FORBIDDEN)]
    assert torch.all(torch.isfinite(S.chain[:3])) and S.accepts[:3].any()


def test_a_dropped_driver_frees_its_walk_graphs_at_once():
    """The driver's chain cache keeps the predictors it walked; they hold no
    reference back to the driver, so dropping the driver frees its graphs
    (and their device memory) without waiting for the garbage collector."""
    dist_fn, gps, pts = _exact_predictor()
    drv = TD.GPLEDriver(crossing_config(), device="cpu")
    drv._chains.labels(drv._new_pt_dists[1], gps, pts)
    ref = weakref.ref(drv)
    gc.disable()
    try:
        del drv
        assert ref() is None
    finally:
        gc.enable()


def test_chain_parameters_must_be_tensors():
    with pytest.raises(TypeError):
        mc.Chains().program(TD._surrogate_dist, (1.0,), torch.zeros(4, 2), False)


@pytest.fixture(scope="module")
def cloud():
    return _cloud(11, 24)


@pytest.mark.parametrize("tune", [True, "auto"])
def test_element_walks_replay_jax_through_the_graphs(cloud, tune):
    """The tuned walk, then an ``"auto"`` walk from its parameters, through
    one :class:`Chains`, against ``gple_tpu.sampler.mc`` on the same draws;
    the second walk of the same target reuses the first one's programs."""
    key = jax.random.PRNGKey(21)
    jparams, tparams = jmc.MCParameters(), mc.MCParameters()
    jpts, tpts = jnp.asarray(cloud), t64(cloud)
    chains = mc.Chains()
    for k in jax.random.split(key, 2):
        jp, jr, jparams = jmc.element_monte_carlo(
            k, JD.INIT_DIST_ELEMS[0], jax_init_params(), jpts, jparams, tune=tune)
        tp, tr, tparams = mc.element_monte_carlo(
            JaxKeys(k), TD.INIT_DIST_ELEMS[0], torch_init_params(), tpts, tparams,
            tune=tune, chains=chains)
        assert (tparams.num_steps, tparams.displacement) == (jparams.num_steps,
                                                             jparams.displacement)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=TOL_POINTS)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-12)
        if tune is True:
            # the sweep, the recorded chain, the walk, the labels
            assert len(chains.programs) == 4
        n_programs = len(chains.programs)
        jpts, tpts = jp, tp
    assert len(chains.programs) == n_programs


def test_seeding_walk_replays_jax_through_the_graphs(cloud):
    key = jax.random.PRNGKey(22)
    cands = np.concatenate([cloud, cloud[:6] + 0.01])
    jp, jr, jparams = jmc.seed_new_element(key, jnp.asarray(cands), M, JD.INIT_DIST_ELEMS[0],
                                           jax_init_params(), jmc.MCParameters())
    chains = mc.Chains()
    tp, tr, tparams = mc.seed_new_element(JaxKeys(key), t64(cands), M, TD.INIT_DIST_ELEMS[0],
                                          torch_init_params(), mc.MCParameters(),
                                          chains=chains)
    assert len(chains.programs) == 4
    assert (tparams.num_steps, tparams.displacement) == (jparams.num_steps,
                                                         jparams.displacement)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=TOL_POINTS)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-12)
