"""PyTorch port: the Metropolis sampler against ``gple_tpu.sampler.mc``.

Random numbers reach the port through an explicit key object
(``gple_tpu_torch.sampler.keys``).  :class:`JaxKeys` here is a stand-in with
the same methods that computes every draw with ``jax.random`` from a JAX key,
so the port's chains see exactly the numbers the JAX chains see.  Limits:
walker positions 1e-12 absolute, the same accept masks and the same tuning
decisions; the float32 FFT autocorrelation 1e-5 relative to its largest
value (pocketfft in both packages here) and the float32 running acceptance
1e-5 (JAX sums it by a parallel prefix scan, torch in sequence).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gple_tpu import driver as JD
from gple_tpu.sampler import mc as jmc
from gple_tpu_torch import driver as TD
from gple_tpu_torch.sampler import mc
from gple_tpu_torch.sampler.keys import RandomKeys
from test_torch_kernels import _warm_torch_exp  # noqa: F401 (fixture)

TOL_POINTS = 1e-12
TOL_AC = 1e-5
M = 24
R0, SIGMA = (-10.0, 30.0), (1.0 / 3.0, 1.5)
POPS, PHASES = (1.0, 0.0), (0.0, 0.0)


class JaxKeys:
    """A JAX key array of shape ``batch + (2,)`` behind the port's key
    interface: every split and draw is ``jax.random``'s (vmapped over the
    batch), returned as CPU float64 tensors."""

    def __init__(self, key):
        self.key = jnp.asarray(key)

    @property
    def batch(self):
        return tuple(self.key.shape[:-1])

    def _flat(self):
        return self.key.reshape(-1, 2)

    def _split_flat(self, n):
        return jax.vmap(lambda k: jax.random.split(k, n))(self._flat())   # (F, n, 2)

    def split(self, n=2):
        sub = self._split_flat(n)
        return tuple(JaxKeys(sub[:, i].reshape(self.key.shape)) for i in range(n))

    def split_stack(self, n):
        return JaxKeys(self._split_flat(n).reshape(self.batch + (n, 2)))

    def _bound(self, v):
        v = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, dtype=float)
        return jnp.asarray(np.broadcast_to(v, self.batch).reshape(-1))

    def uniform(self, shape, low=0.0, high=1.0):
        shape = tuple(shape)
        out = jax.vmap(lambda k, a, b: jax.random.uniform(k, shape, jnp.float64, a, b))(
            self._flat(), self._bound(low), self._bound(high))
        return torch.from_numpy(np.array(out).reshape(self.batch + shape))

    def normal(self, shape):
        shape = tuple(shape)
        out = jax.vmap(lambda k: jax.random.normal(k, shape, jnp.float64))(self._flat())
        return torch.from_numpy(np.array(out).reshape(self.batch + shape))


def jax_init_params():
    return tuple(jnp.asarray(v, dtype=jnp.float64) for v in (R0, SIGMA, POPS, PHASES))


def torch_init_params():
    return tuple(torch.tensor(v, dtype=torch.float64) for v in (R0, SIGMA, POPS, PHASES))


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(11)
    return np.array(R0) + rng.normal(size=(M, 2)) * np.array(SIGMA) * 1.5


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize("record", [False, True])
def test_markov_chain_replays_jax(cloud, record):
    key = jax.random.PRNGKey(3)
    jf, jacc, jchain = jmc.markov_chain(key, JD.INIT_DIST_ELEMS[0], jax_init_params(), 40,
                                        jnp.asarray(cloud), record, 0.2)
    tf, tacc, tchain = mc.markov_chain(JaxKeys(key), TD.INIT_DIST_ELEMS[0],
                                       torch_init_params(), 40, t64(cloud), record, 0.2)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=TOL_POINTS)
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    assert 0 < tacc.sum() < tacc.numel()          # both outcomes occur
    if record:
        np.testing.assert_allclose(tchain.numpy(), np.asarray(jchain), rtol=0,
                                   atol=TOL_POINTS)
    else:
        assert tchain is None and jchain is None


def test_tune_displacement_replays_jax(cloud):
    key = jax.random.PRNGKey(5)
    pts = jnp.asarray(cloud)
    jaccs = np.asarray(jmc._displacement_sweep(key, JD.INIT_DIST_ELEMS[0],
                                               jax_init_params(), pts))
    taccs = mc._displacement_sweep(JaxKeys(key), TD.INIT_DIST_ELEMS[0], torch_init_params(),
                                   t64(cloud)).numpy()
    np.testing.assert_array_equal(taccs, jaccs)     # float32 counts / total, exact
    jd = jmc.tune_displacement(key, JD.INIT_DIST_ELEMS[0], jax_init_params(), pts)
    td = mc.tune_displacement(JaxKeys(key), TD.INIT_DIST_ELEMS[0], torch_init_params(),
                              t64(cloud))
    assert td == jd


def test_tune_steps_replays_jax(cloud):
    key = jax.random.PRNGKey(6)
    pts = jnp.asarray(cloud)
    jac, jcum = jmc._autocorrelation_sweep(key, JD.INIT_DIST_ELEMS[0], jax_init_params(),
                                           pts, 0.5)
    tac, tcum = mc._autocorrelation_sweep(JaxKeys(key), TD.INIT_DIST_ELEMS[0],
                                          torch_init_params(), t64(cloud), 0.5)
    jac = np.asarray(jac)
    np.testing.assert_allclose(tac.numpy(), jac, rtol=0, atol=TOL_AC * np.abs(jac).max())
    np.testing.assert_allclose(tcum.numpy(), np.asarray(jcum), rtol=0, atol=TOL_AC)
    js = jmc.tune_steps(key, JD.INIT_DIST_ELEMS[0], jax_init_params(), pts, 0.5)
    ts = mc.tune_steps(JaxKeys(key), TD.INIT_DIST_ELEMS[0], torch_init_params(),
                       t64(cloud), 0.5)
    assert ts == js


def test_generate_extra_points_replays_jax(cloud):
    key = jax.random.PRNGKey(8)
    jp, jr = jmc.generate_extra_points_element(key, jnp.asarray(cloud), 5 * M,
                                               JD.INIT_DIST_ELEMS[0], jax_init_params())
    tp, tr = mc.generate_extra_points_element(JaxKeys(key), t64(cloud), 5 * M,
                                              TD.INIT_DIST_ELEMS[0], torch_init_params())
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=TOL_POINTS)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-12)


def test_seed_new_element_ties_and_walk_replay_jax(cloud):
    """Candidates with tied scores (duplicated points) and zero scores (far
    off the Gaussian): the port keeps JAX's top_k order, then tunes and walks
    to the same points and parameters."""
    far = np.array(R0) + np.array([60.0, 0.0])
    cands = np.concatenate([cloud[:10], cloud[:10], cloud[10:], np.tile(far, (8, 1))])
    key = jax.random.PRNGKey(9)
    jp, jr, jparams = jmc.seed_new_element(key, jnp.asarray(cands), M,
                                           JD.INIT_DIST_ELEMS[0], jax_init_params(),
                                           jmc.MCParameters())
    tp, tr, tparams = mc.seed_new_element(JaxKeys(key), t64(cands), M,
                                          TD.INIT_DIST_ELEMS[0], torch_init_params(),
                                          mc.MCParameters())
    assert (tparams.num_steps, tparams.displacement) == (jparams.num_steps,
                                                         jparams.displacement)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=TOL_POINTS)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-12)


def test_seed_choice_orders_ties_by_index(monkeypatch):
    """The top-|rho| choice alone: equal scores keep index order, zero scores
    become the best point (the contract of jax.lax.top_k)."""
    score_pts = torch.tensor([[0.0, 0.0], [1.0, 0.0], [0.0, 0.0], [9.0, 9.0], [1.0, 0.0]],
                             dtype=torch.float64)
    seen = {}

    def dist(_, pts):
        value = torch.where(pts[:, 0] > 5.0, 0.0, 1.0 + pts[:, 0])
        return torch.stack([value, torch.zeros_like(value)], -1)

    def fake_walk(key, dist_fn, dist_params, chosen, params, tune, walk):
        seen["chosen"] = chosen
        return chosen, dist_fn(dist_params, chosen), params

    monkeypatch.setattr(mc, "element_monte_carlo", fake_walk)
    mc.seed_new_element(None, score_pts, 5, dist, None, mc.MCParameters())
    # scores 1, 2, 1, 0, 2 -> indices 1, 4, 0, 2, then the zero-score point 3 -> best (1)
    np.testing.assert_array_equal(seen["chosen"].numpy(),
                                  score_pts[[1, 4, 0, 2, 1]].numpy())


@pytest.mark.parametrize("tune", ["auto", False])
def test_element_monte_carlo_modes_replay_jax(cloud, tune):
    key = jax.random.PRNGKey(12)
    start = dict(num_steps=16, displacement=0.05)
    jp, jr, jparams = jmc.element_monte_carlo(key, JD.INIT_DIST_ELEMS[0], jax_init_params(),
                                              jnp.asarray(cloud), jmc.MCParameters(**start),
                                              tune=tune)
    tp, tr, tparams = mc.element_monte_carlo(JaxKeys(key), TD.INIT_DIST_ELEMS[0],
                                             torch_init_params(), t64(cloud),
                                             mc.MCParameters(**start), tune=tune)
    assert (tparams.num_steps, tparams.displacement) == (jparams.num_steps,
                                                         jparams.displacement)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=TOL_POINTS)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-12)


def test_round_up_pow2_matches_jax():
    for n in (0, 1, 2, 3, 5, 64, 65, 1000):
        assert mc._round_up_pow2(n) == jmc._round_up_pow2(n)


def test_random_keys_are_deterministic_and_split_apart():
    a, b = RandomKeys(7, "cpu"), RandomKeys(7, "cpu")
    assert torch.equal(a.uniform((5,)), b.uniform((5,)))
    k1, k2 = a.split(2)
    assert not torch.equal(k1.normal((5,)), k2.normal((5,)))
    assert not torch.equal(k1.normal((5,)), a.split_stack(2).normal((5,))[0])
    stacked = a.split_stack(3)
    assert stacked.batch == (3,)
    lo = torch.tensor([0.0, 10.0, 20.0], dtype=torch.float64)
    u = stacked.uniform((4, 2), low=lo, high=lo + 1.0)
    assert u.shape == (3, 4, 2) and u.dtype == torch.float64
    assert torch.all((u >= lo[:, None, None]) & (u < lo[:, None, None] + 1.0))
    assert not torch.equal(RandomKeys(8, "cpu").uniform((5,)), a.uniform((5,)))
