"""PyTorch port: the driver's default-off flags against ``gple_tpu``.

Case for case the checks of ``tests/test_coh_boost.py``,
``tests/test_coh_rescale.py`` and ``tests/test_relabel.py``, each on a JAX
driver and the port's driver carried from it (``convert.driver_to_torch``,
random draws replayed from the JAX key by ``JaxKeys``), both doing the same
thing; the port must take the same decisions (stats, factors, accepted and
rejected relabels) and reach the same state: points 1e-12, labels 1e-8
absolute, factors 1e-10 relative.

* the booster (``coh_fit_extra``): the coherence fit carries N + k points and
  is capped at the extra cloud; a window of ticks with every flag on
  (booster at divisor 6, coherence-only cutoff, per-tick tracking of the
  coherence, both conservation rescales, the relabel rules) in step with
  JAX's; the reference's divergence (a seed whose (1, 1) activates a tick
  after (1, 0)) reached at the same tick; the port's own initialization
  with the booster;
* the rescales: the coherence purity rescale is a no-op within budget and
  clamps an inflated coherence; the population rescale pins the diagonal sum
  and skips an out-of-band factor;
* the relabel: the scale band, sign and nascent rules of ``_relabel_scale``;
  a forced re-selection of every element with ``relabel_conserve``; the
  masked diagonal relabel; the frozen coherence cloud (``coh_reselect``
  off); the fit-health backoff to divisor 2 and the booster's eject;
* a boosted checkpoint from JAX into the port and back;
* ``KernelParams.to_flat`` / ``from_flat``.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gple_tpu.driver as JD
import gple_tpu_torch.driver as TD
from gple_tpu import observables as JOBS
from gple_tpu.config import GPLEConfig as JGPLEConfig
from gple_tpu.io import checkpoint as jckpt
from gple_tpu.ops import kernels as JRK
from gple_tpu.storage import DIAG_INDICES, OFFDIAG_INDEX
from gple_tpu_torch import convert
from gple_tpu_torch.config import GPLEConfig
from gple_tpu_torch.io import checkpoint as ckpt
from gple_tpu_torch.ops import kernels as RK
from test_torch_kernels import _warm_torch_exp, one_torch_thread  # noqa: F401 (fixtures)
from test_torch_mc import JaxKeys

TOL_POINTS, TOL_RHO = 1e-12, 1e-8
CROSSING = dict(model="SAC", mass=2000.0, x0=-2.0, p0=20.0, sigma_p0=1.0, output_time=2.0,
                reopt_time=2.0, dt=1.0, fused_chunk=0)


def host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def same_state(td, jd, what=""):
    for cloud in ("density", "extra"):
        ours, theirs = getattr(td, cloud), getattr(jd, cloud)
        np.testing.assert_allclose(host(ours.points), host(theirs.points), rtol=0,
                                   atol=TOL_POINTS, err_msg=f"{what} {cloud} points")
        np.testing.assert_allclose(host(ours.rho), host(theirs.rho), rtol=0, atol=TOL_RHO,
                                   err_msg=f"{what} {cloud} rho")
        np.testing.assert_array_equal(host(ours.active), host(theirs.active))
    assert td.stats == jd.stats, what


def pair(cfg_kw, seed=0):
    """An initialized JAX driver and the port's driver carried from it."""
    jd = JD.GPLEDriver(JGPLEConfig(**cfg_kw, seed=seed))
    jd.initialize()
    return jd, convert.driver_to_torch(jd, "cpu", rng=JaxKeys(jd.key))


# -- the booster -------------------------------------------------------------------------

BOOST = dict(model="DAC", mass=2000.0, x0=-10.0, p0=30.0, sigma_p0=1.5, output_time=1.0,
             reopt_time=2.0, dt=0.5, num_points=24, fused_chunk=0)


def test_boosted_fit_includes_extras():
    jd, td = pair(dict(BOOST, coh_fit_extra=48, coh_len_div=4.0))
    assert td._coh_k == jd._coh_k == 48 and td.optimizer.coh_fit_extra == 48
    for t in range(1, 4):
        assert td.step(t) == jd.step(t)
        same_state(td, jd, f"tick {t}")
        assert td.gps.offdiag.features.shape[0] == 24 + 48
        assert td.gps.diag.features.shape == (2, 24, 2)
    np.testing.assert_allclose(host(td.gps.offdiag.v), host(jd.gps.offdiag.v), rtol=0,
                               atol=1e-8 * np.abs(host(jd.gps.offdiag.v)).max())


def test_boost_capped_at_extras_and_off_by_default():
    cfg = GPLEConfig(**dict(BOOST, coh_fit_extra=10_000))
    assert TD.GPLEDriver(cfg, device="cpu")._coh_k == cfg.num_extra_points
    drv = TD.GPLEDriver(GPLEConfig(**BOOST), device="cpu")
    drv.initialize()
    assert drv._coh_k == 0 and drv.gps.offdiag.features.shape[0] == 24


def test_port_initializes_with_the_booster():
    drv = TD.GPLEDriver(GPLEConfig(**dict(BOOST, coh_fit_extra=48, coh_len_div=4.0)),
                        device="cpu")
    drv.initialize()
    assert drv.gps.offdiag.features.shape[0] == 24 + 48
    for t in range(1, 3):
        drv.step(t)
    assert drv.gps.offdiag.features.shape[0] == 24 + 48
    assert bool(torch.isfinite(drv.density.rho).all())


#: every flag on: the chip's booster phase at a test's width
ALL_FLAGS = dict(CROSSING, num_points=16, coh_fit_extra=16, coh_len_div=6.0,
                 moment_per_tick="off", evolve_cutoff="coh", coh_boost_rescale=True,
                 pop_rescale=True, relabel_conserve=True, relabel_mask_coh=True,
                 coh_reselect=False)


def test_booster_window_with_every_flag_matches():
    """Eight ticks through the coherence's activation and four reopts,
    decision for decision."""
    jd, td = pair(ALL_FLAGS)
    assert td._track_moments == "off" and td._evolve_dist is TD.gp_dist_coh_cut
    for t in range(1, 9):
        assert td.step(t) == jd.step(t), t
        same_state(td, jd, f"tick {t}")
    assert bool(td.density.active[OFFDIAG_INDEX])
    assert td.stats.get("coh_rescales", 0) > 0
    np.testing.assert_allclose(td.optimizer.off_params, jd.optimizer.off_params, rtol=0,
                               atol=1e-10 * np.abs(jd.optimizer.off_params).max())
    np.testing.assert_array_equal(np.asarray(td.rng.key), np.asarray(jd.key))


def test_booster_divergence_is_reproduced():
    """The reference's booster dies when (1, 1) activates a tick after
    (1, 0): at that first reoptimization the diagonal purity sits at the
    budget, the coherence rescale zeroes the nascent coherence and the next
    refit is NaN (seed 3 at this width).  The port takes the same decisions
    up to the same NaN (past it the NaNs' arithmetic differs)."""
    jd, td = pair(ALL_FLAGS, seed=3)
    first_nan = {}
    for t in range(1, 4):
        assert td.step(t) == jd.step(t), t
        assert td.stats == jd.stats, t
        for name, drv in (("jax", jd), ("port", td)):
            if name not in first_nan and not np.all(np.isfinite(host(drv.density.rho))):
                first_nan[name] = t
        if not first_nan:
            same_state(td, jd, f"tick {t}")
    assert first_nan.get("jax") == first_nan.get("port") is not None
    assert td.stats["coh_rescales"] >= 1 and "pop_rescales" not in td.stats


# -- the rescales ------------------------------------------------------------------------

RESCALE = dict(CROSSING, num_points=16, coh_fit_extra=16, coh_len_div=6.0,
               coh_boost_rescale=True)


@pytest.fixture(scope="module")
def rescale_base():
    """One initialized JAX driver for the rescale tests (each takes a copy)."""
    jd = JD.GPLEDriver(JGPLEConfig(**RESCALE))
    jd.initialize()
    return jd


@pytest.fixture()
def rescale_pair(rescale_base):
    jd = copy.deepcopy(rescale_base)
    return jd, convert.driver_to_torch(jd, "cpu", rng=JaxKeys(jd.key))


def test_coh_rescale_noop_within_budget(rescale_pair):
    jd, td = rescale_pair
    before = host(td.density.rho).copy()
    assert td._coh_purity_rescale() == jd._coh_purity_rescale() == 1.0
    np.testing.assert_array_equal(host(td.density.rho), before)


def test_inflated_coherence_is_clamped(rescale_pair):
    jd, td = rescale_pair
    pts = jd.density.points[OFFDIAG_INDEX]
    amp = 2.0 * float(jnp.abs(jd.density.rho).max())
    hot = amp * jnp.exp(-0.05 * jnp.sum((pts - pts.mean(0)) ** 2, axis=-1))
    # the diagonal at 0.9 of its labels leaves the coherence a purity budget
    # of 1 - 0.81 (at its own labels the diagonal alone spends the budget to
    # rounding, and the factor is rounding noise in either package)
    rho = jd.density.rho.at[OFFDIAG_INDEX, :, 0].set(hot).at[0].multiply(0.9)
    jd.density = jd.density._replace(rho=rho, active=jnp.asarray([True, True, True]))
    jd.extra = jd.extra._replace(rho=jd.extra.rho.at[OFFDIAG_INDEX, :, 0].set(1.0),
                                 active=jnp.asarray([True, True, True]))
    td.density, td.extra = convert.to_torch(jd.density, "cpu"), convert.to_torch(jd.extra, "cpu")
    booster = host(td.extra.rho[OFFDIAG_INDEX, :td._coh_k]).copy()
    s_j, s_t = jd._coh_purity_rescale(), td._coh_purity_rescale()
    assert 0.0 < s_t < 1.0 and s_t == pytest.approx(s_j, rel=1e-10)
    same_state(td, jd, "clamped")
    # the total purity is back at the initial budget; the booster scaled alike
    from gple_tpu_torch import observables as OBS
    from gple_tpu_torch.utils.constants import purity_factor

    total = float(OBS.purity_each_element(td.density).sum()) * purity_factor(1) * td.purity_ratio
    assert total == pytest.approx(td.purity, rel=1e-9)
    np.testing.assert_allclose(host(td.extra.rho[OFFDIAG_INDEX, :td._coh_k]), booster * s_t,
                               rtol=1e-12)
    assert td.stats["coh_rescales"] == 1


def test_pop_rescale_pins_the_diagonal_sum(rescale_pair):
    jd, td = rescale_pair
    di = jnp.asarray(DIAG_INDICES)
    for factor, applied in ((1.3, True), (3.0, False)):
        jd.density = jd.density._replace(rho=jd.density.rho.at[di, :, 0].multiply(factor))
        td.density = convert.to_torch(jd.density, "cpu")
        s_j, s_t = jd._pop_conservation_rescale(), td._pop_conservation_rescale()
        assert s_t == pytest.approx(s_j, rel=1e-12)
        assert (s_t != 1.0) == applied
        same_state(td, jd, f"x{factor}")
    assert td.stats.get("pop_rescales", 0) == 1


# -- the relabel -------------------------------------------------------------------------

def test_relabel_scale_rules():
    """``tests/test_relabel.py``'s band, sign, nascent and production-N cases
    through both packages' ``_relabel_scale``."""
    jd = JD.GPLEDriver(JGPLEConfig(model="SAC", num_points=8, relabel_conserve=True))
    td = TD.GPLEDriver(GPLEConfig(model="SAC", num_points=8, relabel_conserve=True),
                       device="cpu")

    def d(v, n=4):
        out = np.zeros((n, 2))
        out[:, 0] = v
        return out

    o = np.stack([np.full(4, 0.1), np.full(4, 0.1)], axis=-1)
    n = 256
    res = 0.5 / n * np.stack([np.cos(np.linspace(0, 30, n)), np.sin(np.linspace(0, 30, n))], -1)
    cases = [(0, d(0.25), d(0.5), None), (0, d(0.25), d(10.0), None),
             (0, d(0.25), d(-0.25), None), (OFFDIAG_INDEX, o, 2 * o, None),
             (OFFDIAG_INDEX, o, np.zeros((4, 2)), None), (0, d(1e-4), d(0.02), None),
             (0, d(1e-4), d(0.02), 1.0), (0, d(0.25), d(0.02), 1.0),
             (OFFDIAG_INDEX, np.full((4, 2), 1e-4), np.full((4, 2), 0.015), 1.0),
             (0, d(1e-4), d(-0.7), 1.0), (0, d(1e-4), d(0.2), 1.0),
             (OFFDIAG_INDEX, np.full((4, 2), 1e-4), np.full((4, 2), 0.2), 1.0),
             (OFFDIAG_INDEX, res, np.sqrt(2.0) * res, 1.0),
             (OFFDIAG_INDEX, res * 1e-3, res * 0.05, 1.0)]
    for k, old, new, ref in cases:
        theirs = jd._relabel_scale(k, old, new, ref)
        ours = td._relabel_scale(k, torch.tensor(old), torch.tensor(new), ref)
        assert (ours is None) == (theirs is None), (k, ref)
        if theirs is not None:
            assert ours == pytest.approx(theirs, rel=1e-12)
    assert td.stats == jd.stats and td.stats["relabel_nascent"] == 3


@pytest.fixture(scope="module")
def crossing_base():
    """``tests/test_relabel.py``'s mid-crossing state (active fringed boosted
    coherence, both surfaces populated) in a JAX driver."""
    jd = JD.GPLEDriver(JGPLEConfig(**CROSSING, num_points=32, coh_fit_extra=32,
                                   coh_len_div=6.0, coh_boost_rescale=True,
                                   relabel_conserve=True, seed=3))
    jd.initialize()
    pts = np.array(jd.density.points)
    rho = np.array(jd.density.rho)
    rng = np.random.default_rng(0)
    for k in range(3):
        pts[k] = np.stack([rng.normal(0.0, 0.4, pts.shape[1]),
                           rng.normal(20.0, 1.2, pts.shape[1])], axis=-1)
    env0 = np.exp(-0.5 * ((pts[0][:, 1] - 20.0) / 1.2) ** 2)
    env2 = np.exp(-0.5 * ((pts[2][:, 1] - 19.0) / 1.2) ** 2)
    rho[0] = np.stack([0.10 * env0, 0.0 * env0], -1)
    rho[2] = np.stack([0.04 * env2, 0.0 * env2], -1)
    fr = 4.0 * pts[OFFDIAG_INDEX][:, 1]
    envc = np.exp(-0.5 * ((pts[OFFDIAG_INDEX][:, 1] - 19.5) / 1.2) ** 2)
    rho[OFFDIAG_INDEX] = 0.05 * envc[:, None] * np.stack([np.cos(fr), np.sin(fr)], -1)
    active = jnp.asarray([True, True, True])
    jd.density = jd.density._replace(points=jnp.asarray(pts), rho=jnp.asarray(rho),
                                     active=active)
    e_pts, e_rho = np.array(jd.extra.points), np.array(jd.extra.rho)
    e_pts[OFFDIAG_INDEX, :32], e_rho[OFFDIAG_INDEX, :32] = pts[1], rho[1]
    jd.extra = jd.extra._replace(points=jnp.asarray(e_pts), rho=jnp.asarray(e_rho),
                                 active=active)
    energies = JOBS.total_energy_each_surface(jd.cfg.model, jd.density, jd.cfg.mass)
    jd.optimizer.optimize(jd.density, jd.extra, energies)
    jd.gps = jd._refit(jd.density)
    return jd


def crossing_pair(base, **overrides):
    """A copy of ``base`` with ``overrides`` in its config, and the port's
    driver carried from it."""
    jd = copy.deepcopy(base)
    for name, value in overrides.items():
        object.__setattr__(jd.cfg, name, value)
    return jd, convert.driver_to_torch(jd, "cpu", rng=JaxKeys(jd.key))


def _force_reselect(monkeypatch, flags):
    monkeypatch.setattr(JD, "_cloud_drift_flags", lambda density: jnp.asarray(flags))
    monkeypatch.setattr(TD, "_cloud_drift_flags", lambda density: torch.tensor(flags))


@pytest.mark.parametrize("overrides, flags", [
    (dict(), [True, True, True]),
    (dict(relabel_mask_coh=True), [True, False, False]),
    (dict(coh_reselect=False), [True, True, True]),
], ids=["conserve", "masked_diagonal", "frozen_coherence"])
def test_forced_reselection_matches(crossing_base, monkeypatch, overrides, flags):
    jd, td = crossing_pair(crossing_base, **overrides)
    _force_reselect(monkeypatch, flags)
    jd.density = jd._track_clouds(jd.density)
    td.density = td._track_clouds(td.density)
    same_state(td, jd, "re-selected")
    assert td.stats["cloud_reselections"] == (2 if overrides.get("coh_reselect") is False
                                              else sum(flags))
    decided = td.stats.get("relabel_rescales", 0) + td.stats.get("relabel_rejects", 0)
    assert decided + td.stats.get("relabel_nascent", 0) >= 1
    np.testing.assert_array_equal(np.asarray(td.rng.key), np.asarray(jd.key))


def test_backoff_and_eject_wiring(crossing_base):
    """A health factor that makes every fit unhealthy: divisor 6 -> 3 -> 2,
    then the booster is ejected, in both packages, with the same refits."""
    jd, td = crossing_pair(crossing_base, coh_fit_health_factor=1e-9)
    jd._reoptimize(target_purity=1.0)
    td._reoptimize(target_purity=1.0)
    assert td._coh_div_eff == jd._coh_div_eff == 2.0
    assert td._coh_k == jd._coh_k == 0 and td.optimizer.coh_fit_extra == 0
    assert td.stats["coh_len_backoffs"] == 2 and td.stats["coh_boost_ejected"] == 1
    same_state(td, jd, "ejected")
    assert td.gps.offdiag.features.shape[0] == 32
    np.testing.assert_allclose(host(td.gps.offdiag.v), host(jd.gps.offdiag.v), rtol=0,
                               atol=1e-8 * np.abs(host(jd.gps.offdiag.v)).max())


# -- checkpoints and flat parameters ------------------------------------------------------

def test_boosted_checkpoint_both_ways(crossing_base, tmp_path):
    jd, td = crossing_pair(crossing_base)
    path_j, path_t = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jckpt.save_checkpoint(path_j, jd, 7)
    back_t = TD.GPLEDriver(td.cfg, device="cpu")
    assert ckpt.load_checkpoint(path_j, back_t) == 7
    assert back_t._coh_k == 32 and back_t.optimizer.coh_fit_extra == 32
    assert back_t._coh_div_eff == 6.0 and back_t.optimizer.off_len_div == 6.0
    assert back_t.gps.offdiag.features.shape[0] == 32 + 32
    ckpt.save_checkpoint(path_t, back_t, 7)
    with np.load(path_j) as a, np.load(path_t) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    back_j = JD.GPLEDriver(jd.cfg)
    assert jckpt.load_checkpoint(path_t, back_j) == 7
    assert back_j._coh_k == 32 and back_j.gps.offdiag.features.shape[0] == 64
    np.testing.assert_allclose(host(back_t.gps.offdiag.v), host(back_j.gps.offdiag.v),
                               rtol=0, atol=1e-8 * np.abs(host(back_j.gps.offdiag.v)).max())


def test_kernel_params_flat_round_trip():
    jp = JRK.KernelParams(magnitude=jnp.asarray(0.7), lengths=jnp.asarray([0.3, 1.4]),
                          noise=jnp.asarray(1e-2))
    tp = convert.to_torch(jp, "cpu")
    np.testing.assert_array_equal(tp.to_flat().numpy(), np.asarray(jp.to_flat()))
    back = RK.KernelParams.from_flat(tp.to_flat())
    jback = JRK.KernelParams.from_flat(jp.to_flat())
    for name in ("magnitude", "lengths", "noise"):
        np.testing.assert_array_equal(getattr(back, name).numpy(),
                                      np.asarray(getattr(jback, name)))
    # a batch of two (the diagonal elements' parameters) flattens row by row
    batch = RK.KernelParams(magnitude=torch.tensor([1.0, 2.0]),
                            lengths=torch.tensor([[0.3, 1.4], [0.5, 1.1]]),
                            noise=torch.tensor([1e-2, 1e-2]))
    flat = batch.to_flat()
    assert flat.shape == (2, 4)
    torch.testing.assert_close(RK.KernelParams.from_flat(flat).lengths, batch.lengths)
