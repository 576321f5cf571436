"""PyTorch port: the one-dispatch tick paths against ``gple_tpu.driver``.

The JAX package runs a chunk of ticks as one ``lax.scan`` and a whole
segment of reoptimization periods, the scheduled moment reopts included, as
one program with rollback on an event (``_ticks_scan_fused``,
``_advance_fused``, ``run``'s abort hysteresis and event hints).  The port
runs the same paths as replays of captured CUDA graphs on the card and, on
the CPU, as the same Python functions eagerly (``GPLEDriver._advance_chunk``,
``_advance_fused``, ``_advance``; ``gple_tpu_torch/ops/graphs.py``).

* Parity with JAX: ``tests/test_fused_trajectory.py``'s config (DAC, N = 32,
  ``fused_chunk = 10``, 20 ticks), initialized by the JAX driver and carried
  into the port (``convert.driver_to_torch``, the random key replayed by
  ``JaxKeys``); both ``run``: records 1e-8 relative, points 1e-12, rho and
  alpha 1e-8 absolute (the window gate's limits), keys equal.
* The port's fused run against its chunked run (``fused_chunk = 0``) at
  ``tests/test_fused_trajectory.py``'s tolerances.
* ``_moment_reopt_core`` against JAX's and against the port's host reopt
  (``Optimizer.optimize`` + ``fitted_params``), 1e-10 relative.
* A segment with a forced drift event rolls state, key and optimizer back
  bit for bit.
* ``tests/test_fused_hysteresis.py``'s three scripted cases against the
  port's ``_advance``; the event hints of ``init_cache``.

The graph helper itself, and graph replays against eager ticks on the card,
are in ``tests/test_torch_graphs.py`` (no JAX there, so it runs on the card).
"""

import dataclasses
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gple_tpu import driver as JD
from gple_tpu.config import GPLEConfig as JGPLEConfig
from gple_tpu.storage import Density as JDensity
from gple_tpu_torch import convert
from gple_tpu_torch import driver as TD
from gple_tpu_torch.config import GPLEConfig
from gple_tpu_torch.gp.opt import Optimizer
from gple_tpu_torch.ops import graphs as GR
from gple_tpu_torch.utils import spans
from test_torch_kernels import _warm_torch_exp, one_torch_thread  # noqa: F401 (fixtures)
from test_torch_mc import JaxKeys
from test_torch_observables import both_states

TOL_POINTS, TOL_RHO, TOL_ALPHA, TOL_RECORD = 1e-12, 1e-8, 1e-8, 1e-8
FUSED_RUN = dict(model="DAC", mass=2000.0, x0=-10.0, p0=30.0, sigma_p0=1.5,
                 output_time=1.0, reopt_time=1.0, dt=0.5, num_points=32)
TICKS = 20
RECORD_FIELDS = ("population_prm", "population_prm_each", "population_mci", "energy_prm",
                 "energy_mci", "purity_prm", "purity_mci", "x_average")




def host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _no_init(drv):
    """``run`` then starts from the state the driver holds."""
    drv.initialize = lambda: None
    return drv


@pytest.fixture(scope="module")
def jax_parity():
    jd = JD.GPLEDriver(JGPLEConfig(**FUSED_RUN, fused_chunk=10))
    jd.initialize()
    td = _no_init(convert.driver_to_torch(jd, "cpu", rng=JaxKeys(jd.key)))
    _no_init(jd).run(max_ticks=TICKS)
    td.run(max_ticks=TICKS)
    return jd, td


def test_fused_path_matches_jax(jax_parity):
    jd, td = jax_parity
    assert jd.phase_times["fused"] > 0.0 and td.phase_times["fused"] > 0.0
    assert td.phase_times["fused_abort"] == jd.phase_times["fused_abort"] == 0.0
    assert len(td.history) == len(jd.history) == TICKS // 2 + 1
    for i, (ours, theirs) in enumerate(zip(td.history, jd.history)):
        assert (ours.time, ours.opt_type) == (theirs.time, theirs.opt_type), i
        for field in RECORD_FIELDS:
            np.testing.assert_allclose(getattr(ours, field), getattr(theirs, field),
                                       rtol=TOL_RECORD, atol=1e-300,
                                       err_msg=f"record {i}: {field}")
    for ours, theirs, tol in ((td.density.points, jd.density.points, TOL_POINTS),
                              (td.extra.points, jd.extra.points, TOL_POINTS),
                              (td.density.rho, jd.density.rho, TOL_RHO),
                              (td.extra.rho, jd.extra.rho, TOL_RHO),
                              (td.gps.diag.alpha, jd.gps.diag.alpha, TOL_ALPHA),
                              (td.gps.offdiag.v, jd.gps.offdiag.v, TOL_ALPHA)):
        np.testing.assert_allclose(host(ours), np.asarray(theirs), rtol=0, atol=tol)
    # the pre-split keys: the port consumed the stream exactly as JAX
    np.testing.assert_array_equal(np.asarray(td.rng.key), np.asarray(jd.key))
    np.testing.assert_allclose(td.optimizer.off_params, jd.optimizer.off_params, rtol=1e-10)
    np.testing.assert_allclose(td.optimizer.diag_lengths, jd.optimizer.diag_lengths,
                               rtol=1e-10)
    for name in ("pop", "pur", "target"):
        assert td._fit_ref[name] == pytest.approx(jd._fit_ref[name], rel=TOL_RECORD)


# -- the port's fused path against its chunked path --------------------------------

def _port_run(fused_chunk: int, ticks: int = TICKS, **kw):
    drv = TD.GPLEDriver(GPLEConfig(**FUSED_RUN, fused_chunk=fused_chunk, **kw), device="cpu")
    hist = drv.run(max_ticks=ticks)
    return drv, hist


@pytest.fixture(scope="module")
def port_pair():
    return _port_run(0), _port_run(10)


def test_fused_matches_chunked(port_pair):
    (drv_c, hist_c), (drv_f, hist_f) = port_pair
    assert drv_f.phase_times["fused"] > 0.0 and drv_c.phase_times["fused"] == 0.0
    assert len(hist_f) == len(hist_c)
    for rc, rf in zip(hist_c, hist_f):
        assert (rf.time, rf.opt_type) == (rc.time, rc.opt_type)
        np.testing.assert_allclose(rf.population_mci, rc.population_mci, rtol=1e-6, atol=1e-9)
        for field in ("population_prm", "energy_mci", "purity_prm", "x_average"):
            assert getattr(rf, field) == pytest.approx(getattr(rc, field), rel=1e-6)
    np.testing.assert_allclose(host(drv_f.density.points), host(drv_c.density.points),
                               rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(host(drv_f.density.rho), host(drv_c.density.rho),
                               rtol=1e-6, atol=1e-12)
    assert drv_f.rng.seed == drv_c.rng.seed
    np.testing.assert_allclose(drv_f.optimizer.diag_lengths, drv_c.optimizer.diag_lengths,
                               rtol=1e-7)
    np.testing.assert_allclose(drv_f.optimizer.off_params, drv_c.optimizer.off_params,
                               rtol=1e-7)


def test_pop_rescale_fused_matches_chunked():
    """The period end's population rescale of the diagonal labels, its stat
    and its measured target, as the host's (a conserved numerator 1% off
    makes every reopt rescale)."""
    runs = []
    for fused_chunk in (0, 4):
        drv = TD.GPLEDriver(GPLEConfig(**FUSED_RUN, fused_chunk=fused_chunk, pop_rescale=True),
                            device="cpu")
        drv.initialize()
        drv._pop_sum0 *= 1.01
        drv._advance(1, 8)
        runs.append(drv)
    drv_c, drv_f = runs
    assert drv_f.phase_times["fused"] > 0.0 and drv_c.phase_times["fused"] == 0.0
    assert drv_f.stats["pop_rescales"] == drv_c.stats["pop_rescales"] >= 1
    for rc, rf in zip(drv_c.history, drv_f.history):
        assert (rf.time, rf.opt_type) == (rc.time, rc.opt_type)
        assert rf.population_prm == pytest.approx(rc.population_prm, rel=1e-6)
        assert rf.purity_mci == pytest.approx(rc.purity_mci, rel=1e-6)
    np.testing.assert_allclose(host(drv_f.density.rho), host(drv_c.density.rho),
                               rtol=1e-6, atol=1e-12)
    assert drv_f._fit_ref == pytest.approx(drv_c._fit_ref, rel=1e-12)


# -- the moment reopt on the device --------------------------------------------------

@pytest.mark.parametrize("active,coh_k", [((True, True, True), 0), ((True, True, True), 8),
                                          ((True, False, True), 0)])
def test_moment_reopt_core_matches_jax_and_host(active, coh_k):
    jd, jg, td, tg = both_states(31, 32, active)
    je = JDensity(points=jd.points + 0.01, rho=jd.rho * 0.9, active=jd.active)
    te = convert.to_torch(je, "cpu")
    dparams, oparams = jg.diag.params, jg.offdiag.params
    jdp, jop, jerr = JD._moment_reopt_core(coh_k, 2.0, jd, je, dparams, oparams, True)
    tdp, top, terr = TD._moment_reopt_core(coh_k, 2.0, td, te, convert.to_torch(dparams, "cpu"),
                                           convert.to_torch(oparams, "cpu"), True)
    for ours, theirs in zip((*tdp, *top, terr), (*jdp, *jop, jerr)):
        np.testing.assert_allclose(host(ours), np.asarray(theirs), rtol=1e-10, atol=1e-300)
    # the host reopt from the same previous parameters
    opt = Optimizer(model="SAC", mass=2000.0, total_energy=1.0, purity=1.0,
                    sigma_r0=np.array([0.5, 1.0]),
                    diag_lengths=host(dparams.lengths).copy(),
                    off_params=np.concatenate([[float(oparams.real_magnitude)],
                                               np.asarray(oparams.real_lengths),
                                               [float(oparams.imag_magnitude)],
                                               np.asarray(oparams.imag_lengths),
                                               [float(oparams.corr)]]),
                    coh_fit_extra=coh_k, device="cpu")
    res = opt.optimize(td, te, torch.zeros(2, dtype=torch.float64))
    hdp, hop = opt.fitted_params()
    for ours, theirs in zip((*tdp, *top), (*hdp, *hop)):
        np.testing.assert_allclose(host(ours), host(theirs), rtol=1e-12, atol=1e-300)
    assert res.error == pytest.approx(terr.item(), rel=1e-12)


# -- rollback ---------------------------------------------------------------------------

def test_forced_event_rolls_back_bit_for_bit():
    drv = TD.GPLEDriver(GPLEConfig(**FUSED_RUN, fused_chunk=10), device="cpu")
    drv.initialize()
    # a drift reference the first checked tick cannot meet: a drift event
    drv._fit_ref = dict(drv._fit_ref, pop=2.0 * drv._fit_ref["pop"])
    opt = drv.optimizer
    # warm multipliers as a ladder would leave them: a clean segment keeps them
    opt.restore({"al_lam": np.arange(6.0).reshape(2, 3) - 2.5})
    before = dict(tensors=GR.clone((drv.density, drv.extra, drv.gps)), seed=drv.rng.seed,
                  opt={k: np.copy(v) for k, v in opt.snapshot().items()},
                  ref=dict(drv._fit_ref), res=drv.opt_result)
    assert set(before["opt"]) == {"diag_lengths", "off_params", "diag_magnitudes",
                                  "off_magnitude", "al_lam"}
    ok, first = drv._advance_fused(1, 10)
    assert (ok, first) == (False, 1)
    assert drv.phase_times["fused_abort"] > 0.0 and drv.phase_times["fused"] == 0.0
    for ours, theirs in zip(GR.leaves((drv.density, drv.extra, drv.gps)),
                            GR.leaves(before["tensors"])):
        assert torch.equal(ours, theirs)
    assert drv.rng.seed == before["seed"]
    after = opt.snapshot()
    assert set(after) == set(before["opt"])
    for name, value in before["opt"].items():
        np.testing.assert_array_equal(after[name], value, err_msg=name)
    assert drv._fit_ref == before["ref"] and drv.opt_result is before["res"]
    assert drv.history == []
    # the same segment runs clean from the true reference
    drv._fit_ref = dict(drv._fit_ref, pop=0.5 * drv._fit_ref["pop"])
    assert drv._advance_fused(1, 10) == (True, False)
    assert drv.rng.seed != before["seed"] and len(drv.history) == 5
    np.testing.assert_array_equal(opt.snapshot()["al_lam"], before["opt"]["al_lam"])


# -- the abort hysteresis (tests/test_fused_hysteresis.py, against the port) -------------

class _ScriptedDriver(TD.GPLEDriver):
    """The port's driver with the physics stubbed out: only ``_advance``'s
    control flow runs.  ``aborts`` maps a segment's start tick to the event
    tick it reports."""

    def __init__(self, cfg, aborts):
        self.cfg = cfg
        self.writers = None
        self.verbose = False
        self.history = []
        self.totals = spans.Totals()
        self._event_ticks = set()
        self.aborts = dict(aborts)
        self.calls = []

    def step(self, tick_no):
        return "none"

    def _advance_chunk(self, n_ticks):
        return True

    def observe(self, tick, opt_type):
        return SimpleNamespace(time=float(tick), x_average=-1e9)

    def _advance_fused(self, start_tick, n, callback=None):
        self.calls.append((start_tick, n))
        if start_tick in self.aborts:
            return False, self.aborts.pop(start_tick)
        return True, False


def _scripted_cfg():
    # reopt_freq = output_freq = 5; fused_chunk = 20: full segments of 4 periods
    return GPLEConfig(model="SAC", mass=2000.0, x0=-10.0, p0=20.0, sigma_p0=1.0,
                      output_time=5.0, reopt_time=5.0, dt=1.0, num_points=8, fused_chunk=20)


@pytest.mark.parametrize("aborts,total,calls", [
    ({1: 3}, 55, [(1, 20), (6, 5), (11, 5), (16, 20), (36, 20)]),
    ({1: 3, 11: 12}, 55, [(1, 20), (6, 5), (11, 5), (16, 5), (21, 5), (26, 20)]),
    ({}, 40, [(1, 20), (21, 20)]),
], ids=["abort_drops_to_one_period_then_restores", "abort_during_probe_keeps_probing",
        "no_abort_uses_full_segments_only"])
def test_abort_hysteresis(aborts, total, calls):
    drv = _ScriptedDriver(_scripted_cfg(), aborts)
    assert (drv.cfg.reopt_freq, drv.cfg.output_freq) == (5, 5)
    drv._advance(1, total)
    assert drv.calls == calls
    assert drv._event_ticks == set(aborts.values())


def test_scripted_hints_block_their_segment(tmp_path):
    path = str(tmp_path / "events.json")
    with open(path, "w") as f:
        json.dump([23], f)
    drv = _ScriptedDriver(_scripted_cfg(), {})
    drv._advance(1, 60, hints_path=path)
    # the segment holding tick 23 replays chunked through it; the length stays
    assert drv.calls == [(1, 20), (26, 20)]
    assert drv._event_ticks == set()


# -- event hints with the init cache -------------------------------------------------------

def test_event_hints_preblock_the_replayed_event(tmp_path, monkeypatch):
    monkeypatch.setenv(TD.INIT_CACHE_ENV, str(tmp_path))
    cfg = GPLEConfig(**FUSED_RUN, fused_chunk=10, init_cache=True)
    restore = TD.GPLEDriver._initialize_or_restore

    def with_drift(self):
        # the same drift event at tick 1 in both runs: a reference the first
        # checked tick cannot meet (runs are deterministic given the config)
        restore(self)
        self._fit_ref = dict(self._fit_ref, pop=2.0 * self._fit_ref["pop"])

    monkeypatch.setattr(TD.GPLEDriver, "_initialize_or_restore", with_drift)
    cold = TD.GPLEDriver(cfg, device="cpu")
    hints = cold._event_hints_path()
    assert not os.path.exists(hints)
    cold_hist = cold.run(max_ticks=TICKS)
    assert cold.phase_times["fused_abort"] > 0.0
    with open(hints) as f:
        assert json.load(f) == [1]
    logs = []
    warm = TD.GPLEDriver(cfg, device="cpu")
    warm._log = logs.append
    hist = warm.run(max_ticks=TICKS)
    assert "fusion event hints: [1]" in logs
    assert any(line.startswith("init restored from cache") for line in logs)
    assert warm.phase_times["fused_abort"] == 0.0 and warm.phase_times["fused"] > 0.0
    assert len(hist) == len(cold_hist)
    for ours, theirs in zip(hist, cold_hist):
        for field in dataclasses.fields(ours):
            np.testing.assert_array_equal(getattr(ours, field.name),
                                          getattr(theirs, field.name))
    assert torch.equal(warm.density.points, cold.density.points)
    assert warm.rng.seed == cold.rng.seed


def test_fused_chunk_zero_stays_chunked_and_records_event_ticks():
    drv = TD.GPLEDriver(GPLEConfig(**FUSED_RUN, fused_chunk=0), device="cpu")
    drv.initialize()
    drv._fit_ref = dict(drv._fit_ref, pop=2.0 * drv._fit_ref["pop"])
    assert drv.step(1) == "drift"
    assert drv._event_ticks == {1}
    drv._advance(2, 6)
    assert drv.phase_times["fused"] == drv.phase_times["fused_abort"] == 0.0
