"""The benchmark's plain reference against the program's plain route, at a
tiny size on the CPU: the evolve step, the fits and observables, the moment
reoptimization, the activation test and a re-selection's labels."""

import dataclasses

import numpy as np
import pytest
import torch

from bench_h100.reference import evolve as REV
from bench_h100.reference import follow as F
from gple_tpu_torch.driver import GPLEDriver, gp_dist_all, gp_dist_all_nocut
from gple_tpu_torch.dynamics import evolve as PEV
from gple_tpu_torch import observables as OBS
from gple_tpu_torch.entry import parity_config, trajectory_config


def _driver(cfg):
    torch.set_num_threads(2)
    drv = GPLEDriver(dataclasses.replace(cfg, fused_chunk=0), device="cpu")
    drv.run(max_ticks=30)
    return drv


def _params(drv):
    o = drv.optimizer
    t = lambda v: torch.as_tensor(np.asarray(v, dtype=np.float64))
    return F.Params(t(o.diag_lengths), t(o.diag_magnitudes), t(o.off_params), t(o.off_magnitude))


@pytest.fixture(scope="module", params=["SAC", "DAC"])
def drv(request):
    cfg = trajectory_config(24) if request.param == "SAC" else parity_config("DAC", 24)
    return _driver(cfg)


def test_fit_and_observables(drv):
    d = drv.density
    act = tuple(bool(a) for a in d.active)
    fits = F.fit(_params(drv), d.points, d.rho, act)
    ref = F.observe(drv.cfg.model, drv.cfg.mass, d.points, d.rho, act, fits)
    prog = OBS.observe_all(drv.cfg.model, d, drv.gps, drv.cfg.mass)
    pairs = dict(population_prm="pop_prm", energy_prm="energy_prm",
                 energy_mci="energy_mci", purity_prm="purity_prm", x_average="x_average",
                 population_mci="ppl_mci")
    for r, p in pairs.items():
        assert torch.allclose(ref[r], prog[p], rtol=1e-10, atol=1e-13), r


def test_evolve_and_activation_test(drv):
    d = drv.density
    act = tuple(bool(a) for a in d.active)
    cfg = drv.cfg
    new = PEV.evolve_step(cfg.model, cfg.mass, cfg.dt, d, gp_dist_all_nocut, drv.gps)
    fits = F.fit(_params(drv), d.points, d.rho, act)
    pts, rho = REV.evolve(cfg.model, cfg.mass, cfg.dt, d.points, d.rho, F.dist(fits, False))
    assert torch.allclose(pts, new.points, rtol=1e-13, atol=1e-13)
    assert torch.allclose(rho, new.rho, rtol=1e-9, atol=1e-12 * float(rho.abs().max()))
    ratios = REV.small_ratios(cfg.model, cfg.mass, cfg.dt, new.points, act, F.dist(fits, True))
    small = PEV.is_very_small(cfg.model, cfg.mass, cfg.dt, new, gp_dist_all, drv.gps)
    for k in range(3):
        if not act[k]:
            assert bool(small[k]) == bool(ratios[k] < 1.0)
    labels = F.relabel(cfg.model, cfg.mass, cfg.dt, d.points[0], 0, fits)
    want = PEV.predict_new_points(cfg.model, cfg.mass, cfg.dt, d.points[0], 0,
                                  gp_dist_all_nocut, drv.gps)
    assert torch.allclose(labels, want, rtol=1e-9, atol=1e-12 * float(want.abs().max()))


def test_moment_reoptimization(drv):
    d, o = drv.density, drv.optimizer
    act = tuple(bool(a) for a in d.active)
    new = F.moment(d.points, d.rho, act, _params(drv), drv._coh_div_eff)
    o.optimize(d, drv.extra, OBS.total_energy_each_surface(drv.cfg.model, d, drv.cfg.mass))
    got = torch.cat([p.reshape(-1) for p in _params(drv)])
    want = torch.cat([p.reshape(-1) for p in new])
    assert torch.allclose(got, want, rtol=1e-10, atol=1e-14)
