"""PyTorch port: the trajectory driver against ``gple_tpu.driver``.

Deterministic window gate: a ``gple_tpu`` driver is initialized on the CPU
(the ``tests/test_driver.py`` short-run config: DAC, N = 32, an output and a
scheduled reoptimization every 2 ticks, with an output directory), its whole
state is carried into the port's driver (``convert.driver_to_torch``) whose
random key replays the JAX driver's, and both advance the same 6 ticks --
chunks, scheduled reopts with extra-cloud regeneration, outputs.  At every
output the records and the points, rho and alpha must agree (points 1e-12,
rho and alpha 1e-8 absolute, record values 1e-8 relative: the limits of
``tests/test_sharding.py:68-73``), and so must the seven output files' numbers
(1e-8 relative, or 1e-8 of the file's largest magnitude).

Short run: ``tests/test_driver.py``'s short run through the port's own
``GPLEDriver.run`` on the CPU, from its own initialization, with the same
conservation checks and the same output files (names, row counts) as the
JAX run above.
"""

import os

import jax
import numpy as np
import pytest
import torch

from gple_tpu.config import GPLEConfig as JGPLEConfig
from gple_tpu.driver import GPLEDriver as JGPLEDriver
from gple_tpu_torch import convert
from gple_tpu_torch.config import GPLEConfig
from gple_tpu_torch.driver import GPLEDriver
from gple_tpu_torch.sampler.mc import POSSIBLE_DISPLACEMENTS
from test_torch_kernels import _warm_torch_exp  # noqa: F401 (fixture)
from test_torch_mc import JaxKeys

TOL_POINTS, TOL_RHO, TOL_ALPHA, TOL_RECORD = 1e-12, 1e-8, 1e-8, 1e-8
FILES = ("ave.txt", "param.txt", "coord.txt", "value.txt", "phase.txt", "var.txt", "run.log")
SHORT_RUN = dict(model="DAC", mass=2000.0, x0=-10.0, p0=30.0, sigma_p0=1.5,
                 output_time=1.0, reopt_time=1.0, dt=0.5, num_points=32)
TICKS = 6


def jax_window(drv, total, callback):
    """``gple_tpu.driver.GPLEDriver.run``'s boundary-chunked loop after the
    initialization (its fused path is off: ``fused_chunk=0``)."""
    cfg = drv.cfg

    def next_multiple(t, k):
        return ((t + k - 1) // k) * k

    tick = 1
    while tick <= total:
        boundary = min(next_multiple(tick, cfg.reopt_freq),
                       next_multiple(tick, cfg.output_freq), total)
        n_pre = boundary - tick
        canonical = n_pre == min(cfg.output_freq, cfg.reopt_freq) - 1
        if not (n_pre > 0 and canonical and drv._advance_chunk(n_pre)):
            for t in range(tick, boundary):
                drv.step(t)
        tick = boundary
        opt_type = drv.step(tick)
        if tick % cfg.output_freq == 0:
            rec = drv.observe(tick, opt_type)
            callback(rec)
            if rec.x_average > -cfg.x0:
                break
        tick += 1


def snapshot(drv):
    def host(a):
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    return dict(points=host(drv.density.points), rho=host(drv.density.rho),
                alpha=host(drv.gps.diag.alpha), v=host(drv.gps.offdiag.v),
                extra_points=host(drv.extra.points), extra_rho=host(drv.extra.rho))


@pytest.fixture(scope="module")
def gate(tmp_path_factory):
    out_j = str(tmp_path_factory.mktemp("gate_jax"))
    out_t = str(tmp_path_factory.mktemp("gate_port"))
    jd = JGPLEDriver(JGPLEConfig(**SHORT_RUN, fused_chunk=0), outdir=out_j)
    jd.initialize()
    td = convert.driver_to_torch(jd, "cpu", rng=JaxKeys(jd.key), outdir=out_t)
    frames = {"jax": [], "port": []}
    for name, drv in (("jax", jd), ("port", td)):
        drv.observe(0, drv.opt_result.opt_type)
        frames[name].append(snapshot(drv))
        total = min(drv.cfg.total_ticks, TICKS)
        if name == "jax":
            jax_window(drv, total, lambda rec, d=drv: frames["jax"].append(snapshot(d)))
        else:
            drv._advance(1, total, lambda rec, d=drv: frames["port"].append(snapshot(d)))
        drv.writers.close()
    return jd, td, frames, out_j, out_t


def test_window_records_match(gate):
    jd, td, _, _, _ = gate
    assert len(td.history) == len(jd.history) == TICKS // 2 + 1
    for i, (ours, theirs) in enumerate(zip(td.history, jd.history)):
        assert ours.opt_type == theirs.opt_type, i
        assert ours.time == theirs.time
        for field in ("population_prm", "population_prm_each", "population_mci",
                      "energy_prm", "energy_mci", "purity_prm", "purity_mci", "x_average"):
            np.testing.assert_allclose(getattr(ours, field), getattr(theirs, field),
                                       rtol=TOL_RECORD, atol=1e-300,
                                       err_msg=f"record {i}: {field}")
    assert [h.opt_type for h in td.history[1:]] == ["moment"] * (TICKS // 2)


def test_window_states_match_at_every_output(gate):
    _, _, frames, _, _ = gate
    assert len(frames["port"]) == len(frames["jax"]) == TICKS // 2 + 1
    limits = dict(points=TOL_POINTS, extra_points=TOL_POINTS, rho=TOL_RHO,
                  extra_rho=TOL_RHO, alpha=TOL_ALPHA, v=TOL_ALPHA)
    for i, (ours, theirs) in enumerate(zip(frames["port"], frames["jax"])):
        for key, tol in limits.items():
            np.testing.assert_allclose(ours[key], theirs[key], rtol=0, atol=tol,
                                       err_msg=f"output {i}: {key}")


def test_window_carries_optimizer_and_sampler_state(gate):
    jd, td, _, _, _ = gate
    for name in ("diag_lengths", "off_params", "diag_magnitudes"):
        np.testing.assert_allclose(getattr(td.optimizer, name),
                                   np.asarray(getattr(jd.optimizer, name)), rtol=1e-10)
    assert [(p.num_steps, p.displacement) for p in td.mc_params] == \
        [(p.num_steps, p.displacement) for p in jd.mc_params]
    for key in ("pop", "pur", "target"):
        np.testing.assert_allclose(td._fit_ref[key], jd._fit_ref[key], rtol=TOL_RECORD)
    # both consumed the same random stream
    np.testing.assert_array_equal(np.asarray(td.rng.key), np.asarray(jd.key))


def _numbers(path):
    with open(path) as f:
        return np.array([float(x) for x in f.read().split()])


def test_window_files_match(gate):
    _, _, _, out_j, out_t = gate
    for name in FILES[:-1]:
        ours, theirs = _numbers(os.path.join(out_t, name)), _numbers(os.path.join(out_j, name))
        assert ours.shape == theirs.shape, name
        scale = np.nanmax(np.abs(theirs))
        np.testing.assert_allclose(ours, theirs, rtol=TOL_RECORD, atol=TOL_RECORD * scale,
                                   equal_nan=True, err_msg=name)
    with open(os.path.join(out_t, "run.log")) as f:
        ours = [ln.split() for ln in f]
    with open(os.path.join(out_j, "run.log")) as f:
        theirs = [ln.split() for ln in f]
    assert len(ours) == len(theirs) == TICKS // 2 + 1
    for a, b in zip(ours, theirs):
        # time, MC steps, displacements, rescales, error, optimizer steps, kind;
        # field 1 is the wall time and the tail the wall-clock stamp
        np.testing.assert_allclose(np.array(a[2:12], dtype=float),
                                   np.array(b[2:12], dtype=float), rtol=TOL_RECORD,
                                   equal_nan=True)
        assert (a[0], a[12], a[13]) == (b[0], b[12], b[13])


# -- the port's own run ----------------------------------------------------------------

@pytest.fixture(scope="module")
def short_run(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("port_out"))
    drv = GPLEDriver(GPLEConfig(**SHORT_RUN), outdir=outdir, device="cpu")
    hist = drv.run(max_ticks=TICKS)
    return drv, hist, outdir


def test_short_run_conservation(short_run):
    drv, hist, _ = short_run
    assert len(hist) >= 3
    pop0, pur0 = hist[0].population_prm, hist[0].purity_prm
    for rec in hist:
        assert sum(rec.population_mci) == pytest.approx(1.0, abs=0.05)
        assert rec.population_prm == pytest.approx(pop0, rel=0.10)
        assert rec.purity_prm == pytest.approx(pur0, rel=0.12)
        assert rec.energy_prm / rec.population_prm == pytest.approx(drv.total_energy,
                                                                    rel=0.08)
    assert hist[-1].x_average > hist[0].x_average
    # far from the DAC crossing, all population stays on surface 0
    assert hist[-1].population_mci[0] == pytest.approx(1.0, abs=1e-3)
    assert drv.mc_params[0].displacement in POSSIBLE_DISPLACEMENTS
    assert drv.mc_params[0].num_steps >= 1
    assert drv.density.points.is_inference()


def test_short_run_files_match_jax_layout(short_run, gate):
    drv, hist, outdir = short_run
    _, _, _, out_j, _ = gate
    assert sorted(os.listdir(outdir)) == sorted(os.listdir(out_j)) == sorted(FILES)
    for name in FILES:
        with open(os.path.join(outdir, name)) as f:
            ours = f.read().split("\n")
        with open(os.path.join(out_j, name)) as f:
            theirs = f.read().split("\n")
        assert len(ours) == len(theirs), name
        assert [len(ln.split()) for ln in ours] == [len(ln.split()) for ln in theirs], name
    assert np.loadtxt(os.path.join(outdir, "ave.txt")).shape[0] == len(hist)
    with open(os.path.join(outdir, "phase.txt")) as f:
        assert len(f.readline().split()) == 2 * drv.cfg.num_grids_per_dim ** 2


# -- construction ----------------------------------------------------------------------

@pytest.mark.parametrize("setting", [
    dict(opt_mode="ladder"), dict(reference_parity=True), dict(coh_fit_extra=8),
    dict(moment_per_tick=True), dict(pop_rescale=True), dict(coh_boost_rescale=True),
    dict(relabel_conserve=True), dict(relabel_mask_coh=True), dict(evolve_cutoff=True),
    dict(evolve_cutoff="coh"), dict(init_cache=True),
])
def test_unported_settings_raise(setting):
    with pytest.raises(NotImplementedError, match="not ported"):
        GPLEDriver(GPLEConfig(**setting), device="cpu")


def test_fused_chunk_is_accepted_and_cuda_is_the_default(monkeypatch):
    GPLEDriver(GPLEConfig(fused_chunk=0), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GPLEDriver(GPLEConfig())


def test_config_maps_field_for_field():
    jcfg = JGPLEConfig(**SHORT_RUN, seed=3)
    cfg = convert.config_to_torch(jcfg)
    assert cfg == GPLEConfig(**SHORT_RUN, seed=3)
    for name in ("sigma_x0", "xmin", "pmin", "pmax", "dp", "output_freq", "reopt_freq",
                 "total_ticks", "num_extra_points", "num_grids_per_dim"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    np.testing.assert_array_equal(cfg.phase_grids(), jcfg.phase_grids())
    assert jax.devices()[0].platform == "cpu"
