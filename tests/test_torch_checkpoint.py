"""PyTorch port: checkpoints (``gple_tpu_torch.io.checkpoint``) and the
``reference_parity`` trajectory against ``gple_tpu``.

* The npz schema: a port checkpoint loads into a ``gple_tpu`` driver and a
  ``gple_tpu`` checkpoint into the port's, every field equal (the random key
  through the documented seed mapping).
* Deterministic gate: a ``gple_tpu`` driver's checkpoint loaded into a JAX
  driver and into the port's, both advanced tick by tick through a window
  with no reoptimization (no random draw): points 1e-12, rho and alpha 1e-8
  absolute at every tick (``tests/test_torch_driver.py``'s limits).
* The port's own resume (``tests/test_checkpoint.py:47-96``): 2k ticks
  straight against k, a checkpoint and k more, populations within 5e-3;
  ``run`` with ``checkpoint_path`` / ``checkpoint_every`` / ``resume_from``.
* ``reference_parity`` window: a JAX driver with ``reference_parity=True``
  (the ladder, the cutoff evolution, corr pinned to 1) carried into the port
  (``convert.driver_to_torch``, random draws replayed from the JAX key) and
  both advanced through two outputs, a ladder reoptimization with extra-cloud
  regeneration, and two more outputs.  The JAX ladder runs its fixed-fan
  inner solver (``_lbfgs_scan`` patched for this module, ``jax``'s caches
  cleared around it).  Limits: points 1e-12, rho, alpha and the extra labels
  1e-8 absolute, v 1e-8 relative to its largest entry, records 1e-8
  relative, lengths 1e-8 and multipliers 1e-6 relative.
* The CLI's checkpoint, ladder and reference-parity flags on ``--device cpu``.
"""

import os

import jax
import numpy as np
import pytest
import torch

from gple_tpu import observables as JOBS
from gple_tpu.config import GPLEConfig as JGPLEConfig
from gple_tpu.driver import GPLEDriver as JGPLEDriver
from gple_tpu.gp import opt as jopt
from gple_tpu.io import checkpoint as jckpt
from gple_tpu_torch import cli, convert
from gple_tpu_torch import observables as OBS
from gple_tpu_torch.config import GPLEConfig
from gple_tpu_torch.driver import GPLEDriver
from gple_tpu_torch.io import checkpoint as ckpt
from test_torch_driver import jax_window, snapshot
from test_torch_kernels import _warm_torch_exp  # noqa: F401 (fixture)
from test_torch_mc import JaxKeys
from test_torch_trajectory import INPUT


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The ladder is thousands of small tensor ops; with one process per
    core (the suite's workers) intra-op threads only contend for the cores.
    One thread per process for this module; the previous count after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

TOL_POINTS, TOL_RHO, TOL_ALPHA, TOL_RECORD = 1e-12, 1e-8, 1e-8, 1e-8
RUN = dict(model="DAC", mass=2000.0, x0=-10.0, p0=30.0, sigma_p0=1.5, output_time=1.0,
           reopt_time=2.0, dt=0.5, num_points=24)
FIELDS = ("tick", "key", "points", "rho", "active", "extra_points", "extra_rho",
          "diag_lengths", "off_params", "diag_magnitudes", "off_magnitude", "total_energy",
          "purity", "purity_ratio", "mc_steps", "mc_displacements", "al_lam", "opt_error",
          "opt_type", "coh_div_eff", "coh_k", "pop_sum0")


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A ``gple_tpu`` driver after 2 ticks and a scheduled reopt, and its file."""
    path = str(tmp_path_factory.mktemp("ckpt") / "jax.npz")
    drv = JGPLEDriver(JGPLEConfig(**RUN, fused_chunk=0))
    drv.initialize()
    for tick in (1, 2):
        drv.step(tick)
    jckpt.save_checkpoint(path, drv, 2)
    return drv, path


def _load(path):
    with np.load(path) as z:
        return {k: np.array(z[k]) for k in z.files}


def test_key_maps_to_the_seed_and_back():
    for seed in (0, 7, 2**32 + 5, 2**62 + 123456789):
        key = ckpt.key_from_seed(seed)
        assert key.dtype == np.uint32 and key.shape == (2,)
        assert ckpt.seed_from_key(key) == seed
        np.testing.assert_array_equal(key, np.asarray(jax.random.PRNGKey(seed)))
    # every JAX key, the top bit set too, maps to a seed and back
    key = np.array([0xFFFFFFFF, 3], dtype=np.uint32)
    np.testing.assert_array_equal(ckpt.key_from_seed(ckpt.seed_from_key(key)), key)


def test_jax_checkpoint_loads_into_the_port(jax_checkpoint):
    jd, path = jax_checkpoint
    td = GPLEDriver(convert.config_to_torch(jd.cfg), device="cpu")
    assert ckpt.load_checkpoint(path, td) == 2
    np.testing.assert_array_equal(td.density.points.numpy(), np.asarray(jd.density.points))
    np.testing.assert_array_equal(td.density.rho.numpy(), np.asarray(jd.density.rho))
    np.testing.assert_array_equal(td.extra.rho.numpy(), np.asarray(jd.extra.rho))
    np.testing.assert_array_equal(td.density.active.numpy(), np.asarray(jd.density.active))
    for name in ("diag_lengths", "off_params", "diag_magnitudes", "_al_lam"):
        np.testing.assert_array_equal(getattr(td.optimizer, name),
                                      np.asarray(getattr(jd.optimizer, name)), err_msg=name)
    assert td.optimizer.off_magnitude == jd.optimizer.off_magnitude
    assert (td.total_energy, td.purity, td.purity_ratio, td._pop_sum0) == \
        (jd.total_energy, jd.purity, jd.purity_ratio, jd._pop_sum0)
    assert [(p.num_steps, p.displacement) for p in td.mc_params] == \
        [(p.num_steps, p.displacement) for p in jd.mc_params]
    assert td.rng.seed == ckpt.seed_from_key(np.asarray(jd.key))
    assert (td.opt_result.error, td.opt_result.opt_type) == (jd.opt_result.error,
                                                             jd.opt_result.opt_type)
    assert td.density.points.is_inference()


def test_port_checkpoint_loads_into_jax(jax_checkpoint, tmp_path):
    jd, path = jax_checkpoint
    td = GPLEDriver(convert.config_to_torch(jd.cfg), device="cpu")
    ckpt.load_checkpoint(path, td)
    ours = str(tmp_path / "port.npz")
    ckpt.save_checkpoint(ours, td, 2)
    mine, theirs = _load(ours), _load(path)
    assert sorted(mine) == sorted(theirs) == sorted(FIELDS)
    for k in FIELDS:
        assert mine[k].dtype == theirs[k].dtype and mine[k].shape == theirs[k].shape, k
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
    back = JGPLEDriver(jd.cfg)
    assert jckpt.load_checkpoint(ours, back) == 2
    np.testing.assert_array_equal(np.asarray(back.density.rho), np.asarray(jd.density.rho))
    np.testing.assert_array_equal(np.asarray(back.key), np.asarray(jd.key))
    np.testing.assert_array_equal(back.optimizer._al_lam, jd.optimizer._al_lam)


def test_deterministic_window_from_a_jax_checkpoint(jax_checkpoint):
    """No reopt in the window (reopt every 10 ticks): no random draw, so the
    port and JAX, both restored from one file, advance in step."""
    _, path = jax_checkpoint
    cfg = JGPLEConfig(**dict(RUN, reopt_time=5.0), fused_chunk=0)
    jd = JGPLEDriver(cfg)
    td = GPLEDriver(convert.config_to_torch(cfg), device="cpu")
    assert jckpt.load_checkpoint(path, jd) == ckpt.load_checkpoint(path, td) == 2
    for tick in range(3, 9):
        assert td.step(tick) == jd.step(tick) == "none"
        ours, theirs = snapshot(td), snapshot(jd)
        for key, tol in (("points", TOL_POINTS), ("extra_points", TOL_POINTS),
                         ("rho", TOL_RHO), ("extra_rho", TOL_RHO), ("alpha", TOL_ALPHA),
                         ("v", TOL_ALPHA)):
            np.testing.assert_allclose(ours[key], theirs[key], rtol=0, atol=tol,
                                       err_msg=f"tick {tick}: {key}")


def test_resume_equivalence(tmp_path):
    """2k ticks straight vs k + checkpoint/reload + k: populations must match."""
    cfg = GPLEConfig(**RUN)
    k = 2
    straight = GPLEDriver(cfg, device="cpu")
    straight.initialize()
    for tick in range(1, 2 * k + 1):
        straight.step(tick)
    first = GPLEDriver(cfg, device="cpu")
    first.initialize()
    for tick in range(1, k + 1):
        first.step(tick)
    path = str(tmp_path / "mid.npz")
    ckpt.save_checkpoint(path, first, k)
    resumed = GPLEDriver(cfg, device="cpu")
    tick = ckpt.load_checkpoint(path, resumed)
    # the port's own key survives the round trip: the streams are the same
    assert resumed.rng.seed == first.rng.seed
    for t in range(tick + 1, 2 * k + 1):
        resumed.step(t)
    np.testing.assert_allclose(OBS.population_each_surface(resumed.density).numpy(),
                               OBS.population_each_surface(straight.density).numpy(),
                               rtol=0, atol=5e-3)
    assert resumed.opt_result.opt_type != ""


def test_run_with_checkpointing(tmp_path):
    cfg = GPLEConfig(**RUN)
    path = str(tmp_path / "ck.npz")
    drv = GPLEDriver(cfg, device="cpu")
    drv.run(max_ticks=4, checkpoint_path=path, checkpoint_every=2)
    assert os.path.exists(path) and int(_load(path)["tick"]) == 4
    drv2 = GPLEDriver(cfg, device="cpu")
    hist = drv2.run(max_ticks=6, resume_from=path)
    assert [rec.time for rec in hist] == [3.0]     # the output at tick 6
    assert np.isfinite(hist[-1].population_prm)


# -- the reference_parity window --------------------------------------------------------

RP_RUN = dict(model="DAC", mass=2000.0, x0=-10.0, p0=30.0, sigma_p0=1.5, output_time=0.5,
              reopt_time=1.0, dt=0.5, num_points=32, opt_steps_initial=4,
              opt_steps_reopt=3, fused_chunk=0, reference_parity=True)
RP_TICKS = 4


@pytest.fixture(scope="module")
def parity_window(tmp_path_factory):
    jax.clear_caches()
    saved = jopt._lbfgs_scan
    jopt._lbfgs_scan = jopt._lbfgs_fixed_fan
    try:
        out_j = str(tmp_path_factory.mktemp("rp_jax"))
        out_t = str(tmp_path_factory.mktemp("rp_port"))
        jd = JGPLEDriver(JGPLEConfig(**RP_RUN), outdir=out_j)
        jd.initialize()
        td = convert.driver_to_torch(jd, "cpu", rng=JaxKeys(jd.key), outdir=out_t)
        frames = {"jax": [], "port": []}
        for name, drv in (("jax", jd), ("port", td)):
            drv.observe(0, drv.opt_result.opt_type)
            frames[name].append(snapshot(drv))
            if name == "jax":
                jax_window(drv, RP_TICKS, lambda rec, d=drv: frames["jax"].append(snapshot(d)))
            else:
                drv._advance(1, RP_TICKS,
                             lambda rec, d=drv: frames["port"].append(snapshot(d)))
            drv.writers.close()
    finally:
        jopt._lbfgs_scan = saved
        jax.clear_caches()
    return jd, td, frames


def test_reference_parity_window_matches(parity_window):
    jd, td, frames = parity_window
    assert td.cfg.evolve_cutoff is True and td.cfg.purity_target == "initial"
    assert td.optimizer.corr_bounds == (1.0, 1.0) and td.optimizer.off_params[-1] == 1.0
    assert [h.opt_type for h in td.history] == [h.opt_type for h in jd.history]
    assert "local_previous" in [h.opt_type for h in td.history[1:]]
    for i, (ours, theirs) in enumerate(zip(td.history, jd.history)):
        for field in ("population_prm", "population_mci", "energy_prm", "purity_prm",
                      "purity_mci", "x_average"):
            np.testing.assert_allclose(getattr(ours, field), getattr(theirs, field),
                                       rtol=TOL_RECORD, err_msg=f"record {i}: {field}")
    assert len(frames["port"]) == len(frames["jax"]) == RP_TICKS + 1
    for i, (ours, theirs) in enumerate(zip(frames["port"], frames["jax"])):
        for key, tol in (("points", TOL_POINTS), ("extra_points", TOL_POINTS),
                         ("rho", TOL_RHO), ("extra_rho", TOL_RHO), ("alpha", TOL_ALPHA)):
            np.testing.assert_allclose(ours[key], theirs[key], rtol=0, atol=tol,
                                       err_msg=f"output {i}: {key}")
        np.testing.assert_allclose(ours["v"], theirs["v"], rtol=0,
                                   atol=TOL_ALPHA * np.abs(theirs["v"]).max(),
                                   err_msg=f"output {i}: v")
    np.testing.assert_allclose(td.optimizer.diag_lengths, jd.optimizer.diag_lengths, rtol=1e-8)
    np.testing.assert_allclose(td.optimizer._al_lam, jd.optimizer._al_lam, rtol=1e-6,
                               atol=1e-6 * np.abs(jd.optimizer._al_lam).max())
    np.testing.assert_array_equal(np.asarray(td.rng.key), np.asarray(jd.key))


# -- the CLI -------------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [["--opt-mode", "ladder"], ["--reference-parity"]])
def test_cli_runs_the_ladder_on_the_cpu(tmp_path, capsys, flags):
    (tmp_path / "input").write_text(INPUT)
    rc = cli.main(["gple", "--input", str(tmp_path / "input"), "--outdir",
                   str(tmp_path / "out"), "--device", "cpu", "--max-ticks", "1", "--quiet",
                   *flags])
    assert rc == 0
    last = capsys.readouterr().out.strip().splitlines()[-1].split()
    assert len(last) == 3 and float(last[1]) == pytest.approx(1.0, abs=1e-3)
    log = (tmp_path / "out" / "run.log").read_text().split()
    assert "local_previous" in log or "local_initial" in log or "global" in log


def test_cli_checkpoints_and_resumes(tmp_path, capsys):
    (tmp_path / "input").write_text(INPUT)
    base = ["gple", "--input", str(tmp_path / "input"), "--device", "cpu", "--quiet"]
    path = str(tmp_path / "ck.npz")
    assert cli.main(base + ["--outdir", str(tmp_path / "a"), "--max-ticks", "2",
                            "--checkpoint", path, "--checkpoint-every", "1"]) == 0
    assert int(_load(path)["tick"]) == 2
    assert cli.main(base + ["--outdir", str(tmp_path / "b"), "--max-ticks", "4",
                            "--resume", path]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1].split()
    assert float(last[1]) == pytest.approx(1.0, abs=1e-3)
    assert np.loadtxt(tmp_path / "b" / "ave.txt", ndmin=2).shape[0] == 1
