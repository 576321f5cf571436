"""PyTorch port: the trajectory driver's device functions, CLI and crossing gate.

* ``_surrogate_grid`` / ``_surrogate_dist`` (the re-selection walk's target)
  1e-10 relative to the grid's largest value; ``_cloud_drift_flags`` equal;
  ``_grid_predictions`` (output-grid cutoff predictions and variances) 1e-8
  relative to each array's largest value; ``_reopt_epilogue`` with draws
  replayed from JAX keys 1e-8 (points 1e-12) -- each against ``gple_tpu.driver``
  on the same states.
* ``python -m gple_tpu_torch.cli gple --device cpu`` end to end at N = 16;
  ``se`` and ``le --device cpu`` at a small input against ``gple_tpu.cli``
  on the same input: the same files, the grids and times byte for byte, the
  values 1e-9 relative to each file's largest.
* The committed DVR table ``gple_tpu_torch/data/sac_crossing_dvr.json``
  regenerated by ``gple_tpu``'s ``DVRSolver`` and by the port's (1e-10).  To
  rewrite it: ``PYTHONPATH=. python tests/test_torch_trajectory.py``.
* The committed table of the reference band's DVR populations
  ``gple_tpu_torch/data/parity_dvr.json`` (``gple_tpu``'s ``DVRSolver`` on
  ``entry.parity_config``'s physics for SAC, DAC and ECR): its form, and
  every model regenerated by ``gple_tpu`` (1e-10; ~10 s for the three on
  the CPU); on the card all three against the port's DVR.
  ``PYTHONPATH=. python tests/test_torch_trajectory.py parity`` rewrites
  it.  And ``entry.parity_rmse``'s alignment rules.
* Crossing gate (marked ``slow``): the port on the CPU through
  ``tests/test_crossing.py``'s config and assertions.
"""

import filecmp
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gple_tpu import driver as JD
from gple_tpu.storage import Density as JDensity
from gple_tpu_torch import cli, convert
from gple_tpu_torch import driver as TD
from gple_tpu_torch.entry import (PARITY_ROWS, crossing_config, crossing_dvr_config,
                                  dvr_config_for, parity_config, parity_rmse,
                                  trajectory_config)
from gple_tpu_torch.oracles import DVRSolver
from test_torch_kernels import _warm_torch_exp, one_torch_thread  # noqa: F401 (fixtures)
from test_torch_mc import JaxKeys
from test_torch_observables import both_states, random_clouds

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DVR_TABLE = os.path.join(REPO, "gple_tpu_torch", "data", "sac_crossing_dvr.json")
PARITY_TABLE = os.path.join(REPO, "gple_tpu_torch", "data", "parity_dvr.json")
MODEL, MASS, DT = "SAC", 2000.0, 1.0


@pytest.fixture(scope="module")
def states():
    return both_states(21, 32, (True, True, True))


def test_surrogate_grid_and_interpolation_match(states):
    """Element (1, 0): its backward prediction reads every element's fit."""
    jd, jg, td, tg = states
    elem = 1
    lo, hi = np.array([-11.5, 26.0]), np.array([-8.5, 34.0])
    jgrid = np.asarray(JD._surrogate_grid(MODEL, MASS, DT, elem, False, jg, jnp.asarray(lo),
                                          jnp.asarray(hi)))
    tgrid = TD._surrogate_grid(MODEL, MASS, DT, elem, tg, torch.tensor(lo), torch.tensor(hi))
    assert tgrid.shape == (TD._SURR_RES, TD._SURR_RES)
    scale = np.abs(jgrid).max()
    assert scale > 0
    np.testing.assert_allclose(tgrid.numpy(), jgrid, rtol=0, atol=1e-10 * scale)
    # inside, on and outside the box
    rng = np.random.default_rng(3)
    q = np.concatenate([lo + rng.uniform(-0.1, 1.1, size=(200, 2)) * (hi - lo), [lo, hi]])
    jw = np.asarray(JD._surrogate_dist((jnp.asarray(jgrid), jnp.asarray(lo), jnp.asarray(hi)),
                                       jnp.asarray(q)))
    tw = TD._surrogate_dist((torch.tensor(jgrid), torch.tensor(lo), torch.tensor(hi)),
                            torch.tensor(q)).numpy()
    np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-10 * scale)
    assert np.any(tw[:, 0] == 0.0) and np.any(tw[:, 0] > 0.0)


def test_element_distributions_match(states):
    jd, jg, td, tg = states
    q = np.asarray(jd.points[1]) + 0.05
    for elem in range(3):
        for jdist, tdist in ((JD.GP_DIST_ELEMS[elem], TD.GP_DIST_ELEMS[elem]),
                             (JD.GP_DIST_ELEMS_NOCUT[elem], TD.GP_DIST_ELEMS_NOCUT[elem])):
            theirs = np.asarray(jdist(jg, jnp.asarray(q)))
            np.testing.assert_allclose(tdist(tg, torch.tensor(q)).numpy(), theirs, rtol=0,
                                       atol=1e-8 * np.abs(theirs).max())
    params_j = tuple(jnp.asarray(v) for v in ([-10.0, 30.0], [1 / 3, 1.5], [1.0, 0.0],
                                                [0.0, 0.0]))
    params_t = tuple(torch.tensor(np.asarray(v)) for v in params_j)
    np.testing.assert_allclose(TD.init_dist_all(params_t, td.points).numpy(),
                               np.asarray(JD.init_dist_all(params_j, jd.points)), rtol=1e-12,
                               atol=1e-300)


def test_cloud_drift_flags_match():
    pts, rho, act = random_clouds(22, 40, (True, True, True))
    # pull element 2's labels off its cloud centre (a half-sigma drift and more)
    rho[2, :, 0] *= np.exp(2.0 * (pts[2, :, 0] - pts[2, :, 0].mean()) / pts[2, :, 0].std())
    for active in ((True, True, True), (True, False, True), (True, True, False)):
        jd = JDensity(points=jnp.asarray(pts), rho=jnp.asarray(rho),
                      active=jnp.asarray(active))
        flags = TD._cloud_drift_flags(convert.to_torch(jd, "cpu")).numpy()
        np.testing.assert_array_equal(flags, np.asarray(JD._cloud_drift_flags(jd)))
        assert flags[2] == active[2]


@pytest.mark.parametrize("active", [(True, True, True), (True, False, True)])
def test_grid_predictions_match(active):
    jd, jg, td, tg = both_states(23, 32, active)
    grid = trajectory_config(32).phase_grids()[::97]
    jp, jv = JD._grid_predictions(MODEL, jg, jnp.asarray(grid))
    tp, tv = TD._grid_predictions(tg, torch.tensor(grid))
    for ours, theirs in ((tp, jp), (tv, jv)):
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=0,
                                   atol=1e-8 * np.abs(theirs).max())
    if not active[1]:
        assert not tp[1].any() and not tv[1].any()


@pytest.mark.parametrize("active", [(True, True, True), (True, False, False)])
def test_reopt_epilogue_replays_jax(active):
    jd, jg, _, _ = both_states(24, 32, active)
    je = JDensity(points=jd.points, rho=jd.rho, active=jd.active)
    keys = jnp.stack([jax.random.PRNGKey(30 + k) if active[k] else jnp.zeros(2, jnp.uint32)
                      for k in range(3)])
    n_extra = 5 * 32
    dparams, oparams = jg.diag.params, jg.offdiag.params
    jgps, jextra, jpop, jpur = JD._reopt_epilogue(False, 0, n_extra, jd, je, dparams, oparams,
                                                  keys, True)
    td = convert.to_torch(jd, "cpu")
    tgps, textra, tpop, tpur = TD._reopt_epilogue(
        False, 0, n_extra, td, td, convert.to_torch(dparams, "cpu"),
        convert.to_torch(oparams, "cpu"),
        [JaxKeys(keys[k]) if active[k] else None for k in range(3)], True)
    np.testing.assert_allclose(textra.points.numpy(), np.asarray(jextra.points), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(textra.rho.numpy(), np.asarray(jextra.rho), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(textra.active.numpy(), np.asarray(jextra.active))
    np.testing.assert_allclose(tgps.diag.alpha.numpy(), np.asarray(jgps.diag.alpha), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(tgps.offdiag.v.numpy(), np.asarray(jgps.offdiag.v), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose([tpop.item(), tpur.item()], [float(jpop), float(jpur)],
                               rtol=1e-8)


# -- the CLI -----------------------------------------------------------------------------

INPUT = """mass
2000
x0
-10
p0
30
sigma p0
1.5
output time
1
reoptimization time
1
dt
0.5
number of points
16
"""


def test_cli_runs_on_the_cpu(tmp_path, capsys):
    (tmp_path / "input").write_text(INPUT)
    out = tmp_path / "out"
    rc = cli.main(["gple", "--input", str(tmp_path / "input"), "--outdir", str(out),
                   "--device", "cpu", "--max-ticks", "2", "--quiet"])
    assert rc == 0
    assert sorted(os.listdir(out)) == sorted(
        ["ave.txt", "param.txt", "coord.txt", "value.txt", "phase.txt", "var.txt",
         "run.log"])
    assert np.loadtxt(out / "ave.txt").shape[0] == 2        # t = 0 and t = 1
    last = capsys.readouterr().out.strip().splitlines()[-1].split()
    assert len(last) == 3 and float(last[1]) == pytest.approx(1.0, abs=1e-3)


ORACLE_INPUT = INPUT.replace("x0\n-10\np0\n30\nsigma p0\n1.5\n",
                             "x0\n-2\np0\n20\nsigma p0\n1\n")


@pytest.mark.parametrize("argv", [["se", "--boundary", "absorbing", "--no-wigner"], ["le"]],
                         ids=["se", "le"])
def test_cli_runs_the_oracles_on_the_cpu(argv, tmp_path, capsys, monkeypatch):
    """SAC from x0 = -2 at p0 = 20, three outputs, through both CLIs."""
    from gple_tpu import cli as jax_cli
    from gple_tpu.utils import cache

    (tmp_path / "input").write_text(ORACLE_INPUT)
    args = [argv[0], "--input", str(tmp_path / "input"), "--model", "SAC",
            "--max-outputs", "3", *argv[1:]]
    assert cli._parser().parse_args(args).device == "cuda"       # the default
    assert cli.main(args + ["--outdir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    ours = capsys.readouterr().out.strip().splitlines()[-1].split()
    monkeypatch.setattr(cache, "enable_persistent_cache", lambda *a, **k: None)
    assert jax_cli.main(args + ["--outdir", str(tmp_path / "jax")]) == 0
    theirs = capsys.readouterr().out.strip().splitlines()[-1].split()
    assert ours[0] == theirs[0] == "20.0"
    np.testing.assert_allclose(np.array(ours[1:], float), np.array(theirs[1:], float),
                               rtol=0, atol=1e-9)            # populations sum to 1
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        a, b = tmp_path / "port" / name, tmp_path / "jax" / name
        if name in ("x.txt", "p.txt", "t.txt"):
            assert filecmp.cmp(a, b, shallow=False), name
        else:
            ref = np.loadtxt(b)
            np.testing.assert_allclose(np.loadtxt(a), ref, rtol=0,
                                       atol=1e-9 * np.abs(ref).max(), err_msg=name)
    assert np.loadtxt(tmp_path / "port" / "averages.txt").shape[0] == 3


# -- DVR reference table and the crossing gate ---------------------------------------------

def dvr_table():
    """``gple_tpu``'s exact DVR populations on the crossing config
    (``tests/test_crossing.py:32-37``)."""
    from gple_tpu.oracles.schrodinger import DVRConfig, DVRSolver

    se = DVRSolver(DVRConfig(**vars(crossing_dvr_config()))).run(store_wigner=False)
    return dict(
        source="gple_tpu.oracles.schrodinger.DVRSolver on the tests/test_crossing.py config "
               "(SAC, reflective, mass 2000, x0 -2, p0 20, sigma_p 1, x in [-4, 4], "
               "dx 1, dt 1, output every 10); written by tests/test_torch_trajectory.py",
        times=[float(t) for t in se.times],
        populations=[[float(p) for p in row] for row in se.populations])


def test_dvr_table_matches_the_oracle():
    with open(DVR_TABLE) as f:
        stored = json.load(f)
    fresh = dvr_table()
    np.testing.assert_array_equal(stored["times"], fresh["times"])
    np.testing.assert_allclose(stored["populations"], fresh["populations"], rtol=0,
                               atol=1e-10)


def parity_dvr_tables(models=None):
    """``gple_tpu``'s exact DVR populations on ``entry.parity_config``'s
    physics (``benchmarks/parity.py:107-111``), one table a model."""
    from gple_tpu.oracles.schrodinger import DVRConfig, DVRSolver

    out = dict(source="gple_tpu.oracles.schrodinger.DVRSolver on entry.parity_config's "
                      "physics (mass 2000, x0 -4, p0 20, sigma_p 1, reflective, x in [-8, 8], "
                      "dx 1, dt 1, output every 10); written by tests/test_torch_trajectory.py")
    for model in models or sorted({row[0] for row in PARITY_ROWS}):
        cfg = DVRConfig(**vars(dvr_config_for(parity_config(model, 1))))
        se = DVRSolver(cfg).run(store_wigner=False)
        out[model] = dict(times=[float(t) for t in se.times],
                          populations=[[float(p) for p in row] for row in se.populations])
    return out


def test_parity_table_is_whole():
    """Every model of the band, from t = 0 at the output interval, starting
    on the lower surface, populations summing to 1."""
    with open(PARITY_TABLE) as f:
        table = json.load(f)
    for model in {row[0] for row in PARITY_ROWS}:
        times, pops = np.array(table[model]["times"]), np.array(table[model]["populations"])
        out = parity_config(model, 1).output_time
        np.testing.assert_array_equal(times, out * np.arange(len(times)))
        assert len(times) > 30 and pops.shape == (len(times), 2)
        np.testing.assert_allclose(pops[0], [1.0, 0.0], atol=1e-12)
        np.testing.assert_allclose(pops.sum(axis=1), 1.0, atol=1e-9)


@pytest.mark.parametrize("model", sorted({row[0] for row in PARITY_ROWS}))
def test_parity_table_matches_the_oracle(model):
    """The committed band table holds ``gple_tpu``'s DVR values, computed
    afresh here with the JAX package."""
    with open(PARITY_TABLE) as f:
        stored = json.load(f)[model]
    fresh = parity_dvr_tables([model])[model]
    np.testing.assert_array_equal(stored["times"], fresh["times"])
    np.testing.assert_allclose(stored["populations"], fresh["populations"], rtol=0,
                               atol=1e-10)


def test_parity_rmse_follows_the_parity_script():
    """Frames past the DVR's last time are not compared (side="right"), the
    DVR is interpolated at the run's times, and the two estimators are read
    from ``population_mci[0]`` and ``population_prm_each[0]``."""
    dvr_t = np.array([0.0, 10.0, 20.0])
    dvr_p = np.array([[1.0, 0.0], [0.8, 0.2], [0.6, 0.4]])
    hist = [TD.TickRecord(time=t, population_prm=1.0, population_prm_each=np.array([m, 1 - m]),
                          population_mci=np.array([m + d, 1 - m - d]), energy_prm=0.0,
                          energy_mci=0.0, purity_prm=1.0, purity_mci=1.0, x_average=0.0,
                          opt_type="none")
            for t, m, d in ((0.0, 1.0, 0.0), (5.0, 0.9, 0.03), (20.0, 0.6, -0.04),
                            (30.0, 0.0, 0.5))]
    out = parity_rmse(hist, dvr_t, dvr_p)
    assert out["frames_compared"] == 3
    assert out["rmse_prm"] == 0.0
    np.testing.assert_allclose(out["rmse_mci"], np.sqrt((0.03**2 + 0.04**2) / 3), rtol=1e-14)


def test_port_dvr_reproduces_the_table():
    """The crossing gate's reference from the port's own DVR oracle."""
    with open(DVR_TABLE) as f:
        stored = json.load(f)
    ours = DVRSolver(crossing_dvr_config(), "cpu").run(store_wigner=False)
    np.testing.assert_array_equal(ours.times, stored["times"])
    np.testing.assert_allclose(ours.populations, stored["populations"], rtol=0, atol=1e-10)


@pytest.mark.slow
def test_crossing_gate_on_the_cpu():
    """``tests/test_crossing.py`` through the port (about as long as that run)."""
    drv = TD.GPLEDriver(crossing_config(), device="cpu")
    hist = drv.run(max_ticks=240)
    with open(DVR_TABLE) as f:
        table = json.load(f)
    times, pops = np.array(table["times"]), np.array(table["populations"])
    assert hist[-1].population_mci[1] > 0.25
    assert np.all(drv.density.active.numpy())
    gt = np.array([r.time for r in hist])
    gp0 = np.array([r.population_mci[0] for r in hist])
    sp0 = np.interp(gt, times, pops[:, 0])
    rmse = float(np.sqrt(np.mean((gp0 - sp0) ** 2)))
    print(f"crossing on the CPU: RMSE vs DVR {rmse!r}, stats {drv.stats}, "
          f"final populations {hist[-1].population_mci.tolist()}")
    assert rmse < 0.055, rmse
    assert abs(gp0[-1] - sp0[-1]) < 0.09
    assert drv.stats["element_activations"] >= 2
    assert drv.stats["cloud_reselections"] >= 1
    pop = np.array([r.population_mci.sum() for r in hist])
    assert np.all(np.abs(pop - 1.0) < 0.12), float(np.max(np.abs(pop - 1.0)))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import conftest  # noqa: F401  (JAX on the CPU in float64)

    path, table = ((PARITY_TABLE, parity_dvr_tables()) if sys.argv[1:] == ["parity"]
                   else (DVR_TABLE, dvr_table()))
    with open(path, "w") as f:
        json.dump(table, f, indent=1)
        f.write("\n")
    print(f"wrote {path}")
