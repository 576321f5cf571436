"""PyTorch port: the plotting suite over the port's own outputs.

``tests/test_plotting.py``'s four tests on the port's driver and DVR outputs
at the same configs; every one of the nine functions run by
``gple_tpu.plotting`` and by ``gple_tpu_torch.plotting`` on the same files
gives the same pixels; and nothing else of the port needs matplotlib.
"""

import os
import subprocess
import sys

import matplotlib.image as mpimg
import numpy as np
import pytest
from PIL import Image, ImageSequence

from gple_tpu import plotting as JP
from gple_tpu_torch import plotting as P
from gple_tpu_torch.config import GPLEConfig
from gple_tpu_torch.driver import GPLEDriver
from gple_tpu_torch.oracles.schrodinger import DVRConfig, DVRSolver
from test_torch_kernels import _warm_torch_exp, one_torch_thread  # noqa: F401 (fixtures)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DVR = dict(model="SAC", boundary="reflective", mass=2000.0, x0=-3.0, p0=25.0, sigma_p=1.0,
           xmin=-5.0, xmax=5.0, dx_input=1.0, output_time=50.0, dt_input=0.5)


@pytest.fixture(scope="module")
def run_outputs(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("plot_run"))
    cfg = GPLEConfig(model="DAC", mass=2000.0, x0=-10.0, p0=30.0, sigma_p0=1.5,
                     output_time=1.0, reopt_time=2.0, dt=0.5, num_points=24)
    GPLEDriver(cfg, outdir=outdir, device="cpu").run(max_ticks=4)
    return cfg, outdir


@pytest.fixture(scope="module")
def dvr_outputs(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("plot_dvr")
    res = DVRSolver(DVRConfig(**DVR), device="cpu").run(store_wigner=False, max_outputs=3)
    res.save_txt(str(outdir))
    return outdir


def test_gple_plots(run_outputs, tmp_path):
    cfg, outdir = run_outputs
    p1 = P.plot_averages(os.path.join(outdir, "ave.txt"), str(tmp_path / "ave.png"))
    p2 = P.plot_gple_log(os.path.join(outdir, "run.log"), str(tmp_path / "log.png"))
    p3 = P.plot_parameters(os.path.join(outdir, "param.txt"), str(tmp_path / "par.png"))
    p4 = P.plot_point_cloud(
        os.path.join(outdir, "coord.txt"), os.path.join(outdir, "value.txt"),
        str(tmp_path / "cloud.png"),
    )
    frames = P.plot_phase_space_frames(
        os.path.join(outdir, "phase.txt"), cfg.num_grids_per_dim,
        str(tmp_path / "frames"), max_frames=1,
    )
    for f in [p1, p2, p3, p4] + frames:
        assert os.path.getsize(f) > 1000


def test_animations(run_outputs, tmp_path):
    cfg, outdir = run_outputs
    g1 = P.animate_point_cloud(
        os.path.join(outdir, "coord.txt"), os.path.join(outdir, "value.txt"),
        str(tmp_path / "cloud.gif"), max_frames=2,
    )
    g2 = P.animate_phase_space(
        os.path.join(outdir, "phase.txt"), cfg.num_grids_per_dim,
        str(tmp_path / "phase.gif"), max_frames=2,
    )
    g3 = P.animate_phase_space(
        os.path.join(outdir, "var.txt"), cfg.num_grids_per_dim,
        str(tmp_path / "var.gif"), log_scale=True, max_frames=2,
    )
    for f in (g1, g2, g3):
        assert os.path.getsize(f) > 1000


def test_psi_animation(tmp_path):
    res = DVRSolver(DVRConfig(**DVR), device="cpu").run(store_wigner=False, max_outputs=2)
    res.save_txt(str(tmp_path))
    gif = P.animate_psi(str(tmp_path), str(tmp_path / "psi.gif"), max_frames=2)
    assert os.path.getsize(gif) > 1000


def test_oracle_plot(dvr_outputs, tmp_path):
    png = P.plot_oracle_averages(str(dvr_outputs / "averages.txt"), str(tmp_path / "a.png"))
    assert os.path.getsize(png) > 1000


def _calls(cfg, outdir, dvr_dir, to):
    """Each of the nine functions on the same inputs, writing under ``to``."""
    run = lambda name: os.path.join(outdir, name)  # noqa: E731
    n_grid = cfg.num_grids_per_dim
    return {
        "plot_averages": lambda M: M.plot_averages(run("ave.txt"), to("ave.png")),
        "plot_gple_log": lambda M: M.plot_gple_log(run("run.log"), to("log.png")),
        "plot_parameters": lambda M: M.plot_parameters(run("param.txt"), to("par.png")),
        "plot_point_cloud": lambda M: M.plot_point_cloud(run("coord.txt"), run("value.txt"),
                                                         to("cloud.png")),
        "plot_phase_space_frames": lambda M: M.plot_phase_space_frames(
            run("phase.txt"), n_grid, to("frames"), max_frames=2),
        "animate_point_cloud": lambda M: M.animate_point_cloud(
            run("coord.txt"), run("value.txt"), to("cloud.gif"), max_frames=2),
        "animate_phase_space": lambda M: M.animate_phase_space(
            run("var.txt"), n_grid, to("var.gif"), log_scale=True, max_frames=2),
        "animate_psi": lambda M: M.animate_psi(str(dvr_dir), to("psi.gif"), max_frames=2),
        "plot_oracle_averages": lambda M: M.plot_oracle_averages(
            str(dvr_dir / "averages.txt"), to("oracle.png")),
    }


def _pixels(path):
    if path.endswith(".gif"):
        with Image.open(path) as im:
            return [np.asarray(frame.convert("RGBA")) for frame in ImageSequence.Iterator(im)]
    return [mpimg.imread(path)]


@pytest.mark.parametrize("name", sorted(P.__all__))
def test_pixels_match_the_jax_package(name, run_outputs, dvr_outputs, tmp_path):
    cfg, outdir = run_outputs
    files = {}
    for tag, module in (("jax", JP), ("port", P)):
        (tmp_path / tag).mkdir()
        call = _calls(cfg, outdir, dvr_outputs, lambda f, t=tag: str(tmp_path / t / f))[name]
        out = call(module)
        files[tag] = out if isinstance(out, list) else [out]
    assert len(files["port"]) == len(files["jax"]) >= 1
    for ours, theirs in zip(files["port"], files["jax"]):
        a, b = _pixels(ours), _pixels(theirs)
        assert len(a) == len(b) >= 1
        for fa, fb in zip(a, b):
            np.testing.assert_array_equal(fa, fb)


def test_the_port_imports_without_matplotlib():
    """With matplotlib unimportable, the package, its CLI, the driver, the
    sharding, the entry points and ``chip_smoke.py`` still import; only the
    plotting package needs it."""
    code = """
import sys
sys.modules["matplotlib"] = None
import gple_tpu_torch, gple_tpu_torch.cli, gple_tpu_torch.driver
import gple_tpu_torch.parallel.sharding, gple_tpu_torch.entry
import chip_smoke
try:
    import gple_tpu_torch.plotting
except ImportError:
    print("plotting needs matplotlib")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "plotting needs matplotlib"
