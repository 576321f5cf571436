"""PyTorch port: the ECR gate of ``tests/test_ecr_parity.py`` on the CPU.

Tully model C (ECR, extended coupling with reflection) at x0 = -2, p0 = 20,
N = 64 with the moment defaults, through the port's ``GPLEDriver.run`` for
400 ticks on the CPU, against the port's own DVR oracle (reflective box,
``dx_input = 1``): the Monte-Carlo population of the lower surface within
1e-3 RMSE of the exact one, and the total population within 2% of 1 at
every output.  The same protocol as the JAX package's gate.
"""

import numpy as np
import pytest

from gple_tpu_torch.config import GPLEConfig
from gple_tpu_torch.driver import GPLEDriver
from gple_tpu_torch.oracles.schrodinger import DVRConfig, DVRSolver
from test_torch_kernels import _warm_torch_exp, one_torch_thread  # noqa: F401 (fixtures)

ECR_RUN = dict(model="ECR", mass=2000.0, x0=-2.0, p0=20.0, sigma_p0=1.0, output_time=10.0,
               reopt_time=10.0, dt=1.0, num_points=64)
ECR_TICKS = 400


@pytest.fixture(scope="module")
def ecr_run():
    cfg = GPLEConfig(**ECR_RUN)
    se_cfg = DVRConfig(model="ECR", boundary="reflective", mass=cfg.mass, x0=cfg.x0,
                       p0=cfg.p0, sigma_p=cfg.sigma_p0, xmin=cfg.xmin, xmax=cfg.xmax,
                       dx_input=1.0, output_time=cfg.output_time, dt_input=cfg.dt)
    se = DVRSolver(se_cfg, "cpu").run(store_wigner=False)
    drv = GPLEDriver(cfg, device="cpu")
    hist = drv.run(max_ticks=ECR_TICKS)
    return drv, hist, se


def ecr_rmse(hist, se) -> float:
    """The lower surface's MC population against the DVR's, over the outputs
    the DVR covers (``tests/test_ecr_parity.py``'s estimator)."""
    gt = np.array([r.time for r in hist])
    gp0 = np.array([r.population_mci[0] for r in hist])
    sp0 = np.interp(gt, se.times, se.populations[:, 0])
    n_cmp = min(len(gt), int(np.searchsorted(gt, se.times[-1]) + 1))
    return float(np.sqrt(np.mean((gp0[:n_cmp] - sp0[:n_cmp]) ** 2)))


def test_ecr_below_baseline_target(ecr_run):
    _, hist, se = ecr_run
    rmse = ecr_rmse(hist, se)
    assert rmse < 1e-3, f"ECR parity past the BASELINE target: {rmse:.2e}"


def test_ecr_conservation(ecr_run):
    _, hist, _ = ecr_run
    pop = np.array([r.population_mci.sum() for r in hist])
    assert len(hist) > 1
    assert np.all(np.abs(pop - 1.0) < 0.02), float(np.max(np.abs(pop - 1.0)))
