"""Example state of the flagship workload (counterpart of ``__graft_entry__``).

:func:`example_state` builds the state that ``__graft_entry__._example_state``
builds: a Tully-A Gaussian cloud at r0 = (-10, 30) with widths (1/3, 1.5)
sampled once and shared by all three elements, the initial density on it,
and the block-diagonal GP fit.  :func:`example_extra` builds the driver's
extra cloud (5N points per element) the same way.

Random points are drawn on the CPU from ``generator`` and then moved to
``device``, so one seed gives the same state on every device.  ``pts0``
replaces the draw (the tests pass the JAX package's points).

:func:`trajectory_config` is the production trajectory of the same workload
for :class:`gple_tpu_torch.driver.GPLEDriver`, and :func:`crossing_config`
the crossing-region regression trajectory of ``tests/test_crossing.py``;
:func:`crossing_dvr_config` is the exact DVR oracle's configuration of the
same physics, whose populations the crossing trajectory is held against.
:func:`booster_config` runs the crossing physics with the coherence booster
and every other default-off flag of the driver.  :func:`parity_config` is a
whole trajectory of the reference band (``PARITY_ROWS``), held against the
DVR by :func:`parity_rmse`.
"""

from __future__ import annotations

import numpy as np
import torch

from gple_tpu_torch.config import GPLEConfig
from gple_tpu_torch.ops import complex_kernels as CK
from gple_tpu_torch.ops import kernels as RK
from gple_tpu_torch.oracles.schrodinger import DVRConfig
from gple_tpu_torch.sampler import mc
from gple_tpu_torch.storage import Density, fit_gp_states

R0 = (-10.0, 30.0)
SIGMA = (1.0 / 3.0, 1.5)


def _cloud(n_points: int, device, generator, pts0) -> Density:
    r0 = torch.tensor(R0, dtype=torch.float64, device=device)
    sigma = torch.tensor(SIGMA, dtype=torch.float64, device=device)
    if pts0 is None:
        draw = torch.randn((n_points, 2), generator=generator, dtype=torch.float64)
        pts0 = r0 + draw.to(device) * sigma
    elif isinstance(pts0, torch.Tensor):
        pts0 = pts0.to(device=device, dtype=torch.float64)
    else:
        pts0 = torch.tensor(pts0, dtype=torch.float64, device=device)
    rho0 = mc.initial_distribution(r0, sigma, pts0, 0, 0, (1.0, 0.0), (0.0, 0.0))
    small = 1e-3 * rho0
    off = torch.stack([torch.zeros_like(small[:, 0]), small[:, 0]], dim=-1)  # imaginary
    return Density(
        points=torch.stack([pts0, pts0, pts0]),
        rho=torch.stack([rho0, off, small]),
        active=torch.ones(3, dtype=torch.bool, device=device),
    )


def example_params(device):
    """The example's (diagonal KernelParams (batched over 2), ComplexKernelParams)."""
    def f64(v):
        return torch.as_tensor(v, dtype=torch.float64, device=device)

    sigma = f64(SIGMA)
    diag_params = RK.KernelParams(
        magnitude=f64([1.0, 1.0]), lengths=sigma.expand(2, 2).clone(),
        noise=f64([1e-2, 1e-2]),
    )
    off_params = CK.ComplexKernelParams(
        magnitude=f64(1.0), real_magnitude=f64(1.0), real_lengths=sigma.clone(),
        imag_magnitude=f64(1.0), imag_lengths=sigma.clone(), noise=f64(1e-2),
        # corr = 0 is the production (moment-optimizer) structure that the
        # block-diagonal fit requires
        corr=f64(0.0),
    )
    return diag_params, off_params


def example_state(n_points: int, device, generator=None, pts0=None):
    """(Density, GPStates) of the flagship Tully-A example with ``n_points``
    points per element, on ``device``."""
    density = _cloud(n_points, device, generator, pts0)
    diag_params, off_params = example_params(device)
    with torch.inference_mode():
        gps = fit_gp_states(diag_params, off_params, density, block_diag=True)
    return density, gps


def example_extra(n_extra: int, device, generator=None, pts0=None) -> Density:
    """An extra cloud of ``n_extra`` points per element (the driver uses 5N),
    built like :func:`example_state`'s density."""
    return _cloud(n_extra, device, generator, pts0)


def trajectory_config(n_points: int = 1024) -> GPLEConfig:
    """The production Tully-A (SAC) trajectory: mass 2000, x0 = -10, p0 = 30,
    sigma_p0 = 1.5, dt = 1, an output and a scheduled reoptimization every 10
    ticks, ``n_points`` points per element, every other setting at its default."""
    return GPLEConfig(model="SAC", mass=2000.0, x0=-10.0, p0=30.0, sigma_p0=1.5,
                      output_time=10.0, reopt_time=10.0, dt=1.0, num_points=n_points)


def crossing_config() -> GPLEConfig:
    """The crossing-region trajectory (SAC from x0 = -2 at p0 = 20, sigma_p0 = 1,
    N = 64, outputs every 10 ticks, reoptimizations every 20): the packet goes
    through the avoided crossing and transfers population."""
    return GPLEConfig(model="SAC", mass=2000.0, x0=-2.0, p0=20.0, sigma_p0=1.0,
                      output_time=10.0, reopt_time=20.0, dt=1.0, num_points=64)


def dvr_config_for(cfg: GPLEConfig) -> DVRConfig:
    """The DVR oracle on a trajectory's physics: reflective walls on its
    interaction region, ``dx_input = 1``, outputs at its output times
    (``tests/test_crossing.py:32-37``, ``benchmarks/parity.py:107-111``)."""
    return DVRConfig(model=cfg.model, boundary="reflective", mass=cfg.mass, x0=cfg.x0,
                     p0=cfg.p0, sigma_p=cfg.sigma_p0, xmin=cfg.xmin, xmax=cfg.xmax,
                     dx_input=1.0, output_time=cfg.output_time, dt_input=cfg.dt)


def crossing_dvr_config() -> DVRConfig:
    """The DVR oracle on :func:`crossing_config`'s physics, as
    ``tests/test_crossing.py`` builds it."""
    return dvr_config_for(crossing_config())


#: the reference band's rows: (model, N, mci limit) -- 1.5x the JAX package's
#: round-5 RMSE against the DVR (``benchmarks/r05/README.md``; SAC N = 256:
#: the cold run's 0.075), in order of priority
PARITY_ROWS = (("SAC", 1024, 0.062), ("ECR", 256, 0.0017), ("SAC", 256, 0.113),
               ("DAC", 256, 0.079))


def parity_config(model: str, n_points: int) -> GPLEConfig:
    """A whole trajectory of the reference band (``benchmarks/parity.py``'s
    defaults): mass 2000, x0 = -4, p0 = 20, sigma_p0 = 1, dt 1, an output and
    a reoptimization every 10 ticks, ``n_points`` points per element, every
    other setting (the seed too) at its default; it runs until the packet
    leaves the interaction region, ~810 ticks."""
    return GPLEConfig(model=model, mass=2000.0, x0=-4.0, p0=20.0, sigma_p0=1.0, dt=1.0,
                      output_time=10.0, reopt_time=10.0, num_points=n_points)


def parity_rmse(hist, dvr_times, dvr_populations) -> dict:
    """Ground-state population RMSE of a run against the DVR's by both
    estimators, ``population_mci[0]`` and ``population_prm_each[0]``, with
    ``benchmarks/parity.py:129-138``'s rules: the DVR interpolated at the
    run's output times, frames compared up to the DVR's last time."""
    t = np.array([r.time for r in hist])
    mci = np.array([r.population_mci[0] for r in hist])
    prm = np.array([r.population_prm_each[0] for r in hist])
    exact = np.interp(t, dvr_times, np.asarray(dvr_populations)[:, 0])
    n = min(len(t), int(np.searchsorted(t, dvr_times[-1], side="right")))
    return dict(rmse_mci=float(np.sqrt(np.mean((mci[:n] - exact[:n]) ** 2))),
                rmse_prm=float(np.sqrt(np.mean((prm[:n] - exact[:n]) ** 2))),
                frames_compared=n)


def booster_config(n_points: int = 1024, seed: int = 0) -> GPLEConfig:
    """The crossing physics (SAC from x0 = -2 at p0 = 20, sigma_p0 = 1, dt 1,
    an output and a reoptimization every 10 ticks) with every default-off
    flag of the coherence booster: ``n_points`` extra points join the
    coherence fit at coherence divisor 6, per-tick tracking of the coherence,
    the coherence-only cutoff, both conservation rescales, the conserving and
    masked relabel, and the coherence cloud frozen while the booster lives."""
    return GPLEConfig(model="SAC", mass=2000.0, x0=-2.0, p0=20.0, sigma_p0=1.0,
                      output_time=10.0, reopt_time=10.0, dt=1.0, num_points=n_points,
                      seed=seed, coh_fit_extra=n_points, coh_len_div=6.0, moment_per_tick="off",
                      evolve_cutoff="coh", coh_boost_rescale=True, pop_rescale=True,
                      relabel_conserve=True, relabel_mask_coh=True, coh_reselect=False)


def _dryrun_rank(mesh, n_points: int) -> dict:
    """One rank of :func:`dryrun_multichip`: one sharded step on its block."""
    from gple_tpu_torch.parallel.sharding import shard_density, sharded_step_fn

    # the same seed on every rank: every rank builds the same whole state
    density, gps = example_state(n_points, mesh.device,
                                 generator=torch.Generator().manual_seed(0))
    step = sharded_step_fn("SAC", 2000.0, 1.0, mesh)
    new_density, new_gps = step(shard_density(density, mesh), gps)
    local = n_points // mesh.size
    for name, t in (("points", new_density.points), ("rho", new_density.rho),
                    ("p_re", new_gps.offdiag.p_re), ("alpha", new_gps.diag.alpha)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"dryrun_multichip: rank {mesh.rank}: non-finite {name}")
    # the points really are split over the ranks ...
    if new_density.points.shape[1] != local:
        raise AssertionError(f"dryrun_multichip: rank {mesh.rank} holds "
                             f"{new_density.points.shape[1]} points, not {local}")
    # ... and so are the rows of the refit's (N, N) inverses
    if tuple(new_gps.offdiag.p_re.shape) != (local, n_points):
        raise AssertionError(f"dryrun_multichip: rank {mesh.rank} holds p_re "
                             f"{tuple(new_gps.offdiag.p_re.shape)}, not {(local, n_points)}")
    return dict(rank=mesh.rank, device=str(mesh.device), points=new_density.points.shape[1],
                p_re_rows=new_gps.offdiag.p_re.shape[0])


def dryrun_multichip(world_size: int, device: str = "cuda") -> None:
    """The counterpart of ``__graft_entry__.dryrun_multichip``: spawn
    ``world_size`` ranks (NCCL on ``cuda``, one card a rank; gloo on ``cpu``),
    split 16 x ``world_size`` points over them, run one full sharded step
    (evolve + refit, ``shard_refit=True``) and check that every output is
    finite and that each rank holds its N/W points and N/W rows of the refit."""
    from gple_tpu_torch.parallel.sharding import BACKENDS, spawn_ranks

    if torch.device(device).type == "cuda" and world_size > torch.cuda.device_count():
        raise RuntimeError(f"need {world_size} CUDA devices, have "
                           f"{torch.cuda.device_count()}")
    n_points = 16 * world_size
    ranks = spawn_ranks(_dryrun_rank, world_size, device, (n_points,))
    print(f"dryrun_multichip OK on {world_size} ranks "
          f"({BACKENDS[torch.device(device).type]}, "
          f"{', '.join(r['device'] for r in ranks)}): points split on dim 1, "
          f"{ranks[0]['points']} of {n_points} a rank; refit p_re rows "
          f"{ranks[0]['p_re_rows']} of {n_points} a rank", flush=True)
