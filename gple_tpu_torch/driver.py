"""The GPR-MQCLE driver: fit -> sample -> evolve -> refit (counterpart of
:mod:`gple_tpu.driver`).

The reference main loop (``gaussian_process_liouville_equation/main.cpp:19-212``):

1. seed N points per populated element at r0, Metropolis-select them from the
   initial Gaussian distribution (main.cpp:44-57)
2. record the conserved targets: total energy, purity = 1 (main.cpp:59-66)
3. jitter 5N extra points per element for fitting (main.cpp:69)
4. set the hyperparameters (main.cpp:71-73)
5. per tick: evolve density AND extra points with the branching evolver, check
   element appearance, re-optimize on schedule / on element change / on
   conservation drift, otherwise just refit the GP states from the moved
   points (main.cpp:135-202)
6. stop once <x> passes -x0 (main.cpp:195-200)

Ported: the production path -- the moment optimizer, the block-diagonal
(corr = 0) complex fit, the raw-mean evolution distribution
(``evolve_cutoff=False``), cloud tracking, Metropolis re-tuning and the walk
surrogate, element activation, the output files -- run as the JAX package's
boundary-chunked loop: a chunk is a Python loop of :func:`_tick_core` with
one host pull of its boundary scalars.  :class:`GPLEDriver` raises
``NotImplementedError`` at construction for any setting off that path.

Not ported, by design: the fused whole-segment scan with its rollback and
replay, its event hints, the init cache and the persistent XLA cache.  They
existed to hide ~0.2 s of remote-TPU dispatch latency per call; the chunked
path makes the same decisions (``gple_tpu/driver.py:438-442``).
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Callable, List, Optional

import numpy as np
import torch

from gple_tpu_torch import observables as OBS
from gple_tpu_torch.config import GPLEConfig
from gple_tpu_torch.dynamics import evolve as EV
from gple_tpu_torch.gp.opt import (
    AVERAGE_TOLERANCE,
    COMPLEX_MAG_LB,
    COMPLEX_MAG_UB,
    CORR_BOUND,
    INITIAL_NOISE,
    Optimizer,
)
from gple_tpu_torch.io.writers import OutputWriters
from gple_tpu_torch.ops import complex_kernels as CK
from gple_tpu_torch.ops import kernels as RK
from gple_tpu_torch.sampler import mc
from gple_tpu_torch.sampler.keys import RandomKeys
from gple_tpu_torch.storage import (
    DIAG_INDICES,
    ELEMENTS,
    NUM_ELEMENTS,
    OFFDIAG_INDEX,
    Density,
    GPStates,
    fit_gp_states,
    predict_all,
    predict_element,
)
from gple_tpu_torch.utils import ri
from gple_tpu_torch.utils.constants import purity_factor

_DIAG = list(DIAG_INDICES)


# -- distribution functions ---------------------------------------------------------

def gp_dist_all(gps: GPStates, pts3):
    """(3, M, PhaseDim) -> (3, M, 2) cutoff GP predictions (with variance)."""
    return predict_all(gps, pts3, with_variance=True)


def gp_dist_all_nocut(gps: GPStates, pts3):
    """Raw-mean GP predictions, no cutoff: the default evolution distribution
    (the fused mean kernels, no variance)."""
    return predict_all(gps, pts3, with_variance=False)


def _gp_dist_elem(gps: GPStates, pts, *, elem: int, cutoff: bool = True):
    return predict_element(gps, elem, pts, with_variance=cutoff)


GP_DIST_ELEMS = tuple(partial(_gp_dist_elem, elem=k) for k in range(NUM_ELEMENTS))
GP_DIST_ELEMS_NOCUT = tuple(
    partial(_gp_dist_elem, elem=k, cutoff=False) for k in range(NUM_ELEMENTS))


def _init_dist_elem(params, pts, *, elem: int):
    r0, sigma, pops, phases = params
    row, col = ELEMENTS[elem]
    return mc.initial_distribution(r0, sigma, pts, row, col, pops, phases)


INIT_DIST_ELEMS = tuple(partial(_init_dist_elem, elem=k) for k in range(NUM_ELEMENTS))


def init_dist_all(params, pts3):
    return torch.stack([INIT_DIST_ELEMS[k](params, pts3[k]) for k in range(NUM_ELEMENTS)])


# -- the tick and the reoptimization's device work -------------------------------------

@torch.inference_mode()
def _tick_core(model: str, mass: float, dt: float, density: Density,
               extra: Density, gps: GPStates, diag_params, off_params,
               evolve_dist, track_moments: str, coh_fit_extra: int,
               coh_len_div: float, block_diag: bool):
    """THE tick body: evolve density + extra points with ``evolve_dist``, run
    the is-very-small activation test with the cutoff distribution, and refit
    the GP states from the moved points.  Returns
    ``(density, extra, small (3,) bool, gps)``.

    Only ``track_moments="none"`` and ``coh_fit_extra=0`` are ported: with
    them the kernel parameters are held and the extra cloud does not join the
    fit (``coh_len_div`` is then unused)."""
    if track_moments != "none":
        raise NotImplementedError("_tick_core: per-tick moment tracking is not ported")
    if coh_fit_extra != 0:
        raise NotImplementedError("_tick_core: the coherence booster is not ported")
    del coh_len_div
    new_density = EV.evolve_step(model, mass, dt, density, evolve_dist, gps)
    new_extra = EV.evolve_step(model, mass, dt, extra, evolve_dist, gps)
    small = EV.is_very_small(model, mass, dt, new_density, gp_dist_all, gps)
    new_gps = fit_gp_states(diag_params, off_params, new_density, prev=gps,
                            block_diag=block_diag)
    return new_density, new_extra, small, new_gps


def _fit_states_obs(diag_params, off_params, density: Density):
    """``fit_gp_states`` (block-diagonal) plus its integral observables."""
    gps = fit_gp_states(diag_params, off_params, density, block_diag=True)
    return gps, gps.population(), gps.purity()


def _regen_extra_core(n_extra: int, density: Density, gps: GPStates, keys) -> Density:
    """Regenerate the extra clouds from a fresh fit (reference mc.cpp:59-120
    via main.cpp:165-172): one key per active element (None for an inactive
    one, whose cloud is its first point repeated with zero labels), and all
    three clouds labeled by one raw-mean :func:`predict_all` -- one kernel
    launch for both diagonal elements and one for the coherence."""
    pts = torch.stack([
        mc.jitter_points(keys[k], density.points[k], n_extra) if keys[k] is not None
        else density.points[k][:1].expand(n_extra, density.points.shape[-1])
        for k in range(NUM_ELEMENTS)])
    rho = predict_all(gps, pts, with_variance=False)
    return Density(points=pts, rho=rho, active=density.active)


@torch.inference_mode()
def _reopt_epilogue(n_extra: int, density: Density, diag_params, off_params, keys):
    """Everything after a reoptimization's parameter choice: refit the GP
    states from the (possibly re-selected) cloud, regenerate the extra clouds
    labeled by the fresh fit, and the fit-reference integrals for the drift
    check.  Returns ``(gps, extra, population, purity)``."""
    gps, pop, pur = _fit_states_obs(diag_params, off_params, density)
    return gps, _regen_extra_core(n_extra, density, gps, keys), pop, pur


#: walk-surrogate grid resolution per phase-space axis; 256 resolves the
#: coherence fringes (grid spacing ~0.05-0.1 in p over a doubled cloud box, an
#: order below the SAC fringe wavelength at p0 = 20)
_SURR_RES = 256


def _linspace(lo, hi, num: int):
    """``jnp.linspace`` of two 0-d tensors, formula for formula (the grid the
    JAX package walks on), without a host pull of the endpoints."""
    step = torch.arange(num - 1, dtype=lo.dtype, device=lo.device) / (num - 1)
    return torch.cat([lo * (1 - step) + hi * step, hi[None]])


@torch.inference_mode()
def _surrogate_grid(model: str, mass: float, dt: float, elem: int, gps, lo, hi):
    """|backward-branching prediction| of one element on a regular grid, in
    ONE batched predictor call (the Metropolis chains then interpolate it,
    see mc.element_monte_carlo ``walk``)."""
    xs = _linspace(lo[0], hi[0], _SURR_RES)
    ps = _linspace(lo[1], hi[1], _SURR_RES)
    gx, gp = torch.meshgrid(xs, ps, indexing="ij")
    pts = torch.stack([gx.reshape(-1), gp.reshape(-1)], dim=-1)
    vals = EV.predict_new_points(model, mass, dt, pts, elem, gp_dist_all_nocut, gps)
    return ri.absval(vals).reshape(_SURR_RES, _SURR_RES)


def _surrogate_dist(params, pts):
    """Bilinear interpolation of a `_surrogate_grid`, zero outside the box.
    RI-shaped (imaginary part 0) so the Metropolis kernel's |.| contract
    holds; labels are NEVER taken from this (mc.element_monte_carlo)."""
    grid, lo, hi = params
    res = grid.shape[0]
    u = (pts - lo) / (hi - lo) * (res - 1)
    i = torch.clamp(torch.floor(u), 0, res - 2).long()
    f = u - i
    i0, i1 = i[:, 0], i[:, 1]
    f0, f1 = f[:, 0], f[:, 1]
    w = (grid[i0, i1] * (1 - f0) * (1 - f1)
         + grid[i0 + 1, i1] * f0 * (1 - f1)
         + grid[i0, i1 + 1] * (1 - f0) * f1
         + grid[i0 + 1, i1 + 1] * f0 * f1)
    inside = torch.all((pts >= lo) & (pts <= hi), dim=-1)
    w = torch.where(inside, w, 0.0)
    return torch.stack([w, torch.zeros_like(w)], dim=-1)


def _cloud_drift_flags(density: Density):
    """Per-element drift criterion of :meth:`GPLEDriver._track_clouds`: the
    |rho|-weighted label mean off the cloud mean by > half a cloud sigma in
    any phase-space dim.  (3,) bool on the device."""
    w = torch.sqrt(ri.abs2(density.rho))                         # (3, N)
    wsum = torch.sum(w, dim=1)                                   # (3,)
    com = torch.einsum("knd,kn->kd", density.points, w) / torch.clamp(
        wsum[:, None], min=1e-300)
    mean = torch.mean(density.points, dim=1)
    std = torch.clamp(torch.std(density.points, dim=1, correction=0), min=1e-10)
    drift = torch.amax(torch.abs(com - mean) / std, dim=1)
    return density.active & (wsum > 0.0) & (drift > 0.5)


@torch.inference_mode()
def _grid_predictions(gps: GPStates, grid_pts):
    """Cutoff prediction (3, G, 2) + variance (3, G) of every element on the
    output grid: one batched variance predict for both diagonal elements, one
    for the coherence."""
    _, var_d, cut_d = RK.predict_real(gps.diag, grid_pts.expand((2,) + grid_pts.shape))
    _, var_o, cut_o = CK.predict_complex(gps.offdiag, grid_pts)
    preds = torch.stack([ri.ri(cut_d[0]), cut_o, ri.ri(cut_d[1])])
    variances = torch.stack([var_d[0], var_o, var_d[1]])
    return (torch.where(gps.active[:, None, None], preds, 0.0),
            torch.where(gps.active[:, None], variances, 0.0))


def _pull(*tensors):
    """Host numpy copies of float tensors, through one device-to-host copy."""
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        out.append(flat[at: at + t.numel()].reshape(tuple(t.shape)))
        at += t.numel()
    return out


@dataclasses.dataclass
class TickRecord:
    time: float
    population_prm: float
    #: per-surface populations by the analytic parameter integral, normalized
    population_prm_each: np.ndarray
    population_mci: np.ndarray
    energy_prm: float
    energy_mci: float
    purity_prm: float
    purity_mci: float
    x_average: float
    opt_type: str


def _unported(cfg: GPLEConfig) -> List[str]:
    """The settings of ``cfg`` that the port's driver does not implement."""
    checks = (
        (cfg.opt_mode != "moment" or cfg.reference_parity,
         "opt_mode='ladder' / reference_parity (the constrained ladder, ROADMAP Queue A "
         "item 11)"),
        (cfg.coh_fit_extra > 0, "coh_fit_extra > 0 (the coherence booster, item 13)"),
        (bool(cfg.moment_per_tick), "moment_per_tick (item 13)"),
        (cfg.pop_rescale, "pop_rescale (item 13)"),
        (cfg.coh_boost_rescale, "coh_boost_rescale (item 13)"),
        (cfg.relabel_conserve, "relabel_conserve (item 13)"),
        (cfg.relabel_mask_coh, "relabel_mask_coh (item 13)"),
        (cfg.evolve_cutoff is not False, "evolve_cutoff other than False (item 13)"),
        (cfg.init_cache, "init_cache (TPU machinery, not to port)"),
    )
    return [what for bad, what in checks if bad]


class GPLEDriver:
    """The trajectory driver.  ``device`` defaults to the CUDA card and raises
    where there is none; pass ``device="cpu"`` for the plain-PyTorch path.
    ``rng`` is the root random key (default: ``RandomKeys(cfg.seed, device)``)."""

    def __init__(self, cfg: GPLEConfig, outdir: Optional[str] = None, verbose: bool = False,
                 device="cuda", rng=None):
        missing = _unported(cfg)
        if missing:
            raise NotImplementedError("GPLEDriver: not ported yet: " + "; ".join(missing))
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("GPLEDriver: device 'cuda' requested but CUDA is not "
                               "available; pass device='cpu' for the CPU path")
        self.cfg = cfg
        self.verbose = verbose
        self.writers = OutputWriters(outdir) if outdir else None
        self.rng = rng if rng is not None else RandomKeys(cfg.seed, self.device)
        self.mc_params = [mc.MCParameters() for _ in range(NUM_ELEMENTS)]
        self.history: List[TickRecord] = []
        self._grid = (torch.tensor(cfg.phase_grids(), dtype=torch.float64, device=self.device)
                      if outdir else None)
        #: cumulative per-phase wall times; "optimize" is split into
        #: opt_reselect (cloud re-selection + MC re-tuning), opt_tune (moment
        #: parameters) and opt_fit (refit + extra-point regeneration)
        self.phase_times = {
            "init": 0.0, "seed": 0.0, "evolve": 0.0, "optimize": 0.0, "output": 0.0,
            "opt_reselect": 0.0, "opt_tune": 0.0, "opt_fit": 0.0,
        }
        #: wall seconds of each initialization phase, in order
        self.init_marks: List[tuple] = []
        self.stats = {"element_activations": 0, "cloud_reselections": 0}
        self._new_pt_dists = tuple(
            partial(self._new_point_dist, elem=k) for k in range(NUM_ELEMENTS))
        #: effective coherence lengthscale divisor, stickily halved by the
        #: fit-health backoff (GPLEConfig.coh_fit_health_factor)
        self._coh_div_eff = float(cfg.coh_len_div)

    def _log(self, msg):
        if self.verbose:
            print(msg, flush=True)

    def _split(self):
        self.rng, sub = self.rng.split(2)
        return sub

    def _new_point_dist(self, params, pts, *, elem: int):
        cfg = self.cfg
        return EV.predict_new_points(cfg.model, cfg.mass, cfg.dt, pts, elem,
                                     gp_dist_all_nocut, params)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- initialization (main.cpp:25-73) ------------------------------------------
    @torch.inference_mode()
    def initialize(self):
        marks = [("start", time.perf_counter())]
        cfg = self.cfg
        pops = cfg.initial_population
        active = np.array([pops[i] > 0 and pops[j] > 0 for (i, j) in ELEMENTS], dtype=bool)

        def f64(v):
            return torch.tensor(np.asarray(v, dtype=np.float64), device=self.device)

        init_params = (f64(cfg.r0), f64(cfg.sigma_r0), f64(pops),
                       f64(cfg.initial_phase_factor))
        n = cfg.num_points
        pts = f64(cfg.r0)[None, None, :].expand(NUM_ELEMENTS, n, 2)
        rho = init_dist_all(init_params, pts)
        # Metropolis selection of each active element (main.cpp:57)
        new_pts, new_rho = [], []
        for k in range(NUM_ELEMENTS):
            if active[k]:
                p, r, self.mc_params[k] = mc.element_monte_carlo(
                    self._split(), INIT_DIST_ELEMS[k], init_params, pts[k],
                    self.mc_params[k], tune=True)
            else:
                p, r = pts[k], rho[k]
            new_pts.append(p)
            new_rho.append(r)
        active_t = torch.tensor(active, device=self.device)
        density = Density(points=torch.stack(new_pts), rho=torch.stack(new_rho),
                          active=active_t)
        self._sync()
        marks.append(("mc_select", time.perf_counter()))
        # conserved targets (main.cpp:59-66)
        energies = OBS.total_energy_each_surface(cfg.model, density, cfg.mass)
        e_host, mc_pur, pop_sum = _pull(
            energies, torch.sum(OBS.purity_each_element(density)),
            torch.sum(density.rho[_DIAG][..., 0]))
        weights = np.asarray(pops) ** 2
        self.total_energy = float(np.sum(weights * e_host) / weights.sum())
        self.purity = 1.0
        self.purity_ratio = self.purity / (float(mc_pur) * purity_factor(cfg.dim))
        #: conserved total-population numerator (carried like the JAX
        #: package's; read only by its pop_rescale, which is not ported)
        self._pop_sum0 = float(pop_sum)
        extra = self._make_extra(density, active, INIT_DIST_ELEMS, init_params)
        self.extra = extra
        self._sync()
        marks.append(("extra", time.perf_counter()))
        self.optimizer = Optimizer(
            model=cfg.model, mass=cfg.mass, total_energy=self.total_energy,
            purity=self.purity, sigma_r0=np.asarray(cfg.sigma_r0),
            lbfgs_steps=cfg.opt_steps_initial, opt_mode=cfg.opt_mode,
            off_len_div=cfg.coh_len_div, device=self.device)
        self.opt_result = self.optimizer.optimize(density, extra, energies)
        marks.append(("optimize", time.perf_counter()))
        self.optimizer.lbfgs_steps = cfg.opt_steps_reopt
        self.gps = self._refit(density)
        self._record_fit_ref(self.purity)
        self.density = density
        marks.append(("refit", time.perf_counter()))
        self.init_marks = [(name, t1 - t0)
                           for (name, t1), (_, t0) in zip(marks[1:], marks[:-1])]
        self._log("init phases: " + ", ".join(f"{n}={s:.1f}s" for n, s in self.init_marks))
        return density

    def _make_extra(self, density: Density, active, dist_elems, dist_params) -> Density:
        """Generate the extra clouds (reference mc.cpp:59-120), one key per
        active element."""
        n_extra = self.cfg.num_extra_points
        pts, rho = [], []
        for k in range(NUM_ELEMENTS):
            if active[k]:
                p, r = mc.generate_extra_points_element(
                    self._split(), density.points[k], n_extra, dist_elems[k], dist_params)
            else:
                p = density.points[k][:1].expand(n_extra, density.points.shape[-1])
                r = torch.zeros((n_extra, 2), dtype=p.dtype, device=p.device)
            pts.append(p)
            rho.append(r)
        return Density(points=torch.stack(pts), rho=torch.stack(rho), active=density.active)

    def _refit(self, density: Density) -> GPStates:
        diag_params, off_params = self.optimizer.fitted_params()
        gps, pop, pur = _fit_states_obs(diag_params, off_params, density)
        # kept for the following _record_fit_ref
        self._fit_obs = (pop, pur)
        return gps

    def _record_fit_ref(self, target_purity: float) -> None:
        """Snapshot the freshly fitted GP's integral observables: the drift
        checks compare against these reference values, not the ideal targets
        (the moment-mode fit carries a small-N integral bias)."""
        pop, pur = self.__dict__.pop("_fit_obs", (None, None))
        if pop is None:
            pop, pur = self.gps.population(), self.gps.purity()
        pop, pur = _pull(pop, pur)
        self._fit_ref = {"pop": float(pop), "pur": float(pur),
                         "target": max(float(target_purity), 1e-30)}

    def _drift_detected(self, pop: float, pur: float, target_purity: float) -> bool:
        """Conservation-drift trigger (main.cpp:174-189), relative form."""
        ref = self._fit_ref
        tol = 2.0 * AVERAGE_TOLERANCE
        pop_ok = (1.0 - tol) < pop / ref["pop"] < (1.0 + tol)
        pur_cap = (1.0 + tol) * target_purity * (ref["pur"] / ref["target"])
        return pur > pur_cap or not pop_ok

    def _target_purity(self, mc_pur: float) -> float:
        measured = mc_pur * purity_factor(self.cfg.dim) * self.purity_ratio
        return measured if self.cfg.purity_target == "measured" else self.purity

    # -- a chunk of pure evolve ticks -----------------------------------------------
    @torch.inference_mode()
    def _advance_chunk(self, n_ticks: int) -> bool:
        """Advance ``n_ticks`` ticks of :func:`_tick_core` and pull the chunk's
        boundary scalars to the host once.

        Returns False (state untouched) if an element activated mid-chunk --
        the caller then replays the chunk tick-by-tick through :meth:`step`.
        A conservation-drift check runs at the chunk end."""
        cfg = self.cfg
        t0 = time.perf_counter()
        diag_params, off_params = self.optimizer.fitted_params()
        density, extra, gps = self.density, self.extra, self.gps
        smalls = []
        for _ in range(n_ticks):
            density, extra, small, gps = _tick_core(
                cfg.model, cfg.mass, cfg.dt, density, extra, gps, diag_params, off_params,
                gp_dist_all_nocut, "none", 0, self._coh_div_eff, True)
            smalls.append(small)
        smalls, active, pop, pur, mc_pur = _pull(
            torch.stack(smalls), self.density.active, gps.population(), gps.purity(),
            torch.sum(OBS.purity_each_element(density)))
        if np.any((smalls == 0) != (active[None, :] > 0)):
            return False
        self.phase_times["evolve"] += time.perf_counter() - t0
        self.density, self.extra, self.gps = density, extra, gps
        target_purity = self._target_purity(float(mc_pur))
        if self._drift_detected(float(pop), float(pur), target_purity):
            self._reoptimize(target_purity)
        return True

    @torch.inference_mode()
    def _reoptimize(self, target_purity: float) -> str:
        cfg = self.cfg
        t0 = time.perf_counter()
        density = self._track_clouds(self.density)
        self.density = density
        t1 = time.perf_counter()
        energies = OBS.total_energy_each_surface(cfg.model, density, cfg.mass)
        self.optimizer.purity = target_purity
        self.optimizer.off_len_div = self._coh_div_eff
        self.opt_result = self.optimizer.optimize(density, self.extra, energies)
        t2 = time.perf_counter()
        diag_params, off_params = self.optimizer.fitted_params()
        # one RNG split per ACTIVE element, in element order
        active = density.active.cpu().numpy()
        keys = [self._split() if active[k] else None for k in range(NUM_ELEMENTS)]
        self.gps, self.extra, pop, pur = _reopt_epilogue(
            cfg.num_extra_points, density, diag_params, off_params, keys)
        pop, pur = _pull(pop, pur)
        # coherence fit-health backoff (GPLEConfig.coh_fit_health_factor):
        # stickily lengthen the coherence lengths while the purity integral
        # is detached from its target; inert at the default divisor 2
        hf = float(cfg.coh_fit_health_factor)
        while (hf > 0.0 and active[OFFDIAG_INDEX] and self._coh_div_eff > 2.0
               and float(pur) > hf * max(float(target_purity), 1e-30)):
            self._coh_div_eff = max(2.0, self._coh_div_eff / 2.0)
            self.optimizer.off_len_div = self._coh_div_eff
            self.stats["coh_len_backoffs"] = self.stats.get("coh_len_backoffs", 0) + 1
            self._log(f"coherence fit unhealthy (purity {float(pur):.3f} vs target "
                      f"{target_purity:.3f}): len_div -> {self._coh_div_eff}")
            self.opt_result = self.optimizer.optimize(density, self.extra, energies)
            diag_params, off_params = self.optimizer.fitted_params()
            self.gps, self.extra, pop, pur = _reopt_epilogue(
                cfg.num_extra_points, density, diag_params, off_params, keys)
            pop, pur = _pull(pop, pur)
        self._fit_ref = {"pop": float(pop), "pur": float(pur),
                         "target": max(float(target_purity), 1e-30)}
        self._sync()
        t3 = time.perf_counter()
        self.phase_times["opt_reselect"] += t1 - t0
        self.phase_times["opt_tune"] += t2 - t1
        self.phase_times["opt_fit"] += t3 - t2
        self.phase_times["optimize"] += t3 - t0
        return self.opt_result.opt_type

    # -- one tick (main.cpp:135-202) ------------------------------------------------
    @torch.inference_mode()
    def step(self, tick: int) -> str:
        cfg = self.cfg
        t0 = time.perf_counter()
        diag_params, off_params = self.optimizer.fitted_params()
        density, extra, small, new_gps = _tick_core(
            cfg.model, cfg.mass, cfg.dt, self.density, self.extra, self.gps,
            diag_params, off_params, gp_dist_all_nocut, "none", 0, self._coh_div_eff, True)
        small, old_active, pop, pur, mc_pur = _pull(
            small, density.active, new_gps.population(), new_gps.purity(),
            torch.sum(OBS.purity_each_element(density)))
        self.phase_times["evolve"] += time.perf_counter() - t0
        old_active = old_active > 0
        new_active = small == 0
        opt_type = "none"
        changed = bool(np.any(new_active != old_active))
        if changed:
            self.stats["element_activations"] += int(np.sum(new_active & ~old_active))
            t_seed = time.perf_counter()
            density, extra = self._element_change(density, extra, old_active, new_active)
            self.phase_times["seed"] += time.perf_counter() - t_seed
            # the tick's MC purity predates the reseeding
            mc_pur = float(torch.sum(OBS.purity_each_element(density)))
        target_purity = self._target_purity(float(mc_pur))
        needs_opt = changed or (tick % cfg.reopt_freq == 0)
        if not needs_opt:
            # drift check with the refitted states (main.cpp:174-189)
            self.density, self.extra, self.gps = density, extra, new_gps
            if self._drift_detected(float(pop), float(pur), target_purity):
                needs_opt = True
                opt_type = "drift"
        if needs_opt:
            self.density, self.extra = density, extra
            reopt_type = self._reoptimize(target_purity)
            opt_type = reopt_type if opt_type == "none" else opt_type
        return opt_type

    def _relabel_gps(self, density: Density, extra: Density) -> GPStates:
        """GP states for RELABELING walks only (re-selection / new-element
        seeding): at a coherence divisor above 2 the live fit is near-
        interpolating, so the same coherence data is refit at the smooth
        div-2 lengthscale for the relabel queries.  At the default divisor 2
        these are the live states."""
        if self._coh_div_eff <= 2.0:
            return self.gps
        live = self.gps.offdiag.params
        scale = self._coh_div_eff / 2.0
        safe = live._replace(real_lengths=live.real_lengths * scale,
                             imag_lengths=live.imag_lengths * scale)
        off = CK.fit_complex(safe, density.points[OFFDIAG_INDEX],
                             density.rho[OFFDIAG_INDEX], block_diag=True)
        return GPStates(diag=self.gps.diag, offdiag=off, active=self.gps.active)

    def _walk_surrogate(self, gps, elem: int, density: Density, extra: Density):
        """(walk_fn, walk_params) Metropolis target for ``elem``'s chains (see
        GPLEConfig.mc_walk_surrogate), or None for exact walks.  The grid box
        doubles the union cloud's bounding box; the surrogate is zero outside,
        which simply rejects proposals there."""
        cfg = self.cfg
        if not cfg.mc_walk_surrogate or density.points.shape[-1] != 2:
            return None
        pts = torch.cat([density.points.reshape(-1, 2), extra.points.reshape(-1, 2)])
        lo = torch.amin(pts, dim=0)
        hi = torch.amax(pts, dim=0)
        span = hi - lo
        lo = lo - 0.5 * span
        hi = hi + 0.5 * span
        grid = _surrogate_grid(cfg.model, cfg.mass, cfg.dt, elem, gps, lo, hi)
        return (_surrogate_dist, (grid, lo, hi))

    def _track_clouds(self, density: Density) -> Density:
        """Re-select an element's points from its CURRENT predicted density
        when the cloud has drifted off its own mass: walk them with the tuned
        Metropolis kernel to the backward-branching predictor's density, which
        has support where transferred mass lands (the reference's mid-run
        seeding machinery, mc.cpp:407-537, applied on drift)."""
        if not self.cfg.track_clouds:
            return density
        flags = _cloud_drift_flags(density).cpu().numpy()
        if not flags.any():
            return density
        pts = density.points.clone()
        rho = density.rho.clone()
        relabel_gps = self._relabel_gps(density, self.extra)
        for k in np.nonzero(flags)[0]:
            self._log(f"element {ELEMENTS[k]} cloud re-selected")
            self.stats["cloud_reselections"] += 1
            walk = self._walk_surrogate(relabel_gps, k, density, self.extra)
            pts[k], rho[k], self.mc_params[k] = mc.element_monte_carlo(
                self._split(), self._new_pt_dists[k], relabel_gps, density.points[k],
                self.mc_params[k], tune=self.cfg.mc_retune, walk=walk)
        return Density(points=pts, rho=rho, active=density.active)

    def _element_change(self, density, extra, old_active, new_active):
        """new_element_point_selection (mc.cpp:407-537): seed each new element
        from the best-scoring existing coordinates; zero a vanished one."""
        candidates = torch.cat([density.points.reshape(-1, density.points.shape[-1]),
                                extra.points.reshape(-1, 2)])
        gps = self._relabel_gps(density, extra)
        pts = density.points.clone()
        rho = density.rho.clone()
        for k in range(NUM_ELEMENTS):
            if new_active[k] and not old_active[k]:
                self._log(f"element {ELEMENTS[k]} appears")
                walk = self._walk_surrogate(gps, k, density, extra)
                pts[k], rho[k], self.mc_params[k] = mc.seed_new_element(
                    self._split(), candidates, self.cfg.num_points,
                    self._new_pt_dists[k], gps, self.mc_params[k], walk=walk)
            elif old_active[k] and not new_active[k]:
                self._log(f"element {ELEMENTS[k]} vanishes")
                rho[k] = 0.0
        active = torch.tensor(new_active, device=self.device)
        return (Density(points=pts, rho=rho, active=active),
                Density(points=extra.points, rho=extra.rho, active=active))

    # -- observation / output ---------------------------------------------------------
    @torch.inference_mode()
    def observe(self, tick: int, opt_type: str) -> TickRecord:
        cfg = self.cfg
        obs = OBS.observe_all(cfg.model, self.density, self.gps, cfg.mass)
        names = list(obs)
        return self._record_from_obs(tick, dict(zip(names, _pull(*obs.values()))), opt_type)

    def _record_from_obs(self, tick: int, obs, opt_type: str) -> TickRecord:
        cfg = self.cfg
        ppl_prm = obs["ppl_prm_each"]
        ppl_prm = ppl_prm / max(ppl_prm.sum(), 1e-30)
        rec = TickRecord(
            time=tick * cfg.dt,
            population_prm=float(obs["pop_prm"]),
            population_prm_each=ppl_prm,
            population_mci=obs["ppl_mci"],
            energy_prm=float(obs["energy_prm"]),
            energy_mci=float(obs["energy_mci"]),
            purity_prm=float(obs["purity_prm"]),
            purity_mci=float(obs["purity_mci_raw"]) * purity_factor(cfg.dim)
            * self.purity_ratio,
            x_average=float(obs["x_average"]),
            opt_type=opt_type,
        )
        self.history.append(rec)
        if self.writers:
            self._write_outputs(rec, obs["energies"])
        self._log(
            f"t={rec.time:8.2f} pop={rec.population_prm:.4f} "
            f"E={rec.energy_prm:.6f} purity={rec.purity_prm:.4f} "
            f"<x>={rec.x_average:8.3f} ppl={np.asarray(obs['ppl_mci']).round(4)} "
            f"opt={opt_type}")
        return rec

    def _write_outputs(self, rec: TickRecord, energies):
        cfg = self.cfg
        density, extra, gps = self.density, self.extra, self.gps
        preds, variances = _grid_predictions(gps, self._grid)
        (pops_prm, r_prm, r_mci0, r_mci1, r_all_prm, r_all_mci, pur_diag, pur_off,
         purity_mci, points, rho, e_points, e_rho, preds, variances, diag_rescale,
         off_rescale, active) = _pull(
            gps.population_each(), RK.r_average(gps.diag),
            OBS.r_average_one_element(density.points[0], density.rho[0]),
            OBS.r_average_one_element(density.points[2], density.rho[2]),
            gps.r_average(), OBS.r_average_all_surfaces(density), RK.purity(gps.diag),
            CK.purity_complex(gps.offdiag), OBS.purity_each_element(density),
            density.points, density.rho, extra.points, extra.rho, preds, variances,
            gps.diag.rescale, gps.offdiag.rescale, gps.active)
        active = active > 0
        r_mci = (r_mci0, r_mci1)
        surface_rows = [(pops_prm[s], r_prm[s], rec.population_mci[s], r_mci[s],
                         float(energies[s])) for s in range(2)]
        pop = max(rec.population_prm, 1e-300)
        totals = [rec.population_prm, *(r_all_prm / pop), rec.energy_prm / pop,
                  rec.population_mci.sum(), *r_all_mci, rec.energy_mci]
        pur_off = float(pur_off) if active[OFFDIAG_INDEX] else 0.0
        purity_prm = np.array([[pur_diag[0], pur_off], [pur_off, pur_diag[1]]])
        self.writers.write_average(surface_rows, totals, purity_prm,
                                   purity_mci * purity_factor(cfg.dim))
        # param.txt: (lower bound, parameters, upper bound) per element (00), (10), (11)
        opt = self.optimizer
        triples = []
        for s, k in enumerate(DIAG_INDICES):
            lb, ub = Optimizer.length_bounds(points[k])
            params = np.concatenate([[opt.diag_magnitudes[s]], opt.diag_lengths[s],
                                     [INITIAL_NOISE]])
            triples.append(([1.0, *lb, INITIAL_NOISE], params, [1.0, *ub, INITIAL_NOISE]))
        olb, oub = Optimizer.length_bounds(points[OFFDIAG_INDEX])
        off_flat = np.asarray(opt.off_params)
        triples.insert(1, (
            [1.0, COMPLEX_MAG_LB, *olb, COMPLEX_MAG_LB, *olb, -CORR_BOUND, INITIAL_NOISE],
            np.concatenate([[opt.off_magnitude], off_flat, [INITIAL_NOISE]]),
            [1.0, COMPLEX_MAG_UB, *oub, COMPLEX_MAG_UB, *oub, CORR_BOUND, INITIAL_NOISE],
        ))
        self.writers.write_param(triples)
        self.writers.write_points(points, rho[..., 0] + 1.0j * rho[..., 1],
                                  e_points, e_rho[..., 0] + 1.0j * e_rho[..., 1])
        self.writers.write_phase(preds[..., 0] + 1.0j * preds[..., 1], variances)
        # label rescale factors in triangular order (00), (10), (11); NaN for
        # absent elements like the reference (output.cpp:264-292)
        rescales = np.where(active, [diag_rescale[0], float(off_rescale), diag_rescale[1]],
                            np.nan)
        steps = self.opt_result.steps
        self.writers.write_log(
            rec.time, self.opt_result.error, [p.num_steps for p in self.mc_params],
            [p.displacement for p in self.mc_params], rec.opt_type, rescales=rescales,
            opt_steps=sum(steps) if isinstance(steps, (list, tuple)) else steps)

    # -- full run (main.cpp:132-202) ----------------------------------------------------
    def run(self, max_ticks: Optional[int] = None,
            callback: Optional[Callable] = None) -> List[TickRecord]:
        """Initialize, then advance in boundary-aligned chunks: every tick
        up to the next scheduled reopt or output is one :meth:`_advance_chunk`
        (replayed through :meth:`step` when an element activates inside it),
        and the boundary tick itself goes through :meth:`step`."""
        cfg = self.cfg
        t0 = time.perf_counter()
        self.initialize()
        self.phase_times["init"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        self.observe(0, self.opt_result.opt_type)
        self.phase_times["output"] += time.perf_counter() - t0
        total = cfg.total_ticks if max_ticks is None else min(cfg.total_ticks, max_ticks)
        self._advance(1, total, callback)
        self._log(f"phase wall times: {self.phase_times}")
        if self.writers:
            self.writers.close()
        return self.history

    def _advance(self, tick: int, total: int, callback=None):
        """The loop of :meth:`run` from ``tick`` to ``total`` (inclusive)."""
        cfg = self.cfg

        def next_multiple(t: int, k: int) -> int:
            return ((t + k - 1) // k) * k

        while tick <= total:
            # the next tick where the host must intervene: scheduled reopt or
            # output; everything before it is one chunk
            boundary = min(next_multiple(tick, cfg.reopt_freq),
                           next_multiple(tick, cfg.output_freq), total)
            n_pre = boundary - tick
            # only the steady-state chunk length is chunked, as in the JAX
            # package; odd remainders go tick by tick
            canonical = n_pre == min(cfg.output_freq, cfg.reopt_freq) - 1
            if not (n_pre > 0 and canonical and self._advance_chunk(n_pre)):
                for t in range(tick, boundary):
                    self.step(t)
            tick = boundary
            opt_type = self.step(tick)
            if tick % cfg.output_freq == 0:
                t0 = time.perf_counter()
                rec = self.observe(tick, opt_type)
                self.phase_times["output"] += time.perf_counter() - t0
                if callback is not None:
                    callback(rec)
                if rec.x_average > -cfg.x0:
                    self._log("wavepacket has left the interaction region")
                    break
            tick += 1
