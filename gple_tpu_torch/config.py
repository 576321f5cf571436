"""Declarative runtime configuration (counterpart of :mod:`gple_tpu.config`).

The port keeps its own copy of ``GPLEConfig``: the JAX package's module is
numpy only, but importing it runs ``gple_tpu/__init__.py``, which imports jax.
Every field, default, derived property and the reference ``input`` file
parser are the same, so a config maps field for field between the packages
(:func:`gple_tpu_torch.convert.config_to_torch`).  The field comments say
what each setting does; the measurements behind the defaults are in the JAX
package's docstrings.  Which settings the port's driver runs is stated in
:mod:`gple_tpu_torch.driver`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

from gple_tpu_torch.utils.constants import HBAR

#: The number of grids per dimension for phase-space output
#: (reference ``input.cpp:9`` MaximumGridsForOneDimension).
MAX_GRIDS_PER_DIM = 200


@dataclasses.dataclass(frozen=True)
class GPLEConfig:
    """Full configuration of a GPR-MQCLE run (reference ``input.h:10-168``)."""

    # physics
    model: str = "DAC"          # compile-time TestModel in the reference
    num_pes: int = 2
    dim: int = 1
    mass: float = 2000.0
    x0: float = -10.0
    p0: float = 30.0
    sigma_p0: float = 1.5       # sigma_x0 = hbar / (2 sigma_p0)
    # numerics
    output_time: float = 1.0
    reopt_time: float = 1.0
    dt: float = 0.1
    num_points: int = 128       # training points per density-matrix element
    extra_point_factor: int = 5  # reference main.cpp:35
    dtype: str = "float64"
    # initial electronic state (reference main.cpp:38-39)
    initial_population: Tuple[float, float] = (1.0, 0.0)
    initial_phase_factor: Tuple[float, float] = (0.0, 0.0)
    seed: int = 0
    #: L-BFGS steps of the constrained ladder: the initial fit and the
    #: in-trajectory re-optimizations
    opt_steps_initial: int = 60
    opt_steps_reopt: int = 30
    #: smoothstep cutoff on the GP predictions inside the evolution loop:
    #: False = raw means, True = full cutoff (the reference, main.cpp:75-101),
    #: "coh" = cutoff on the coherence's queries only
    evolve_cutoff: "bool | str" = False
    #: purity target of the reoptimizations: "measured" = the current
    #: Monte-Carlo purity, "initial" = the t = 0 purity (the reference)
    purity_target: str = "measured"
    #: re-run the Metropolis tuning on every cloud re-selection (True), never
    #: (False), or when a 100-step probe leaves the acceptance window ("auto")
    mc_retune: "bool | str" = True
    #: drift-triggered cloud re-selection (driver._track_clouds)
    track_clouds: bool = True
    #: "moment" (moment-based parameters, analytic magnitudes, no search) or
    #: "ladder" (the reference's constrained restart ladder, opt.cpp:1019-1392)
    opt_mode: str = "moment"
    #: recompute the moment parameters inside every tick: False, True (all
    #: elements) or "off" (coherence only); moment mode only
    moment_per_tick: "bool | str" = False
    #: coherence booster: this many off-diagonal extra points join the
    #: coherence fit (0 = off; capped at num_extra_points)
    coh_fit_extra: int = 0
    #: moment-mode coherence lengthscale divisor (lengths = weighted std / div)
    coh_len_div: float = 2.0
    #: scalar purity-conservation rescale of the coherence labels per reopt
    coh_boost_rescale: bool = False
    #: scalar population-conservation rescale of the diagonal labels per reopt
    pop_rescale: bool = False
    #: coherence fit-health backoff: halve coh_len_div (floor 2) while the
    #: fitted purity integral exceeds this multiple of the target; 0 = off
    coh_fit_health_factor: float = 1.5
    #: rescale re-selected labels so the element's point sum is continuous
    relabel_conserve: bool = False
    #: mask the coherence out of the predictor when relabeling a diagonal
    relabel_mask_coh: bool = False
    #: re-select the coherence cloud itself while the booster is alive
    coh_reselect: bool = True
    #: whole-segment fusion: ticks of a fused segment (rounded down to whole
    #: reopt periods), run on the device with the scheduled reopts and one
    #: host pull, rolled back on an event; 0 = the boundary-chunked path
    #: (moment mode, no writers, checkpoints or coh_boost_rescale)
    fused_chunk: int = 100
    #: walk re-selection / seeding chains on a 256^2 grid surrogate of the
    #: backward-branching predictor (labels stay exact); 2D phase space only
    mc_walk_surrogate: bool = True
    #: cache the initialization state on disk, with the event ticks beside it
    #: (fusion hints)
    init_cache: bool = False
    #: run-for-run comparable to the reference: evolve_cutoff=True,
    #: purity_target="initial", corr pinned to 1, the constrained ladder
    reference_parity: bool = False

    def __post_init__(self):
        if self.reference_parity:
            object.__setattr__(self, "evolve_cutoff", True)
            object.__setattr__(self, "purity_target", "initial")
            object.__setattr__(self, "mc_retune", True)
            object.__setattr__(self, "opt_mode", "ladder")

    # -- derived quantities (reference input.cpp:25-77) -----------------------
    @property
    def sigma_x0(self) -> float:
        return HBAR / (2.0 * self.sigma_p0)

    @property
    def r0(self) -> np.ndarray:
        return np.array([self.x0, self.p0])

    @property
    def sigma_r0(self) -> np.ndarray:
        return np.array([self.sigma_x0, self.sigma_p0])

    @property
    def xmin(self) -> float:
        return -2.0 * abs(self.x0)

    @property
    def xmax(self) -> float:
        return 2.0 * abs(self.x0)

    @property
    def num_grids_per_dim(self) -> int:
        # the reference computes max(200, span/dx_deBroglie) (input.cpp:39) but
        # documents the 200 as a cap on the output size (input.cpp:8-9)
        span = self.xmax - self.xmin
        min_dx = math.pi / 2.0 * HBAR / (self.p0 + 3.0 * self.sigma_p0)
        return min(MAX_GRIDS_PER_DIM, int(span / min_dx) + 1)

    @property
    def dx(self) -> float:
        return (self.xmax - self.xmin) / self.num_grids_per_dim

    @property
    def pmin(self) -> float:
        return self.p0 - math.pi / 2.0 * HBAR / self.dx

    @property
    def pmax(self) -> float:
        return self.p0 + math.pi / 2.0 * HBAR / self.dx

    @property
    def dp(self) -> float:
        return (self.pmax - self.pmin) / self.num_grids_per_dim

    @property
    def rmin(self) -> np.ndarray:
        return np.array([self.xmin, self.pmin])

    @property
    def rmax(self) -> np.ndarray:
        return np.array([self.xmax, self.pmax])

    @property
    def output_freq(self) -> int:
        return int(round(max(self.output_time, self.dt) / self.dt))

    @property
    def reopt_freq(self) -> int:
        return int(round(max(self.reopt_time, self.dt) / self.dt))

    @property
    def total_ticks(self) -> int:
        return int(2.0 * abs(2.0 * self.x0 * self.mass / self.p0) / self.dt)

    @property
    def num_extra_points(self) -> int:
        return self.num_points * self.extra_point_factor

    def phase_grids(self) -> np.ndarray:
        """The (n_grid_total, 2) output grid over phase space (input.cpp:49-71)."""
        n = self.num_grids_per_dim
        xs = self.xmin + self.dx * np.arange(n)
        ps = self.pmin + self.dp * np.arange(n)
        gx, gp = np.meshgrid(xs, ps, indexing="ij")
        return np.stack([gx.ravel(), gp.ravel()], axis=-1)

    # -- reference `input` file compatibility ---------------------------------
    @classmethod
    def from_input_file(cls, path: str, **overrides) -> "GPLEConfig":
        """Parse the reference's 8-field ``input`` format (input.cpp:84-148):
        alternating description line / value line with fields mass, x0, p0,
        sigma_p0, output time, re-optimization time, dt, #points."""
        values = []
        with open(path) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        # every second line is a value (description lines come first)
        for i in range(1, len(lines), 2):
            values.append(lines[i].split()[0])
        if len(values) < 8:
            raise ValueError(f"input file {path!r} has {len(values)} fields; need 8")
        kw = dict(
            mass=float(values[0]),
            x0=float(values[1]),
            p0=float(values[2]),
            sigma_p0=float(values[3]),
            output_time=float(values[4]),
            reopt_time=float(values[5]),
            dt=float(values[6]),
            num_points=int(values[7]),
        )
        kw.update(overrides)
        return cls(**kw)
