"""Density-matrix point storage and GP-state containers.

Counterpart of :mod:`gple_tpu.storage`: every lower-triangular element holds
a fixed number of points in one stacked tensor and an ``active`` mask marks
which elements carry density.  Complex density values are trailing-axis-2 RI
tensors.  Element order is row-major lower-triangular: index 0 = (0,0),
1 = (1,0), 2 = (1,1).

The refit :func:`fit_gp_states` builds all five (N, N) grams of a step --
the two diagonal kernels and the coherence's real, imaginary and correlation
sub-grams -- in ONE ``gram_rbf`` launch.  The block-diagonal production path
(corr = 0) solves its four (N, N) SPD systems as one batched Cholesky; the
full path (any corr: the constrained ladder, ``reference_parity``) solves the
two diagonal systems as one batched Cholesky and the coherence's (2N, 2N)
embedding as another.  With the coherence booster (``off_extra``, k points)
the coherence is fitted on N + k points: its three sub-grams are a second
launch and its systems a second batched Cholesky.  The JAX package's
``GPLE_BATCHED_NS`` environment switch selected between TPU inverse chains
and is not carried over.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from gple_tpu_torch.ops import complex_kernels as CK
from gple_tpu_torch.ops import kernels as RK
from gple_tpu_torch.ops.gram_kernels import gram_rbf
from gple_tpu_torch.ops.linalg import (
    psd_inverse,
    psd_inverse_batched,
    psd_inverse_warm,
    psd_inverse_warm_batched,
)
from gple_tpu_torch.utils import ri

#: lower-triangular element order (row, col) for NumPES = 2
ELEMENTS = ((0, 0), (1, 0), (1, 1))
NUM_ELEMENTS = len(ELEMENTS)
DIAG_INDICES = (0, 2)     # positions of (0,0) and (1,1) in ELEMENTS
OFFDIAG_INDEX = 1         # position of (1,0)


def diag_rows(x):
    """``x[list(DIAG_INDICES)]``, a copy: the two diagonal elements' rows of
    the first axis, gathered without an index list.  An index list is copied
    from the host to the device on every call, which a CUDA graph cannot
    capture (:mod:`gple_tpu_torch.ops.graphs`)."""
    return torch.stack([x[k] for k in DIAG_INDICES])


def element_index(row: int, col: int) -> int:
    """Position of element (row, col) in :data:`ELEMENTS`; (0, 1) is the
    coherence, stored as its conjugate (1, 0)."""
    return {(0, 0): 0, (1, 0): 1, (0, 1): 1, (1, 1): 2}[(row, col)]


class Density(NamedTuple):
    """All sampled phase-space points.

    points: (3, N, PhaseDim) coordinates per element
    rho:    (3, N, 2) RI density values at those coordinates
    active: (3,) bool -- element carries non-negligible density
    """

    points: torch.Tensor
    rho: torch.Tensor
    active: torch.Tensor

    @property
    def num_points(self) -> int:
        return self.points.shape[1]

    @property
    def rho_complex(self):
        """Host-side complex numpy view (for analysis and tests)."""
        r = self.rho.detach().cpu().numpy()
        return r[..., 0] + 1.0j * r[..., 1]

    @classmethod
    def from_complex(cls, points, rho_complex, active, device="cuda") -> "Density":
        """A density from complex labels (3, N), on ``device``."""
        return cls(
            points=torch.as_tensor(points, dtype=torch.float64, device=device),
            rho=ri.from_complex(torch.as_tensor(rho_complex, dtype=torch.complex128,
                                                device=device)),
            active=torch.as_tensor(active, dtype=torch.bool, device=device),
        )

    def element(self, row: int, col: int):
        """(points, rho) of element (row, col)."""
        k = element_index(row, col)
        return self.points[k], self.rho[k]


def make_density(num_points: int, r0, active, dtype=torch.float64, device="cuda") -> Density:
    """Seed every element with ``num_points`` copies of r0 and zero labels
    (main.cpp:44-56)."""
    r0 = torch.as_tensor(r0, dtype=dtype, device=device)
    pts = r0[None, None, :].repeat(NUM_ELEMENTS, num_points, 1)
    rho = torch.zeros((NUM_ELEMENTS, num_points, 2), dtype=dtype, device=device)
    return Density(points=pts, rho=rho,
                   active=torch.as_tensor(active, dtype=torch.bool, device=device))


class GPStates(NamedTuple):
    """Fitted GP surrogates for every element.  ``diag`` is a batched (leading
    axis 2) RealTrainState over the two diagonal elements; ``offdiag`` the
    complex state of (1,0)."""

    diag: RK.RealTrainState
    offdiag: CK.ComplexTrainState
    active: torch.Tensor  # (3,) same convention as Density.active

    def _diag_mask(self):
        return diag_rows(self.active)

    def population(self):
        return torch.sum(self.population_each())

    def population_each(self):
        return torch.where(self._diag_mask(), RK.population(self.diag), 0.0)

    def r_average(self):
        r = RK.r_average(self.diag)
        return torch.sum(torch.where(self._diag_mask()[:, None], r, 0.0), dim=0)

    def total_energy(self, surface_energies):
        """Population-weighted energies, with per-surface energies supplied by
        the Monte-Carlo estimate (predict.cpp:421-436)."""
        return torch.sum(self.population_each() * surface_energies)

    def purity(self):
        total = torch.sum(torch.where(self._diag_mask(), RK.purity(self.diag), 0.0))
        pur_off = CK.purity_complex(self.offdiag)
        return total + torch.where(self.active[OFFDIAG_INDEX], 2.0 * pur_off, 0.0)


def fit_gp_states(
    diag_params: RK.KernelParams,
    offdiag_params: CK.ComplexKernelParams,
    density: Density,
    prev: "GPStates" = None,
    off_extra=None,
    block_diag: bool = False,
) -> GPStates:
    """Refactorize all element GPs from the current points.

    ``prev`` is the previous tick's states (the warm start, which the direct
    Cholesky does not need).  ``block_diag``: the caller guarantees the
    off-diagonal corr parameter is 0, so the complex fit splits into two
    (N, N) blocks; otherwise the coherence is fitted through its full (2N, 2N)
    embedding, warm-started from ``prev.offdiag.augmented_inverse()``.
    ``off_extra`` = (points (k, D), rho (k, 2)) joins the coherence's fit
    only (the booster, GPLEConfig.coh_fit_extra).  Diagonal lengths are
    (2, D) vectors or (2, D, D) characteristic matrices (full ARD, whose Grams
    take transformed points in a launch of their own)."""
    diag_pts = diag_rows(density.points)                 # (2, N, D)
    diag_rho = diag_rows(density.rho[..., 0])
    off_pts = density.points[OFFDIAG_INDEX]              # (N, D)
    off_rho = density.rho[OFFDIAG_INDEX]
    if off_extra is not None:
        off_pts = torch.cat([off_pts, off_extra[0]])     # (N + k, D)
        off_rho = torch.cat([off_rho, off_extra[1]])
    same_shape = off_pts.shape[0] == diag_pts.shape[1]
    vector = diag_params.lengths.dim() == 2

    off_lengths = CK.sub_gram_lengths(offdiag_params)
    off_pts3 = off_pts.expand((3,) + off_pts.shape)
    if same_shape and vector:
        # the step's five (N, N) unit grams in one launch
        pts = torch.cat([diag_pts, off_pts3])
        g = gram_rbf(torch.cat([diag_params.lengths, off_lengths]), pts, pts)
        g_d, g_o = g[:2], g[2:]
    else:
        g_d = RK.gram(diag_params.lengths, diag_pts, diag_pts)
        g_o = gram_rbf(off_lengths, off_pts3, off_pts3)
    k_d = RK.scale_gram(diag_params, g_d, same=True)
    k64, kt_re64, kt_im64 = CK.covariance_from_grams(offdiag_params, g_o[0], g_o[1], g_o[2],
                                                      same=True)
    if not block_diag:
        m = CK.augmented_matrix(k64, kt_re64, kt_im64)
        if prev is None:
            kinv_d, w = psd_inverse_batched(k_d), psd_inverse(m)
        else:
            kinv_d = psd_inverse_warm_batched(k_d, prev.diag.kinv)
            w = psd_inverse_warm(m, prev.offdiag.augmented_inverse())
        diag = RK.finish_real_fit(diag_params, diag_pts, diag_rho, k_d, kinv_d)
        off = CK.finish_complex_fit_full(offdiag_params, off_pts, off_rho, k64, kt_re64,
                                         kt_im64, w)
        return GPStates(diag=diag, offdiag=off, active=density.active)
    k_o = torch.stack([k64 + kt_re64, k64 - kt_re64])
    if same_shape:
        ks = torch.cat([k_d, k_o])
        if prev is None:
            winv = psd_inverse_batched(ks)
        else:
            warm = torch.cat([prev.diag.kinv, torch.stack(prev.offdiag.diag_blocks())])
            winv = psd_inverse_warm_batched(ks, warm)
        kinv_d, w_o = winv[:2], winv[2:]
    elif prev is None:
        kinv_d, w_o = psd_inverse_batched(k_d), psd_inverse_batched(k_o)
    else:
        kinv_d = psd_inverse_warm_batched(k_d, prev.diag.kinv)
        w_o = psd_inverse_warm_batched(k_o, torch.stack(prev.offdiag.diag_blocks()))
    diag = RK.finish_real_fit(diag_params, diag_pts, diag_rho, k_d, kinv_d)
    off = CK.finish_complex_fit(offdiag_params, off_pts, off_rho, k64, kt_re64, kt_im64,
                                w_o[0], w_o[1])
    return GPStates(diag=diag, offdiag=off, active=density.active)


def _index_state(tree, i: int):
    """Element ``i`` of every leaf of a (nested) NamedTuple of tensors."""
    if isinstance(tree, tuple):
        return type(tree)(*(_index_state(leaf, i) for leaf in tree))
    return tree[i]


def predict_element(gps: GPStates, elem: int, pts, with_variance: bool = True):
    """Cutoff GP prediction for one element at ``pts`` (M, PhaseDim); zero when
    the element is inactive.  Returns an RI tensor (M, 2)."""
    if elem == OFFDIAG_INDEX:
        _, _, cut = CK.predict_complex(gps.offdiag, pts, with_variance)
    else:
        state = _index_state(gps.diag, 0 if elem == 0 else 1)
        _, _, mean_cut = RK.predict_real(state, pts, with_variance)
        cut = ri.ri(mean_cut)
    return torch.where(gps.active[elem], cut, 0.0)


def predict_all(gps: GPStates, pts3, with_variance: bool = True,
                off_with_variance: "bool | None" = None, targets: "tuple | None" = None):
    """Every element's :func:`predict_element` at once: pts (3, M, PhaseDim)
    -> (3, M, 2) RI.  Both diagonal elements go through one batched predict
    (one kernel launch), the off-diagonal through one complex predict, whose
    cutoff ``off_with_variance`` defaults to ``with_variance``.  ``targets``
    (3 host bools, None for all) names the elements to predict; the others'
    rows are zeros and cost nothing (a lone diagonal target is predicted
    alone)."""
    if off_with_variance is None:
        off_with_variance = with_variance
    if targets is None:
        targets = (True,) * NUM_ELEMENTS
    rows = [None if on else torch.zeros(pts3.shape[1], 2, dtype=pts3.dtype,
                                        device=pts3.device) for on in targets]
    diag = [k for k in DIAG_INDICES if targets[k]]
    if len(diag) == 2:
        _, _, diag_cut = RK.predict_real(gps.diag, diag_rows(pts3), with_variance)
        rows[0], rows[2] = ri.ri(diag_cut[0]), ri.ri(diag_cut[1])
    elif diag:
        (k,) = diag
        rows[k] = predict_element(gps, k, pts3[k], with_variance)
    if targets[OFFDIAG_INDEX]:
        _, _, rows[OFFDIAG_INDEX] = CK.predict_complex(gps.offdiag, pts3[OFFDIAG_INDEX],
                                                       off_with_variance)
    out = torch.stack(rows)
    return torch.where(gps.active[:, None, None], out, 0.0)


def make_distribution(gps: GPStates, with_variance: bool = True) -> Callable:
    """Batched distribution function: pts (3, M, PhaseDim) -> (3, M, 2) RI,
    one row per element."""

    def dist(pts_per_elem):
        return predict_all(gps, pts_per_elem, with_variance)

    return dist
