"""The benchmark's frozen arithmetic: the hand-written kernels' least times
(bound), the forward kernels' and the length cotangents', and the
floating-point operations one tick of a trajectory needs.

The bounds are a copy of the port's kernel-bench formulas (H100 SXM at 700
W): the larger of the bytes moved (each input read once, each output written
once) over 3.35 TB/s and the FP64 instructions issued over 17 G per ms (34
TFLOP/s, the FP64 pipe without tensor cores; an exp counts 15
instructions).  The tick count is of algorithmic operations (an exp counts
one) from the configuration's sizes alone, so it reads the same whatever
implements the tick."""

from __future__ import annotations

HBM_BYTES_PER_MS = 3.35e9
FP64_INSTR_PER_MS = 17e9
EXP_F64_DP_INSTR = 15
#: H100 SXM FP64 tensor-core peak, the denominator of ``tick_mfu``
FP64_PEAK_FLOPS = 67e12


def _bound(moved: float, ops: float) -> tuple[float, str]:
    by_bytes, by_ops = moved / HBM_BYTES_PER_MS, ops / FP64_INSTR_PER_MS
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def gram_dp_per_entry(d: int) -> int:
    """D differences, D squares summed, the -1/2 scale and the exp."""
    return 2 * d + 1 + EXP_F64_DP_INSTR


def gram_bound(batch, na, nb, d, itemsize=8) -> tuple[float, str]:
    """(ms, what bounds it) for one (B, Na, Nb) ``rbf_gram``."""
    moved = itemsize * (batch * na * nb + batch * (na + nb) * d + batch * d)
    ops = batch * na * nb * gram_dp_per_entry(d) if itemsize == 8 else 0
    return _bound(moved, ops)


def predict_bound(batch, m, n, c, d, itemsize=8) -> tuple[float, str]:
    """(ms, what bounds it) for one ``rbf_predict_mean``: per (test, train,
    length set) the Gram entry's instructions plus C multiply-adds."""
    moved = itemsize * (batch * (m * d + n * d + n * c + d) + batch * m * c)
    ops = batch * m * n * (gram_dp_per_entry(d) + c) if itemsize == 8 else 0
    return _bound(moved, ops)


def vjp_dp_per_pair(d: int, c: int = 0) -> int:
    """A length cotangent's instructions per (row, column) pair: D
    differences, D squares and D - 1 additions for the distance, the -1/2
    scale, the exp, the weight times the exp, D multiply-adds into the sums,
    and C for a rank-C weight."""
    return (d + d + (d - 1)) + 1 + EXP_F64_DP_INSTR + 1 + d + c


def gram_vjp_bound(batch, na, nb, d, itemsize=8) -> tuple[float, str]:
    """(ms, what bounds it) for one ``rbf_gram_vjp``: the dense cotangent,
    the points and the lengths read once, the (B, D) written."""
    moved = itemsize * (batch * na * nb + batch * (na + nb) * d + 2 * batch * d)
    ops = batch * na * nb * vjp_dp_per_pair(d) if itemsize == 8 else 0
    return _bound(moved, ops)


def predict_vjp_bound(batch, m, n, c, d, itemsize=8) -> tuple[float, str]:
    """(ms, what bounds it) for one ``rbf_predict_vjp``: points, cotangent,
    alpha and lengths read once, the (B, D) written."""
    moved = itemsize * (batch * (m + n) * (d + c) + 2 * batch * d)
    ops = batch * m * n * vjp_dp_per_pair(d, c) if itemsize == 8 else 0
    return _bound(moved, ops)


def _itemsize(dtype: str) -> int:
    return 8 if dtype == "float64" else 4


def _vjp_symbols(c_values) -> tuple:
    """The device kernel ``rbf_vjp_kernel<T, D, C, VEC>`` at every type, D of
    1 to 4 and C of ``c_values``: C = 0 is ``rbf_gram_vjp``, C >= 1
    ``rbf_predict_vjp``."""
    return tuple(f"rbf_vjp_kernel<{t}, {d}, {c}," for t in ("double", "float")
                 for d in range(1, 5) for c in c_values)


#: (kernel as counted by the port, device kernels of its launch, bound of a shape)
KERNELS = {
    "rbf_gram": (("rbf_gram_kernel",),
                 lambda s: gram_bound(s[0], s[1], s[2], s[3], _itemsize(s[4]))),
    "rbf_predict_mean": (("rbf_predict_partial_kernel", "rbf_predict_reduce_kernel"),
                         lambda s: predict_bound(s[0], s[1], s[2], s[3], s[4],
                                                 _itemsize(s[5]))),
    "rbf_gram_vjp": (_vjp_symbols((0,)),
                     lambda s: gram_vjp_bound(s[0], s[1], s[2], s[3], _itemsize(s[4]))),
    "rbf_predict_vjp": (_vjp_symbols((1, 2)),
                        lambda s: predict_vjp_bound(s[0], s[1], s[2], s[3], s[4],
                                                    _itemsize(s[5]))),
}


# -- one tick's operations ----------------------------------------------------------

D = 2            # phase-space dimensions (x, p)


def entry_flops(rhs: int = 0) -> int:
    """One RBF kernel entry: D differences, D scalings, D squares summed (2D),
    the -1/2 scale and the exp; then 2 per right-hand side."""
    return 4 * D + 2 + 2 * rhs


def _sets(elem: int) -> int:
    """Kernels of an element's prediction: one real; two for the coherence
    (its real and imaginary parts; the correlation kernel is zero)."""
    return 2 if elem == 1 else 1


def mean_flops(m: int, n: int, elem: int) -> float:
    return _sets(elem) * m * n * entry_flops(1)


def variance_flops(m: int, n: int, elem: int) -> float:
    """Mean and variance at m points: the kernel rows, k K^-1 (a GEMM) and the
    row sums."""
    return _sets(elem) * (m * n * entry_flops(1) + 2.0 * m * n * n + 2.0 * m * n)


def fit_flops(n: int, elem: int) -> float:
    """Gram, Cholesky (n^3 / 3), inverse from it (2 n^3 / 3) and the refined
    solve (4 to 5 matrix-vector products of 2 n^2, counted as 5)."""
    return _sets(elem) * (n * n * entry_flops() + n ** 3 + 5 * 2.0 * n * n)


def observe_flops(n: int, elem: int) -> float:
    """The purity integral's widened Gram and quadratic form; the point sums."""
    return _sets(elem) * (n * n * entry_flops() + 2.0 * n * n) + 10.0 * n


def tick_flops(n: int, n_extra: int, active, reopt_freq: int) -> float:
    """The operations one tick needs, the period's reoptimization spread over
    its ticks, with ``active`` the elements (0,0), (1,0), (1,1) that carry
    density:

    - evolve: 9 branch queries a point (3 sources x 3 branches) for each
      active target element, of the N points and of the 5N extra points;
    - the activation test: for each inactive element, 3 branch queries at
      each of the 3N points of every element, predicted with variance by
      each active element (an inactive element predicts zero);
    - the refit and the observables of each active element;
    - a period's end: the moment fit of each active element, the refit and
      the extra cloud's labels at 5N points."""
    on = [k for k in range(3) if active[k]]
    off = [k for k in range(3) if not active[k]]
    evolve = sum(mean_flops(9 * n, n, k) + mean_flops(9 * n_extra, n, k) for k in on)
    small = len(off) * sum(variance_flops(3 * 3 * n, n, k) for k in on)
    refit = sum(fit_flops(n, k) + observe_flops(n, k) for k in on)
    period = sum(2 * fit_flops(n, k) + mean_flops(n_extra, n, k) + observe_flops(n, k)
                 for k in on)
    return evolve + small + refit + period / reopt_freq


def cutoff_tick_flops(n: int, n_extra: int, active, reopt_freq: int) -> float:
    """:func:`tick_flops` of a trajectory that evolves with the cutoff means
    and reoptimizes by the ladder (``reference_parity``): every evolve query
    carries its variance, and a period's end is the refit, the extra cloud's
    labels with their variance and the observables.  The ladder's own work
    is :func:`ladder_eval_flops` for each loss evaluation."""
    on = [k for k in range(3) if active[k]]
    off = [k for k in range(3) if not active[k]]
    evolve = sum(variance_flops(9 * n, n, k) + variance_flops(9 * n_extra, n, k) for k in on)
    small = len(off) * sum(variance_flops(3 * 3 * n, n, k) for k in on)
    refit = sum(fit_flops(n, k) + observe_flops(n, k) for k in on)
    period = sum(fit_flops(n, k) + variance_flops(n_extra, n, k) + observe_flops(n, k)
                 for k in on)
    return evolve + small + refit + period / reopt_freq


def ladder_eval_flops(n: int, n_extra: int, active) -> float:
    """One value and gradient of the ladder's loss and constraints: for each
    active diagonal element the unit-magnitude fit, the leave-one-out error
    (2n), the mean at its n_extra extra points and the population and purity
    integrals; the gradient by reverse mode at twice the forward's
    operations."""
    forward = sum(fit_flops(n, k) + 2.0 * n + mean_flops(n_extra, n, k) + observe_flops(n, k)
                  for k in (0, 2) if active[k])
    return 3.0 * forward
