"""RBF Gram and fused predict-mean: CUDA kernels, their plain versions and gradients.

Counterpart of :mod:`gple_tpu.ops.pallas_gram`.  Each of the two Pallas TPU
kernels there has a hand-written CUDA kernel here (sources in
``gple_tpu_torch/csrc/``), a plain PyTorch version of the same function, and
a dispatching entry point:

* :func:`gram_rbf` -- ``exp(-1/2 |(xa_i - xb_j) / l|^2)``, batched over length
  sets (replaces ``gram_pallas``);
* :func:`predict_mean_rbf` -- ``gram @ alpha`` without materialising the
  cross-kernel (replaces ``predict_mean_pallas``).

Both entry points are differentiable in the lengths (the predict also in
``alpha``, the Gram also in both point sets) through the autograd Functions
:class:`RBFGram` and :class:`RBFPredictMean`.  Their backward is three more
hand-written kernels (``csrc/rbf_vjp.cu``), each beside its plain version:
``rbf_gram_vjp`` (the length cotangent of a Gram from its dense cotangent),
``rbf_predict_vjp`` (the length cotangent of a predict mean, whose weight
``g alpha^T`` has rank C) and ``rbf_gram_vjp_points`` (a Gram's cotangents
with respect to both point sets, or either one, in one launch).  The
full-ARD matrix lengths of validation reach the Gram as transformed points
``z = W x`` with unit lengths, so their gradient runs through the last one.
The ``alpha`` cotangent of a predict is ``rbf_predict_mean`` with the test
and training points swapped.  A predict's gradient with respect to its points
raises: nothing differentiates it.

Dispatch is by the device of the tensors alone, forward and backward: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel (or the
launch raises), and any other device raises.  There is no fallback from the
kernel to the plain version.  The raw launchers (``*_cuda``) refuse a tensor
that requires grad while grad mode is on: the only way to differentiate
through a kernel is its Function.  Every kernel launch adds one to
:data:`LAUNCHES` and to its shape's entry in :data:`LAUNCHES_BY_SHAPE`, so a
run can show that its path went through the kernels, and at which shapes; a
launch inside a CUDA graph counts at each replay of the graph, not at its
capture (:func:`count_launches`).

The entry points take batched operands whose leading dimensions broadcast:
``lengths (..., D)``, ``xa (..., Na, D)``, ``xb (..., Nb, D)``, ``alpha
(..., N, C)``.  The kernels read their inputs through strides, so a point set
broadcast over several length sets is never copied.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

#: kernel launches since the last reset, by kernel name
LAUNCHES = {"rbf_gram": 0, "rbf_predict_mean": 0, "rbf_gram_vjp": 0, "rbf_predict_vjp": 0,
            "rbf_gram_vjp_points": 0}
#: the same launches by (kernel name, shape): ``rbf_gram``, ``rbf_gram_vjp``
#: and ``rbf_gram_vjp_points`` shapes are (B, Na, Nb, D, dtype),
#: ``rbf_predict_mean`` and ``rbf_predict_vjp`` shapes (B, M, N, C, D, dtype)
LAUNCHES_BY_SHAPE: dict = {}
#: how ``rbf_gram_vjp`` read its cotangents since the last reset (see
#: :func:`gram_vjp_read`), launches by read
GRAM_VJP_READS: dict = {}
#: the cotangents ``rbf_gram_vjp_points`` read since the last reset, launches
#: by (strides, sides asked); :func:`points_vjp_read` names the branch
POINTS_VJP_READS: dict = {}

#: phase-space dimensions the kernels are instantiated for
MAX_DIM = 4
#: right-hand sides the predict kernel is instantiated for
MAX_RHS = 2
#: output rows per block of the gram kernel (``kRowsPerBlock`` in csrc/rbf_gram.cu)
GRAM_ROWS_PER_BLOCK = 128
#: test rows per block of the predict kernel (``kRowsPerBlock`` in csrc/rbf_predict.cu)
PREDICT_ROWS_PER_BLOCK = 256
#: training points a predict block holds in shared memory (``kMaxChunk``)
PREDICT_MAX_CHUNK = 1024
#: threads of a block of the length-cotangent kernel and the adjacent columns
#: each owns (``kThreads``, ``kCols`` in csrc/rbf_vjp.cu)
VJP_THREADS = 256
VJP_COLS_PER_THREAD = 2
VJP_COLS_PER_BLOCK = VJP_THREADS * VJP_COLS_PER_THREAD
#: most rows a length-cotangent block walks (``kMaxRows``: their scaled points
#: and g rows sit in shared memory)
VJP_MAX_ROWS = 256
#: threads of a block of the points cotangent and the sum-axis points it
#: stages at a time (``kPairThreads``, ``kPairChunk`` in csrc/rbf_vjp.cu)
POINTS_THREADS = 256
POINTS_CHUNK = 256
#: most own points (rows of G for xa's side, columns for xb's) a block takes
#: (``kPairMaxOwn``: their slice of G sits in shared memory)
POINTS_MAX_OWN = 16
_MAX_GRID_X = 2**31 - 1
_MAX_GRID_YZ = 65535
_MAX_INT = 2**31 - 1
#: resident 4-warp predict blocks an SM needs to keep its FP64 pipe busy (12
#: fit at the kernel's 40 registers a thread)
_FILL_BLOCKS = 12
#: a predict block's set-up (copy, scale, barrier, epilogue) in training points
_BLOCK_SETUP = 8
#: fewest training points a predict block takes when N is split
_MIN_CHUNK = 32
#: length-cotangent blocks the plan aims to put on each SM
_VJP_BLOCKS_PER_SM = 4
#: fewest rows a length-cotangent block walks: at validation's B = 1 shapes
#: (~150-200 rows) short blocks in a sparse grid finish first
_VJP_MIN_ROWS = 2
#: points-cotangent blocks the plan aims to put on each SM (three fit at the
#: kernel's 80 registers a thread): a sweep of own = 1-16 on the H100 found
#: own = 4 fastest at B = 1, 160^2 and 200^2 and own = 8 at 1024^2, one wave of
#: 100, 80 and 256 blocks; own = 4 at 1024^2 is two waves
_POINTS_BLOCKS_PER_SM = 2
#: fewest own points a points-cotangent block takes: xb's side stages G's
#: rows in runs of this many elements, 4 doubles = one 32-byte sector
_POINTS_MIN_OWN = 4


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCHES_BY_SHAPE.clear()
    GRAM_VJP_READS.clear()
    POINTS_VJP_READS.clear()


def _count_launch(name: str, shape: tuple) -> None:
    LAUNCHES[name] += 1
    key = (name, shape)
    LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + 1


def count_launches(by_shape: dict, times: int = 1) -> None:
    """Add ``times`` x the launches ``by_shape`` ((kernel, shape) -> count) to
    the counters: a CUDA graph's replay launches what its capture recorded
    (:mod:`gple_tpu_torch.ops.graphs`), and the capture itself launches none."""
    for (name, shape), n in by_shape.items():
        LAUNCHES[name] += n * times
        key = (name, shape)
        LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + n * times


# -- plain PyTorch versions (the CPU path and the on-card reference) -------------

def gram_plain(lengths, xa, xb):
    """Broadcast-difference RBF Gram, the formula of ``gple_tpu.ops.kernels.gram``;
    the squared distance is summed one dimension at a time (no (Na, Nb, D)
    intermediate, and no reduction over a short last axis)."""
    za = xa / lengths[..., None, :]
    zb = xb / lengths[..., None, :]
    d2 = 0.0
    for d in range(za.shape[-1]):
        d2 = d2 + (za[..., :, None, d] - zb[..., None, :, d]) ** 2
    return torch.exp(-0.5 * d2)


def predict_mean_plain(lengths, x_test, x_train, alpha):
    """``gram_plain(lengths, x_test, x_train) @ alpha``; alpha is (..., N, C)."""
    return gram_plain(lengths, x_test, x_train) @ alpha


def gram_vjp_plain(lengths, xa, xb, gout):
    """The length cotangent ``(..., D)`` of :func:`gram_plain` for the Gram's
    cotangent ``gout (..., Na, Nb)``:
    ``sum_ij gout_ij k_ij (za_id - zb_jd)^2 / l_d``."""
    za = xa / lengths[..., None, :]
    zb = xb / lengths[..., None, :]
    sq = (za[..., :, None, :] - zb[..., None, :, :]) ** 2
    k = torch.exp(-0.5 * torch.sum(sq, dim=-1))
    return torch.sum((gout * k)[..., None] * sq, dim=(-3, -2)) / lengths


def predict_vjp_plain(lengths, x_test, x_train, alpha, g):
    """The length cotangent ``(..., D)`` of :func:`predict_mean_plain` for the
    output's cotangent ``g (..., M, C)``: :func:`gram_vjp_plain` with the
    rank-C weight ``g alpha^T``."""
    return gram_vjp_plain(lengths, x_test, x_train, g @ alpha.transpose(-1, -2))


def gram_vjp_points_plain(lengths, xa, xb, gout):
    """The cotangent ``(..., Na, D)`` of :func:`gram_plain` with respect to
    ``xa`` for the Gram's cotangent ``gout (..., Na, Nb)``:
    ``sum_j gout_ij k_ij (zb_jd - za_id) / l_d``."""
    za = xa / lengths[..., None, :]
    zb = xb / lengths[..., None, :]
    diff = zb[..., None, :, :] - za[..., :, None, :]
    k = torch.exp(-0.5 * torch.sum(diff**2, dim=-1))
    return torch.sum((gout * k)[..., None] * diff, dim=-2) / lengths[..., None, :]


def gram_vjp_points_pair_plain(lengths, xa, xb, gout, want_a=True, want_b=True):
    """``(d_xa, d_xb)``, the plain counterpart of :func:`gram_vjp_points_cuda`:
    :func:`gram_vjp_points_plain` for ``xa`` and, with the point sets swapped
    and the cotangent transposed, for ``xb``; a side not asked for is None."""
    return (gram_vjp_points_plain(lengths, xa, xb, gout) if want_a else None,
            gram_vjp_points_plain(lengths, xb, xa, gout.transpose(-1, -2)) if want_b else None)


# -- CUDA launchers ----------------------------------------------------------------

def _launcher(prefix: str, dtype):
    from gple_tpu_torch.ops import _build

    lib = _build.library()
    if dtype == torch.float64:
        return getattr(lib, f"{prefix}_f64")
    if dtype == torch.float32:
        return getattr(lib, f"{prefix}_f32")
    raise TypeError(f"{prefix}: dtype {dtype} not supported (float32 or float64)")


def _check_cuda(name: str, *tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: an operand requires grad, and the raw launcher "
                           "records no gradient; differentiate through gram_rbf / "
                           "predict_mean_rbf (the RBFGram / RBFPredictMean Functions)")
    dev, dtype = tensors[0].device, tensors[0].dtype
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: operands must share one device and dtype, "
                             f"got {[(x.device, x.dtype) for x in tensors]}")
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {dev}")


def _raise_on(name: str, err: int):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def gram_grid(batch: int, na: int, nb: int, d: int, dtype) -> tuple[int, int, int]:
    """The gram kernel's grid (column tiles, row tiles, B); raises ValueError
    where the shape is outside what the kernel or the grid takes.  A warp
    covers 32 rows x 16 bytes of columns per lane."""
    cols_per_block = 32 * (16 // dtype.itemsize)
    grid = (_cdiv(nb, cols_per_block), _cdiv(na, GRAM_ROWS_PER_BLOCK), batch)
    if (not 1 <= d <= MAX_DIM or max(na, nb) > _MAX_INT or grid[0] > _MAX_GRID_X
            or max(grid[1:]) > _MAX_GRID_YZ):
        raise ValueError(f"rbf_gram: D={d}, B={batch}, Na={na}, Nb={nb} outside the "
                         "kernel's range")
    return grid


@functools.lru_cache(maxsize=256)
def predict_plan(batch: int, m: int, n: int, num_sms: int) -> tuple[int, int]:
    """(splits, chunk) for the predict kernel: its grid is (row tiles, splits,
    B) and each block holds ``chunk`` training points, the last one fewer.

    The chosen split is the one that the busiest SM finishes first, counting
    each block's chunk plus a fixed set-up, when every SM's share of the
    blocks runs together and an SM with fewer than ``_FILL_BLOCKS`` of them is
    slowed in proportion (too few exp chains to hide the FP64 latency)."""
    tiles = batch * _cdiv(m, PREDICT_ROWS_PER_BLOCK)
    fewest = _cdiv(n, PREDICT_MAX_CHUNK)
    best = None
    for s in range(fewest, max(fewest, min(n // _MIN_CHUNK, _MAX_GRID_YZ)) + 1):
        chunk = _cdiv(n, s)
        if _cdiv(n, chunk) != s:  # the same chunks as a smaller s
            continue
        per_sm = _cdiv(tiles * s, num_sms)
        cost = per_sm * (chunk + _BLOCK_SETUP) * _FILL_BLOCKS / min(per_sm, _FILL_BLOCKS)
        if best is None or cost < best[0]:
            best = (cost, s, chunk)
    return best[1], best[2]


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def gram_cuda(lengths, xa, xb):
    """Launch the ``rbf_gram`` kernel on (B, D), (B, Na, D), (B, Nb, D) CUDA
    tensors; returns a new contiguous (B, Na, Nb) tensor."""
    _check_cuda("rbf_gram", lengths, xa, xb)
    batch, na, d = xa.shape
    nb = xb.shape[1]
    if xb.shape != (batch, nb, d) or lengths.shape != (batch, d):
        raise ValueError(f"rbf_gram: shapes {tuple(lengths.shape)}, {tuple(xa.shape)}, "
                         f"{tuple(xb.shape)} do not form (B, D), (B, Na, D), (B, Nb, D)")
    gram_grid(batch, na, nb, d, xa.dtype)
    fn = _launcher("rbf_gram", xa.dtype)
    with torch.cuda.device(xa.device):
        out = torch.empty((batch, na, nb), dtype=xa.dtype, device=xa.device)
        if out.numel() == 0:
            return out
        stream = torch.cuda.current_stream(xa.device).cuda_stream
        err = fn(xa.data_ptr(), xb.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 batch, na, nb, d, *xa.stride(), *xb.stride(), *lengths.stride(), stream)
    _raise_on("rbf_gram", err)
    _count_launch("rbf_gram", (batch, na, nb, d, str(xa.dtype)[6:]))
    return out


def predict_mean_cuda(lengths, x_test, x_train, alpha):
    """Launch the ``rbf_predict_mean`` kernel on (B, D), (B, M, D), (B, N, D),
    (B, N, C) CUDA tensors; returns a new contiguous (B, M, C) tensor.  Where
    :func:`predict_plan` splits N, the partial sums go to a scratch tensor
    (splits, B, M, C) allocated here."""
    _check_cuda("rbf_predict_mean", lengths, x_test, x_train, alpha)
    batch, m, d = x_test.shape
    n, c = x_train.shape[1], alpha.shape[-1]
    if (x_train.shape != (batch, n, d) or lengths.shape != (batch, d)
            or alpha.shape != (batch, n, c)):
        raise ValueError(
            f"rbf_predict_mean: shapes {tuple(lengths.shape)}, {tuple(x_test.shape)}, "
            f"{tuple(x_train.shape)}, {tuple(alpha.shape)} do not form "
            "(B, D), (B, M, D), (B, N, D), (B, N, C)")
    if (not 1 <= d <= MAX_DIM or not 1 <= c <= MAX_RHS or batch > _MAX_GRID_YZ
            or max(m, n) > _MAX_INT):
        raise ValueError(f"rbf_predict_mean: D={d}, C={c}, B={batch}, M={m}, N={n} "
                         "outside the kernel's range")
    fn = _launcher("rbf_predict_mean", x_test.dtype)
    dev = x_test.device
    with torch.cuda.device(dev):
        out = torch.empty((batch, m, c), dtype=x_test.dtype, device=dev)
        if out.numel() == 0:
            return out
        if n == 0:
            return out.zero_()
        splits, chunk = predict_plan(batch, m, n, _sm_count(dev))
        # partial sums of each split, added in split order by the kernel's second pass
        scratch = (torch.empty((splits, batch, m, c), dtype=out.dtype, device=dev)
                   if splits > 1 else None)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x_test.data_ptr(), x_train.data_ptr(), lengths.data_ptr(),
                 alpha.data_ptr(), out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), batch, m, n, d, c,
                 splits, chunk, *x_test.stride(), *x_train.stride(), *lengths.stride(),
                 *alpha.stride(), stream)
    _raise_on("rbf_predict_mean", err)
    _count_launch("rbf_predict_mean", (batch, m, n, c, d, str(x_test.dtype)[6:]))
    return out


class VjpPlan(NamedTuple):
    """A launch of the length-cotangent kernel: grid (``col_tiles``,
    ``row_blocks``, ``batch``); block (x, y, b) takes rows [y * rows,
    min((y + 1) * rows, Na)) against columns [x * VJP_COLS_PER_BLOCK,
    min((x + 1) * VJP_COLS_PER_BLOCK, Nb)) of batch entry b, and writes one
    partial sum per dimension to the scratch."""

    rows: int
    row_blocks: int
    col_tiles: int
    batch: int

    @property
    def grid(self) -> tuple[int, int, int]:
        return self.col_tiles, self.row_blocks, self.batch

    def scratch_size(self, d: int) -> int:
        """Elements of the scratch: one partial per (block, dimension)."""
        return self.batch * self.row_blocks * self.col_tiles * d


@functools.lru_cache(maxsize=256)
def vjp_plan(batch: int, na: int, nb: int, num_sms: int) -> VjpPlan:
    """The length-cotangent kernel's launch over (B, Na, Nb) pairs: rows a
    block so that the grid holds about ``_VJP_BLOCKS_PER_SM`` blocks an SM
    (at least ``_VJP_MIN_ROWS`` rows a block, at most ``VJP_MAX_ROWS``),
    evened out over the row blocks.  Raises ValueError where the grid would
    leave CUDA's limits."""
    col_tiles = _cdiv(nb, VJP_COLS_PER_BLOCK)
    rows = _cdiv(batch * col_tiles * na, num_sms * _VJP_BLOCKS_PER_SM)
    rows = min(max(rows, _VJP_MIN_ROWS, _cdiv(na, _MAX_GRID_YZ)), VJP_MAX_ROWS)
    row_blocks = _cdiv(na, rows)
    if (not 1 <= batch <= _MAX_GRID_YZ or min(na, nb) < 1 or max(na, nb) > _MAX_INT
            or row_blocks > _MAX_GRID_YZ or col_tiles * row_blocks * batch > _MAX_INT):
        raise ValueError(f"length cotangent: B={batch}, Na={na}, Nb={nb} outside the "
                         "kernel's grid")
    return VjpPlan(_cdiv(na, row_blocks), row_blocks, col_tiles, batch)


#: one launch counter (int32, holding 0 between launches) of the
#: length-cotangent kernel per device: its last block resets it
_TICKETS: dict = {}


def _ticket(dev):
    ticket = _TICKETS.get(dev)
    if ticket is None:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("length cotangent: the first launch on a device cannot be "
                               "captured (its counter is allocated then); launch once "
                               "before the capture")
        ticket = _TICKETS[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    return ticket


def vjp_scratch(plan: VjpPlan, d: int, like):
    """The partial sums' scratch of a length-cotangent launch."""
    return torch.empty(plan.scratch_size(d), dtype=like.dtype, device=like.device)


def _vjp_dims(name: str, d: int, c: int = 1):
    if not 1 <= d <= MAX_DIM or not 1 <= c <= MAX_RHS:
        raise ValueError(f"{name}: D={d}, C={c} outside the kernel's range")


def gram_vjp_read(gout):
    """How ``rbf_gram_vjp`` reads the cotangent (B, Na, Nb): ``(swap,
    vec)``.  ``swap``: the cotangent is transposed (row stride 1, column
    stride not), so the wrapper swaps the point sets and reads its
    transpose, contiguous along the rows.  ``vec``: the (swapped) cotangent
    is contiguous along its rows with even row and batch strides and an
    aligned pointer, so each thread copies two columns at once; otherwise
    the kernel's strided branch reads it through its strides."""
    swap = gout.stride(2) != 1 and gout.stride(1) == 1
    sb, si, sj = gout.stride(0), gout.stride(2 if swap else 1), gout.stride(1 if swap else 2)
    vec = (sj == 1 and si % 2 == 0 and sb % 2 == 0
           and gout.data_ptr() % (2 * gout.element_size()) == 0)
    return swap, vec


def gram_vjp_cuda(lengths, xa, xb, gout):
    """Launch ``rbf_gram_vjp`` on (B, D), (B, Na, D), (B, Nb, D) CUDA tensors and
    the Gram's cotangent (B, Na, Nb), read in place (:func:`gram_vjp_read`);
    returns a new contiguous (B, D) length cotangent.  The blocks' partial
    sums go to a scratch (:func:`vjp_plan`) allocated here; one launch adds
    them up."""
    _check_cuda("rbf_gram_vjp", lengths, xa, xb, gout)
    batch, na, d = xa.shape
    nb = xb.shape[1]
    if (xb.shape != (batch, nb, d) or lengths.shape != (batch, d)
            or gout.shape != (batch, na, nb)):
        raise ValueError(f"rbf_gram_vjp: shapes {tuple(lengths.shape)}, {tuple(xa.shape)}, "
                         f"{tuple(xb.shape)}, {tuple(gout.shape)} do not form (B, D), "
                         "(B, Na, D), (B, Nb, D), (B, Na, Nb)")
    _vjp_dims("rbf_gram_vjp", d)
    dev = xa.device
    if batch * na * nb == 0:
        with torch.cuda.device(dev):
            return torch.zeros((batch, d), dtype=xa.dtype, device=dev)
    key = (batch, na, nb, d, str(xa.dtype)[6:])
    swap, vec = gram_vjp_read(gout)
    if swap:  # the sum is symmetric in (xa, G) <-> (xb, G^T)
        xa, xb, gout, na, nb = xb, xa, gout.transpose(1, 2), nb, na
    fn = _launcher("rbf_gram_vjp", xa.dtype)
    with torch.cuda.device(dev):
        plan = vjp_plan(batch, na, nb, _sm_count(dev))
        out = torch.empty((batch, d), dtype=xa.dtype, device=dev)
        scratch = vjp_scratch(plan, d, xa)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(xa.data_ptr(), xb.data_ptr(), lengths.data_ptr(), gout.data_ptr(),
                 out.data_ptr(), scratch.data_ptr(), _ticket(dev).data_ptr(), batch, na, nb,
                 d, plan.rows, int(vec), *xa.stride(), *xb.stride(), *lengths.stride(),
                 *gout.stride(), stream)
    _raise_on("rbf_gram_vjp", err)
    _count_launch("rbf_gram_vjp", key)
    read = ("transposed, " if swap else "") + ("16-byte copies" if vec else "strided")
    GRAM_VJP_READS[read] = GRAM_VJP_READS.get(read, 0) + 1
    return out


def predict_vjp_cuda(lengths, x_test, x_train, alpha, g):
    """Launch ``rbf_predict_vjp`` on (B, D), (B, M, D), (B, N, D), (B, N, C) CUDA
    tensors and the output's cotangent g (B, M, C); returns a new contiguous
    (B, D) length cotangent (plan and scratch as :func:`gram_vjp_cuda`)."""
    _check_cuda("rbf_predict_vjp", lengths, x_test, x_train, alpha, g)
    batch, m, d = x_test.shape
    n, c = x_train.shape[1], alpha.shape[-1]
    if (x_train.shape != (batch, n, d) or lengths.shape != (batch, d)
            or alpha.shape != (batch, n, c) or g.shape != (batch, m, c)):
        raise ValueError(
            f"rbf_predict_vjp: shapes {tuple(lengths.shape)}, {tuple(x_test.shape)}, "
            f"{tuple(x_train.shape)}, {tuple(alpha.shape)}, {tuple(g.shape)} do not form "
            "(B, D), (B, M, D), (B, N, D), (B, N, C), (B, M, C)")
    _vjp_dims("rbf_predict_vjp", d, c)
    dev = x_test.device
    if batch * m * n == 0:
        with torch.cuda.device(dev):
            return torch.zeros((batch, d), dtype=x_test.dtype, device=dev)
    fn = _launcher("rbf_predict_vjp", x_test.dtype)
    with torch.cuda.device(dev):
        plan = vjp_plan(batch, m, n, _sm_count(dev))
        out = torch.empty((batch, d), dtype=x_test.dtype, device=dev)
        scratch = vjp_scratch(plan, d, x_test)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x_test.data_ptr(), x_train.data_ptr(), lengths.data_ptr(), g.data_ptr(),
                 alpha.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                 _ticket(dev).data_ptr(), batch, m, n, d, c, plan.rows, *x_test.stride(),
                 *x_train.stride(), *lengths.stride(), *g.stride(), *alpha.stride(), stream)
    _raise_on("rbf_predict_vjp", err)
    _count_launch("rbf_predict_vjp", (batch, m, n, c, d, str(x_test.dtype)[6:]))
    return out


class PointsPlan(NamedTuple):
    """A launch of the points cotangent: grid (``tiles_a + tiles_b``,
    ``batch``); block (x, b) takes ``own`` rows [x * own, min((x + 1) * own,
    Na)) of G (the cotangent of xa) where x < ``tiles_a``, else ``own``
    columns [(x - tiles_a) * own, ...) of G (that of xb), and sums each of
    them over the whole other axis.  A side not asked for has no tiles."""

    own: int
    tiles_a: int
    tiles_b: int
    batch: int

    @property
    def grid(self) -> tuple[int, int]:
        return self.tiles_a + self.tiles_b, self.batch


@functools.lru_cache(maxsize=256)
def points_plan(batch: int, na: int, nb: int, want_a: bool, want_b: bool,
                num_sms: int) -> PointsPlan:
    """The points cotangent's launch: own points a block, the power of two
    that puts about ``_POINTS_BLOCKS_PER_SM`` blocks on each SM, at least
    ``_POINTS_MIN_OWN`` and at most ``POINTS_MAX_OWN``.  Raises ValueError
    where the grid would leave CUDA's limits or no side is asked for."""
    points = batch * (na * want_a + nb * want_b)
    need = _cdiv(points, num_sms * _POINTS_BLOCKS_PER_SM)
    own = _POINTS_MIN_OWN
    while own < min(need, POINTS_MAX_OWN):
        own *= 2
    tiles_a, tiles_b = _cdiv(na, own) * want_a, _cdiv(nb, own) * want_b
    if (not (want_a or want_b) or not 1 <= batch <= _MAX_GRID_YZ or min(na, nb) < 1
            or max(na, nb) > _MAX_INT or tiles_a + tiles_b > _MAX_GRID_X):
        raise ValueError(f"points cotangent: B={batch}, Na={na}, Nb={nb}, sides "
                         f"{(want_a, want_b)} outside the kernel's grid")
    return PointsPlan(own, tiles_a, tiles_b, batch)


def points_vjp_read(strides, side: str) -> str:
    """How a points-cotangent block of ``side`` ("a": G's rows, "b": its
    columns) stages its slice of a cotangent of ``strides`` (batch, row,
    column) into shared memory: along the axis it sums over where G is
    contiguous there, along its own points where only they are (a run of
    ``own`` elements of each line), else through both strides."""
    own, summed = (strides[1], strides[2]) if side == "a" else (strides[2], strides[1])
    if summed == 1:
        return "along the summed axis, contiguous"
    if own == 1:
        return "along the own points, runs of own"
    return "strided"


def gram_vjp_points_cuda(lengths, xa, xb, gout, want_a=True, want_b=True):
    """Launch ``rbf_gram_vjp_points`` on (B, D), (B, Na, D), (B, Nb, D) CUDA
    tensors and the Gram's cotangent (B, Na, Nb), read through its strides (a
    transposed or broadcast view in place); returns ``(d_xa, d_xb)``, new
    contiguous (B, Na, D) and (B, Nb, D) cotangents of the two point sets,
    both from one launch, or None for a side not asked for (the kernel gets
    a null pointer for it).  One count a call."""
    _check_cuda("rbf_gram_vjp_points", lengths, xa, xb, gout)
    batch, na, d = xa.shape
    nb = xb.shape[1]
    if (xb.shape != (batch, nb, d) or lengths.shape != (batch, d)
            or gout.shape != (batch, na, nb)):
        raise ValueError(f"rbf_gram_vjp_points: shapes {tuple(lengths.shape)}, "
                         f"{tuple(xa.shape)}, {tuple(xb.shape)}, {tuple(gout.shape)} do not "
                         "form (B, D), (B, Na, D), (B, Nb, D), (B, Na, Nb)")
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"rbf_gram_vjp_points: D={d} outside the kernel's range")
    dev = xa.device
    with torch.cuda.device(dev):
        outs = [torch.empty((batch, n, d), dtype=xa.dtype, device=dev) if want else None
                for n, want in ((na, want_a), (nb, want_b))]
        if batch * na * nb == 0:
            return tuple(None if o is None else o.zero_() for o in outs)
        plan = points_plan(batch, na, nb, bool(want_a), bool(want_b), _sm_count(dev))
        fn = _launcher("rbf_gram_vjp_points", xa.dtype)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(xa.data_ptr(), xb.data_ptr(), lengths.data_ptr(), gout.data_ptr(),
                 *(None if o is None else o.data_ptr() for o in outs), batch, na, nb, d,
                 plan.own, *xa.stride(), *xb.stride(), *lengths.stride(), *gout.stride(),
                 stream)
    _raise_on("rbf_gram_vjp_points", err)
    _count_launch("rbf_gram_vjp_points", (batch, na, nb, d, str(xa.dtype)[6:]))
    key = (tuple(gout.stride()), "ab"[0 if want_a else 1:2 if want_b else 1])
    POINTS_VJP_READS[key] = POINTS_VJP_READS.get(key, 0) + 1
    return tuple(outs)


# -- autograd Functions ------------------------------------------------------------------

class RBFGram(torch.autograd.Function):
    """:func:`gram_rbf` on flat operands (B, D), (B, Na, D), (B, Nb, D),
    differentiable in the lengths and in both point sets: the backward is
    ``rbf_gram_vjp`` (lengths) and one ``rbf_gram_vjp_points`` launch for
    whichever point sets need a gradient on the card,
    :func:`gram_vjp_plain` and :func:`gram_vjp_points_pair_plain` on the
    CPU."""

    @staticmethod
    def forward(ctx, lengths, xa, xb):
        ctx.save_for_backward(lengths, xa, xb)
        if _route("rbf_gram", xa):
            return gram_cuda(lengths, xa, xb)
        return gram_plain(lengths, xa, xb)

    @staticmethod
    @once_differentiable
    def backward(ctx, gout):
        lengths, xa, xb = ctx.saved_tensors
        cuda = _route("rbf_gram_vjp", xa)
        d_len = d_xa = d_xb = None
        if ctx.needs_input_grad[0]:
            d_len = (gram_vjp_cuda if cuda else gram_vjp_plain)(lengths, xa, xb, gout)
        want_a, want_b = ctx.needs_input_grad[1:3]
        if want_a or want_b:
            points = gram_vjp_points_cuda if cuda else gram_vjp_points_pair_plain
            d_xa, d_xb = points(lengths, xa, xb, gout, want_a, want_b)
        return d_len, d_xa, d_xb


class RBFPredictMean(torch.autograd.Function):
    """:func:`predict_mean_rbf` on flat operands (B, D), (B, M, D), (B, N, D),
    (B, N, C), differentiable in the lengths and ``alpha``: the length
    cotangent is ``rbf_predict_vjp`` (:func:`predict_vjp_plain` on the CPU),
    the alpha cotangent ``K^T g`` the predict itself with the test and
    training points swapped."""

    @staticmethod
    def forward(ctx, lengths, x_test, x_train, alpha):
        ctx.save_for_backward(lengths, x_test, x_train, alpha)
        if _route("rbf_predict_mean", x_test):
            return predict_mean_cuda(lengths, x_test, x_train, alpha)
        return predict_mean_plain(lengths, x_test, x_train, alpha)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            raise NotImplementedError(
                "RBFPredictMean: the gradient with respect to the points is not "
                "implemented (nothing differentiates a predict through its points)")
        lengths, x_test, x_train, alpha = ctx.saved_tensors
        cuda = _route("rbf_predict_vjp", x_test)
        d_len = d_alpha = None
        if ctx.needs_input_grad[0]:
            vjp = predict_vjp_cuda if cuda else predict_vjp_plain
            d_len = vjp(lengths, x_test, x_train, alpha, g)
        if ctx.needs_input_grad[3]:
            mean = predict_mean_cuda if cuda else predict_mean_plain
            d_alpha = mean(lengths, x_train, x_test, g)
        return d_len, None, None, d_alpha


# -- dispatching entry points --------------------------------------------------------

def _flat_batch(*operands):
    """Broadcast the leading (batch) dims of ``(tensor, trailing_ndim)`` pairs
    and flatten them to one axis.  Returns (batch_shape, flattened tensors);
    size-1 broadcasts stay stride-0 views where the shape allows it."""
    batch = torch.broadcast_shapes(*(t.shape[: t.dim() - k] for t, k in operands))
    size = 1
    for s in batch:
        size *= s
    flat = [t.expand(batch + t.shape[t.dim() - k:]).reshape((size,) + t.shape[t.dim() - k:])
            for t, k in operands]
    return batch, flat


def _route(name: str, t) -> bool:
    """True for the CUDA kernel, False for the plain version; raises otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel and no plain path for device {t.device}")


def gram_rbf(lengths, xa, xb):
    """Unit-magnitude RBF Gram, ``(..., Na, Nb)``; see the module docstring."""
    _route("rbf_gram", xa)
    batch, (l2, a2, b2) = _flat_batch((lengths, 1), (xa, 2), (xb, 2))
    out = RBFGram.apply(l2, a2, b2)
    return out.reshape(batch + out.shape[1:])


def predict_mean_rbf(lengths, x_test, x_train, alpha):
    """Fused ``gram_rbf(lengths, x_test, x_train) @ alpha``, ``(..., M, C)``."""
    _route("rbf_predict_mean", x_test)
    batch, (l2, t2, r2, a2) = _flat_batch((lengths, 1), (x_test, 2), (x_train, 2),
                                          (alpha, 2))
    out = RBFPredictMean.apply(l2, t2, r2, a2)
    return out.reshape(batch + out.shape[1:])
