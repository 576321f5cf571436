"""RBF Gram and fused predict-mean: CUDA kernels, their plain versions and gradients.

Counterpart of :mod:`gple_tpu.ops.pallas_gram`.  Each of the two Pallas TPU
kernels there has a hand-written CUDA kernel here (sources in
``gple_tpu_torch/csrc/``), a plain PyTorch version of the same function, and
a dispatching entry point:

* :func:`gram_rbf` -- ``exp(-1/2 |(xa_i - xb_j) / l|^2)``, batched over length
  sets (replaces ``gram_pallas``);
* :func:`predict_mean_rbf` -- ``gram @ alpha`` without materialising the
  cross-kernel (replaces ``predict_mean_pallas``).

Both entry points are differentiable in the lengths (and the predict in
``alpha``) through the autograd Functions :class:`RBFGram` and
:class:`RBFPredictMean`.  Their backward is two more hand-written kernels
(``csrc/rbf_vjp.cu``), each beside its plain version: ``rbf_gram_vjp`` (the
length cotangent of a Gram from its dense cotangent) and ``rbf_predict_vjp``
(the length cotangent of a predict mean, whose weight ``g alpha^T`` has rank
C); the ``alpha`` cotangent of a predict is ``rbf_predict_mean`` with the test
and training points swapped.  A gradient with respect to the points raises
(the full-ARD matrix lengths of validation need it, ROADMAP Queue A item 12).

Dispatch is by the device of the tensors alone, forward and backward: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel (or the
launch raises), and any other device raises.  There is no fallback from the
kernel to the plain version.  The raw launchers (``*_cuda``) refuse a tensor
that requires grad while grad mode is on: the only way to differentiate
through a kernel is its Function.  Every kernel launch adds one to
:data:`LAUNCHES` and to its shape's entry in :data:`LAUNCHES_BY_SHAPE`, so a
run can show that its path went through the kernels, and at which shapes.

The entry points take batched operands whose leading dimensions broadcast:
``lengths (..., D)``, ``xa (..., Na, D)``, ``xb (..., Nb, D)``, ``alpha
(..., N, C)``.  The kernels read their inputs through strides, so a point set
broadcast over several length sets is never copied.
"""

from __future__ import annotations

import functools

import torch
from torch.autograd.function import once_differentiable

#: kernel launches since the last reset, by kernel name
LAUNCHES = {"rbf_gram": 0, "rbf_predict_mean": 0, "rbf_gram_vjp": 0, "rbf_predict_vjp": 0}
#: the same launches by (kernel name, shape): ``rbf_gram`` and ``rbf_gram_vjp``
#: shapes are (B, Na, Nb, D, dtype), ``rbf_predict_mean`` and
#: ``rbf_predict_vjp`` shapes (B, M, N, C, D, dtype)
LAUNCHES_BY_SHAPE: dict = {}

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
#: columns and rows of one block of the VJP kernels (``kThreads``, ``kRowTile``
#: in csrc/rbf_vjp.cu)
VJP_COLS_PER_BLOCK = 128
VJP_ROWS_PER_BLOCK = 32
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


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCHES_BY_SHAPE.clear()


def _count_launch(name: str, shape: tuple) -> None:
    LAUNCHES[name] += 1
    key = (name, shape)
    LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + 1


# -- plain PyTorch versions (the CPU path and the on-card reference) -------------

def gram_plain(lengths, xa, xb):
    """Broadcast-difference RBF Gram, the formula of ``gple_tpu.ops.kernels.gram``."""
    za = xa / lengths[..., None, :]
    zb = xb / lengths[..., None, :]
    d2 = torch.sum((za[..., :, None, :] - zb[..., None, :, :]) ** 2, dim=-1)
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


def vjp_partials(na: int, nb: int) -> int:
    """Blocks (and partial sums per (b, d)) of a VJP launch over (Na, Nb) pairs."""
    return _cdiv(nb, VJP_COLS_PER_BLOCK) * _cdiv(na, VJP_ROWS_PER_BLOCK)


def _vjp_range(name: str, batch: int, na: int, nb: int, d: int, c: int = 1):
    """Raise ValueError where a VJP shape is outside the kernel or its grid."""
    if (not 1 <= d <= MAX_DIM or not 1 <= c <= MAX_RHS or batch > _MAX_GRID_YZ
            or max(na, nb) > _MAX_INT or _cdiv(na, VJP_ROWS_PER_BLOCK) > _MAX_GRID_YZ):
        raise ValueError(f"{name}: D={d}, C={c}, B={batch}, Na={na}, Nb={nb} outside the "
                         "kernel's range")


def gram_vjp_cuda(lengths, xa, xb, gout):
    """Launch ``rbf_gram_vjp`` on (B, D), (B, Na, D), (B, Nb, D) CUDA tensors and
    the Gram's cotangent (B, Na, Nb), read through its strides; returns a new
    contiguous (B, D) length cotangent.  The blocks' partial sums go to a
    scratch tensor (B, :func:`vjp_partials`, D) allocated here."""
    _check_cuda("rbf_gram_vjp", lengths, xa, xb, gout)
    batch, na, d = xa.shape
    nb = xb.shape[1]
    if (xb.shape != (batch, nb, d) or lengths.shape != (batch, d)
            or gout.shape != (batch, na, nb)):
        raise ValueError(f"rbf_gram_vjp: shapes {tuple(lengths.shape)}, {tuple(xa.shape)}, "
                         f"{tuple(xb.shape)}, {tuple(gout.shape)} do not form (B, D), "
                         "(B, Na, D), (B, Nb, D), (B, Na, Nb)")
    _vjp_range("rbf_gram_vjp", batch, na, nb, d)
    fn = _launcher("rbf_gram_vjp", xa.dtype)
    dev = xa.device
    with torch.cuda.device(dev):
        if batch * na * nb == 0:
            return torch.zeros((batch, d), dtype=xa.dtype, device=dev)
        out = torch.empty((batch, d), dtype=xa.dtype, device=dev)
        scratch = torch.empty((batch, vjp_partials(na, nb), d), dtype=xa.dtype, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(xa.data_ptr(), xb.data_ptr(), lengths.data_ptr(), gout.data_ptr(),
                 out.data_ptr(), scratch.data_ptr(), batch, na, nb, d, *xa.stride(),
                 *xb.stride(), *lengths.stride(), *gout.stride(), stream)
    _raise_on("rbf_gram_vjp", err)
    _count_launch("rbf_gram_vjp", (batch, na, nb, d, str(xa.dtype)[6:]))
    return out


def predict_vjp_cuda(lengths, x_test, x_train, alpha, g):
    """Launch ``rbf_predict_vjp`` on (B, D), (B, M, D), (B, N, D), (B, N, C) CUDA
    tensors and the output's cotangent g (B, M, C); returns a new contiguous
    (B, D) length cotangent (scratch as :func:`gram_vjp_cuda`)."""
    _check_cuda("rbf_predict_vjp", lengths, x_test, x_train, alpha, g)
    batch, m, d = x_test.shape
    n, c = x_train.shape[1], alpha.shape[-1]
    if (x_train.shape != (batch, n, d) or lengths.shape != (batch, d)
            or alpha.shape != (batch, n, c) or g.shape != (batch, m, c)):
        raise ValueError(
            f"rbf_predict_vjp: shapes {tuple(lengths.shape)}, {tuple(x_test.shape)}, "
            f"{tuple(x_train.shape)}, {tuple(alpha.shape)}, {tuple(g.shape)} do not form "
            "(B, D), (B, M, D), (B, N, D), (B, N, C), (B, M, C)")
    _vjp_range("rbf_predict_vjp", batch, m, n, d, c)
    fn = _launcher("rbf_predict_vjp", x_test.dtype)
    dev = x_test.device
    with torch.cuda.device(dev):
        if batch * m * n == 0:
            return torch.zeros((batch, d), dtype=x_test.dtype, device=dev)
        out = torch.empty((batch, d), dtype=x_test.dtype, device=dev)
        scratch = torch.empty((batch, vjp_partials(m, n), d), dtype=x_test.dtype, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x_test.data_ptr(), x_train.data_ptr(), lengths.data_ptr(), g.data_ptr(),
                 alpha.data_ptr(), out.data_ptr(), scratch.data_ptr(), batch, m, n, d, c,
                 *x_test.stride(), *x_train.stride(), *lengths.stride(), *g.stride(),
                 *alpha.stride(), stream)
    _raise_on("rbf_predict_vjp", err)
    _count_launch("rbf_predict_vjp", (batch, m, n, c, d, str(x_test.dtype)[6:]))
    return out


# -- autograd Functions ------------------------------------------------------------------

def _refuse_points_grad(name: str, needs_input_grad, points: tuple):
    if any(needs_input_grad[i] for i in points):
        raise NotImplementedError(
            f"{name}: the gradient with respect to the points is not implemented (the "
            "full-ARD matrix lengths of validation need it, ROADMAP Queue A item 12)")


class RBFGram(torch.autograd.Function):
    """:func:`gram_rbf` on flat operands (B, D), (B, Na, D), (B, Nb, D),
    differentiable in the lengths: the backward is ``rbf_gram_vjp`` on the
    card and :func:`gram_vjp_plain` on the CPU."""

    @staticmethod
    def forward(ctx, lengths, xa, xb):
        ctx.save_for_backward(lengths, xa, xb)
        if _route("rbf_gram", xa):
            return gram_cuda(lengths, xa, xb)
        return gram_plain(lengths, xa, xb)

    @staticmethod
    @once_differentiable
    def backward(ctx, gout):
        _refuse_points_grad("RBFGram", ctx.needs_input_grad, (1, 2))
        if not ctx.needs_input_grad[0]:
            return None, None, None
        lengths, xa, xb = ctx.saved_tensors
        vjp = gram_vjp_cuda if _route("rbf_gram_vjp", xa) else gram_vjp_plain
        return vjp(lengths, xa, xb, gout), None, None


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
        _refuse_points_grad("RBFPredictMean", ctx.needs_input_grad, (1, 2))
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
