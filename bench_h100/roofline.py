"""A kernel's share of its roofline over the traced window: the sum over the
shapes it was launched at of launches times that shape's least time
(``arith.KERNELS``), over the kernel's device time in the trace."""

from bench_h100 import arith
from bench_h100 import trace


def share(ctx, kernel: str):
    tr = ctx["trace"]
    if tr is None:
        return None
    symbols, bound = arith.KERNELS[kernel]
    device_s = trace.kernel_seconds(tr["kernel_s"], symbols)
    least_ms = sum(n * bound(shape)[0] for (name, shape), n in ctx["launches"].items()
                   if name == kernel)
    if device_s <= 0.0 or least_ms <= 0.0:
        return None
    return 100.0 * least_ms / 1e3 / device_s
