"""Captured CUDA graphs: one host launch for a whole function of device state.

The JAX package runs a tick, a chunk of ticks and a whole trajectory segment
each as one compiled program (``_tick_fused``, ``_ticks_scan``,
``_ticks_scan_fused``, ``gple_tpu/driver.py:167-513``).  Run eagerly on an
H100, the same tick at N = 1024 is ~11,000 host launches of small kernels,
and the host's launch overhead, not the device, sets the pace.  A :class:`Graph` captures a
function once into a ``torch.cuda.CUDAGraph`` and replays it: one host
launch runs every kernel of the function, the port's own PyTorch ops and its
hand-written kernels unchanged (no ``torch.compile``).

The captured function ``fn()`` takes no arguments: it reads and writes only
the tensors of its static state, in place (its results are copied into the
state inside the graph).  It draws no random numbers (a capture would freeze
the draw: the caller makes them beforehand, into the state) and makes no
host pull, host-to-device copy or host branch on device values.  The caller
copies the driver's tensors into the state before a replay and clones the
results out after it, so no driver tensor ever aliases a graph's buffer.

On the CPU a :class:`Graph` runs ``fn()`` eagerly at every call: the same
Python function serves both routes.  On a CUDA device the first call
captures, and a capture that fails raises: there is no eager fallback.

A graph runs under ``torch.inference_mode``, or, made with
``autograd=True``, in grad mode: its function may then differentiate
(``torch.autograd.grad``), and the capture holds the forward and the
backward kernels both.  The zoom line search's loss and gradient are such
graphs (``gp/opt.py``'s ``ZoomGraph``).

Launch counts: a kernel launched while capturing runs nothing, so the
capture's counts are taken back out of ``gram_kernels.LAUNCHES`` (and
``LAUNCHES_BY_SHAPE``) and every replay adds them again (:attr:`launches`).

Spans (:mod:`gple_tpu_torch.utils.spans`): each capture is a ``capture``
span and each replay a ``launch`` span, both with the graph's ``kind``
(``tick``, ``period_end``, ``walk``, ``zoom``); their calls count the
captures and replays.  The CPU's eager runs make no span.
"""

from __future__ import annotations

import contextlib

import torch

from gple_tpu_torch.ops import gram_kernels as GK
from gple_tpu_torch.utils import spans


def leaves(tree) -> list:
    """The tensors of a nest of tuples, NamedTuples, lists and dicts, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [t for sub in tree for t in leaves(sub)]
    return []


def clone(tree):
    """``tree`` with every tensor cloned, the nesting and its types kept."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(clone(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(clone(v) for v in tree)
    return tree


def _pairs(dst, src):
    if isinstance(dst, torch.Tensor):
        if not isinstance(src, torch.Tensor) or src.shape != dst.shape:
            raise ValueError(f"copy_: a tensor of shape {tuple(dst.shape)} cannot take "
                             f"{getattr(src, 'shape', type(src).__name__)}")
        yield dst, src
    elif isinstance(dst, dict):
        for k in dst:
            yield from _pairs(dst[k], src[k])
    elif isinstance(dst, (tuple, list)):
        if len(dst) != len(src):
            raise ValueError("copy_: the two trees differ in structure")
        for d, s in zip(dst, src):
            yield from _pairs(d, s)


def copy_(dst, src) -> None:
    """Copy every tensor of ``src`` into the tensor at the same place in
    ``dst``, in place (the shapes must agree).  A source that is also another
    pair's destination is cloned first, so no copy reads a tensor an earlier
    copy wrote."""
    pairs = [(d, s) for d, s in _pairs(dst, src) if d is not s]
    written = {id(d) for d, _ in pairs}
    for d, s in [(d, s.clone() if id(s) in written else s) for d, s in pairs]:
        d.copy_(s)


def _mode(autograd: bool):
    """Grad mode outside any inference mode, or ``torch.inference_mode``."""
    if not autograd:
        return torch.inference_mode()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.inference_mode(False))
    stack.enter_context(torch.enable_grad())
    return stack


class Graph:
    """``fn()`` over the static tensors ``state``: run eagerly on the CPU, and
    on a CUDA device captured into one CUDA graph at the first call (or at
    :meth:`capture`) and replayed at every call.  ``kind`` names the graph
    in its spans; ``autograd`` runs ``fn`` in grad mode (module docstring).

    The capture first runs ``fn`` once on a side stream (cuBLAS, cuSOLVER,
    autograd and the caching allocator set themselves up outside the
    capture), puts ``state`` back bit for bit, then captures under the
    graph's mode.  After it, :attr:`pool_bytes` is the device memory the
    graph's private pool reserved, and :attr:`launches` the kernel launches
    of one replay by (kernel, shape)."""

    def __init__(self, fn, state, kind: str, autograd: bool = False):
        self.fn = fn
        self.state = leaves(state)
        self.kind = kind
        self.autograd = autograd
        self.graph = None
        self.launches: dict = {}
        self.pool_bytes = 0

    @property
    def device(self) -> torch.device:
        return self.state[0].device

    def __call__(self) -> None:
        if self.device.type != "cuda":
            with _mode(self.autograd):
                self.fn()
            return
        self.capture()
        with spans.span("launch", kind=self.kind):
            self.graph.replay()
            GK.count_launches(self.launches)

    def capture(self) -> None:
        """Capture now, if this is a CUDA graph not captured yet."""
        if self.graph is not None or self.device.type != "cuda":
            return
        with spans.span("capture", kind=self.kind):
            self._capture()

    def _capture(self) -> None:
        dev = self.device
        with _mode(self.autograd):
            saved = [t.clone() for t in self.state]
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self.fn()
            torch.cuda.current_stream(dev).wait_stream(side)
            for t, s in zip(self.state, saved):
                t.copy_(s)
            del saved
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            before = dict(GK.LAUNCHES_BY_SHAPE)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self.fn()
            self.launches = {k: v - before.get(k, 0) for k, v in GK.LAUNCHES_BY_SHAPE.items()
                             if v != before.get(k, 0)}
            GK.count_launches(self.launches, -1)
            torch.cuda.synchronize(dev)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.graph = graph
