"""The traced window: a ``torch.profiler`` trace of the device's activity
(CUDA only: kernels, copies, fills) and a sampler of what the host's main
thread is doing, reduced to the device's busy time, the device time of each
operation by name, and the idle gaps named by the host's activity."""

from __future__ import annotations

import collections
import os
import sys
import threading
import time

import torch

#: the host sampler's period: at 2 ms it took 3.3 s of a traced 300-tick
#: band span, holding the interpreter's lock from the main thread
SAMPLE_S = 0.02
#: where a host sample's name is taken from, innermost first
PACKAGES = ("gple_tpu_torch", "bench_h100")


def _frame_name(frame) -> str:
    """``module.function`` of the innermost frame of the program (or else of
    the harness) on the stack."""
    fallback = None
    while frame is not None:
        path = frame.f_code.co_filename
        for pkg in PACKAGES:
            at = path.rfind(os.sep + pkg + os.sep)
            if at >= 0:
                mod = os.path.splitext(os.path.basename(path))[0]
                name = f"{mod}.{frame.f_code.co_name}"
                if pkg == PACKAGES[0]:
                    return name
                fallback = fallback or name
        frame = frame.f_back
    return fallback or "other"


class HostSampler:
    """Samples the main thread's stack every :data:`SAMPLE_S` seconds."""

    def __init__(self):
        self.samples = []          # (perf_counter_ns, name)
        self._stop = threading.Event()
        self._main = threading.main_thread().ident
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _loop(self):
        while not self._stop.wait(SAMPLE_S):
            frame = sys._current_frames().get(self._main)
            self.samples.append((time.perf_counter_ns(), _frame_name(frame)))

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join()


class Tracer:
    """The profiler and the host sampler around the measured window."""

    def __init__(self, cuda: bool = True):
        # the card's activity; a CPU run (a rehearsal) traces the host's ops
        act = torch.profiler.ProfilerActivity
        self.prof = torch.profiler.profile(activities=[act.CUDA if cuda else act.CPU])
        self.sampler = HostSampler()

    def start(self):
        self.prof.start()
        self.sampler.start()
        self.clocks0 = _clocks()

    def stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.clocks1 = _clocks()
        self.sampler.stop()
        t = time.perf_counter()
        self.prof.stop()
        self.stop_s = time.perf_counter() - t


def _clocks():
    return dict(perf=time.perf_counter_ns(), real=time.time_ns(), mono=time.monotonic_ns())


def _union(intervals) -> float:
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or b > end:
            total += b - (a if end is None else max(a, end))
            end = b
    return total


def _gaps(intervals, lo: int, hi: int):
    """The (start, end) gaps in [lo, hi] that no interval covers."""
    gaps, at = [], lo
    for a, b in sorted(intervals):
        if a > at:
            gaps.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        gaps.append((at, hi))
    return [(a, b) for a, b in gaps if b > a]


def reduce(tracer: Tracer, top: int = 10) -> dict:
    """busy_s, window_s (the traced window), device seconds by name, and the
    breakdown: the ``top`` device operations and the idle gaps' seconds by the
    host's activity."""
    t0 = time.perf_counter()
    events = tracer.prof.profiler.kineto_results.events()
    t1 = time.perf_counter()
    cpu = torch.autograd.DeviceType.CPU
    device = [(e.start_ns(), e.end_ns(), e.name()) for e in events if e.device_type() != cpu]
    t2 = time.perf_counter()
    c0, c1 = tracer.clocks0, tracer.clocks1
    window_ns = c1["perf"] - c0["perf"]
    # the trace's clock: the host clock whose window holds the device events
    lo_ev = min((a for a, _, _ in device), default=0)
    hi_ev = max((b for _, b, _ in device), default=0)
    clock = next((k for k in ("real", "mono", "perf")
                  if c0[k] - 1e8 <= lo_ev and hi_ev <= c1[k] + 1e8), None)
    lo = c0[clock] if clock else lo_ev
    hi = lo + window_ns
    intervals = [(max(a, lo), min(b, hi)) for a, b, _ in device if b > lo and a < hi]
    busy_ns = _union(intervals)
    by_name = collections.Counter()
    for a, b, name in device:
        by_name[name] += (b - a) / 1e9
    # idle gaps, each named by the host activity sampled most inside it
    shift = lo - c0["perf"]
    samples = [(t + shift, name) for t, name in tracer.sampler.samples]
    idle = collections.Counter()
    j = 0
    for a, b in _gaps(intervals, lo, hi):
        while j < len(samples) and samples[j][0] < a:
            j += 1
        k, inside = j, collections.Counter()
        while k < len(samples) and samples[k][0] <= b:
            inside[samples[k][1]] += 1
            k += 1
        if inside:
            name = inside.most_common(1)[0][0]
        elif samples:
            name = samples[min(j, len(samples) - 1)][1]
        else:
            name = "unsampled"
        idle[name] += (b - a) / 1e9
    return dict(
        busy_s=busy_ns / 1e9, window_s=window_ns / 1e9, clock=clock or "device",
        seconds=dict(stop=tracer.stop_s, events=t1 - t0, scan=t2 - t1,
                     reduce=time.perf_counter() - t2),
        device_ops=len(device), kernel_s=dict(by_name),
        breakdown=dict(device_ops=[[n[:160], s] for n, s in by_name.most_common(top)],
                       idle_gaps=[[n, s] for n, s in idle.most_common(top)]))


def kernel_seconds(kernel_s: dict, symbols) -> float:
    """Device seconds of the operations whose names hold one of ``symbols``."""
    return sum(s for name, s in kernel_s.items() if any(sym in name for sym in symbols))
