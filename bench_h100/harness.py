"""The benchmark's harness: one run of one cell.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (``bench_h100/configs/<config>.json``: the physics and point
budget) and a traffic mix (``bench_h100/traffic/<traffic>.json``: the span
of ticks, writers, the trajectory's seed, the warm-up); its limits
for ``correct`` are in ``bench_h100/limits/<cell>.json`` and each
per-layer metric is read by ``bench_h100/metrics/<metric>.py``.  All are
found by name.

The unit of work is a span: a fresh ``GPLEDriver(cfg, outdir, device)`` run
for the traffic's ticks (``run(max_ticks=span)``, the call the ``gple`` CLI
makes), which pays the initialization, the captures of its graphs, the
ticks, reoptimizations and outputs.  Every span of a cell runs the same
trajectory, so every span does the same work.  Spans run back to back for
the window; one that the window's end cuts is stopped at its next output
and not counted.  ``ticks_per_s`` is the completed spans' ticks over the
time from the window's start to the last one's end.  ``--seed`` draws the
runs of outputs the check compares.

The traced run measures one span untraced, whose wall and phase walls are
the window of the per-layer shares, then the same span traced, whose trace
gives the device's busy time, the time by kernel and the breakdown: the
trace slows the host, so its own window would count the tracer's cost as
the program's."""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from bench_h100 import check as CH
from bench_h100 import trace as TR

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level module names no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "gple_tpu")
#: the ladder's zoom counters, ``zoom.<name>`` in the program's totals
ZOOM_COUNTERS = ("solves", "iterations", "evaluations", "syncs")


class WindowClosed(Exception):
    """Raised at an output of a span that the window's end has cut."""


def process_start() -> float:
    """The process's start on the ``perf_counter`` clock (from /proc; else now)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def forbidden_modules() -> list:
    """The forbidden top-level names that ``sys.modules`` holds, compared whole."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_reader(name: str, bench: Path = BENCH):
    """The per-layer metric ``name``'s reader module, by file."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_h100_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(manifest: dict, workload: str, section: str) -> list:
    """The entries of ``section`` that the cell reports."""
    return [m for m in manifest[section] if workload in m.get("workloads", [workload])]


class Cell:
    """A workload of the manifest with its configuration, traffic and limits."""

    def __init__(self, manifest: dict, workload: str, root: Path = ROOT, bench: Path = BENCH):
        entry = next((w for w in manifest["workloads"] if w["name"] == workload), None)
        if entry is None:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        config = next(c for c in manifest["configs"] if c["name"] == entry["config"])
        self.entry = entry
        self.config = read_json(root / config["file"])
        self.traffic = read_json(bench / "traffic" / f"{entry['traffic']}.json")
        self.limits = read_json(bench / "limits" / f"{workload}.json")

    @property
    def trajectory(self) -> int:
        """The traffic's trajectory: its seed of the program's random stream."""
        return int(self.traffic["trajectory_seed"])

    def gple_config(self, seed: int):
        """The configuration with the traffic's overrides and trajectory ``seed``."""
        from gple_tpu_torch.config import GPLEConfig

        fields = dict(self.config["gple"], **self.traffic.get("overrides", {}))
        fields["seed"] = int(seed)
        return GPLEConfig(**fields)


class Recorder:
    """The span's callback: at each output, the state the driver holds
    (:class:`check.Snap`, with the stages of the ladder that chose its
    parameters); past the deadline it stops the span.  The record of tick 0,
    which the driver makes after its initialization and passes to no
    callback, is kept too."""

    def __init__(self, drv, deadline: float):
        self.drv, self.deadline, self.snaps = drv, deadline, []
        observe = drv.observe

        def observe_first(tick, opt_type):
            rec = observe(tick, opt_type)
            if tick == 0 and not self.snaps:
                self.keep(rec, fused=False)
            return rec
        drv.observe = observe_first

    def __call__(self, rec):
        self.keep(rec, fused=sys._getframe(1).f_code.co_name == "_advance_fused")
        if time.perf_counter() > self.deadline:
            raise WindowClosed

    def keep(self, rec, fused: bool):
        d, o = self.drv, self.drv.optimizer
        self.snaps.append(CH.Snap(
            tick=int(round(rec.time / d.cfg.dt)), fused=fused, density=d.density,
            extra=d.extra,
            params=(np.array(o.diag_lengths, dtype=np.float64),
                    np.array(o.diag_magnitudes, dtype=np.float64),
                    np.array(o.off_params, dtype=np.float64), float(o.off_magnitude)),
            div=float(d._coh_div_eff), record=rec, stages=ladder_stages(o)))


def ladder_stages(o) -> tuple:
    """The stages of the optimizer's last ladder (none for the moment
    optimizer): tag, error, averages, multipliers, lengths, coherence
    parameters, the 5% rule's checks, and whether the optimizer took the
    stage's parameters."""
    return tuple(dict(tag=st["tag"], error=st["error"], averages=st["averages"],
                      lam=st["lam"], diag_lengths=st["diag_lengths"],
                      off_params=st["off_params"], check=st["check"],
                      accepted=st["diag_lengths"] is o.diag_lengths)
                 for st in getattr(o, "stages", ()))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _dir_bytes(path) -> int:
    return sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file())


def run_span(cell: Cell, cfg, device, deadline: float, outroot: Path, index: int):
    """One span; returns a dict of its results, or None if the window cut it."""
    from gple_tpu_torch.driver import GPLEDriver

    outdir = str(outroot / f"span{index}") if cell.traffic.get("writers") else None
    drv = GPLEDriver(cfg, outdir=outdir, device=device)
    rec = Recorder(drv, deadline)
    try:
        drv.run(max_ticks=cell.traffic["span_ticks"], callback=rec)
        _sync(device)
    except WindowClosed:
        if drv.writers:
            drv.writers.close()
        return None
    out = dict(cfg=cfg, ticks=int(round(drv.history[-1].time / cfg.dt)),
               phase_times=dict(drv.phase_times), snaps=rec.snaps,
               events=set(int(t) for t in drv._event_ticks), stats=dict(drv.stats),
               outdir=outdir, stage_s=drv.totals.seconds("stage"),
               zoom={k: drv.totals.count("zoom." + k) for k in ZOOM_COUNTERS})
    # the span frees its driver (graphs, pools) itself, so that no span pays
    # for another's at a point the collector picks
    del drv, rec
    gc.collect()
    _sync(device)
    out["end"] = time.perf_counter()
    return out if out["end"] <= deadline else None


def run_window(run_one, seconds: float):
    """Spans back to back from now for ``seconds``: ``run_one(deadline,
    index)`` returns a completed span (a dict with its ``end`` on the
    ``perf_counter`` clock and its ``ticks``) or None for one the window's
    end cut, which ends the window.  Only the last completed span keeps its
    output directory.  Returns (the window's start, the completed spans)."""
    t0 = time.perf_counter()
    deadline = t0 + seconds
    spans = []
    while time.perf_counter() < deadline:
        span = run_one(deadline, len(spans))
        if span is None:
            break
        if spans and spans[-1].get("outdir"):
            shutil.rmtree(spans[-1]["outdir"], ignore_errors=True)
        spans.append(span)
    return t0, spans


def rate(spans, t0: float) -> float:
    """``ticks_per_s``: the completed spans' ticks over the time from the
    window's start to the last one's end."""
    return sum(s["ticks"] for s in spans) / (spans[-1]["end"] - t0)


def warm_up(cell: Cell, device, outroot: Path) -> None:
    """The start of the cell's trajectory: loads the kernels and warms
    cuBLAS, cuSOLVER and the caching allocator at the cell's own shapes."""
    from gple_tpu_torch.driver import GPLEDriver

    cfg = cell.gple_config(cell.trajectory)
    outdir = str(outroot / "warm") if cell.traffic.get("writers") else None
    GPLEDriver(cfg, outdir=outdir, device=device).run(max_ticks=cell.traffic["warm_ticks"])
    _sync(device)
    if outdir:
        shutil.rmtree(outdir, ignore_errors=True)
    gc.collect()


def run_cell(manifest: dict, workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float | None = None, root: Path = ROOT,
             bench: Path = BENCH, log=print):
    """One run of a cell: set-up, the window, the check.  Returns the result
    line's dict (with ``checks`` last) or raises."""
    from gple_tpu_torch.ops import _build
    from gple_tpu_torch.ops import gram_kernels as GK

    t_start = time.perf_counter() if t_start is None else t_start
    marks = [("start", time.perf_counter() - t_start)]
    cell = Cell(manifest, workload, root, bench)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.init()
        marks.append(("cuda", time.perf_counter() - t_start))
        _build.library()
        marks.append(("kernels", time.perf_counter() - t_start))
    outroot = Path(tempfile.mkdtemp(prefix="bench_h100_", dir=tempfile.gettempdir()))
    try:
        warm_up(cell, device, outroot)
        marks.append(("warm", time.perf_counter() - t_start))
        cfg = cell.gple_config(cell.trajectory)
        found = forbidden_modules()
        if found:
            raise RuntimeError(f"forbidden modules loaded after set-up: {found}")
        setup_s = time.perf_counter() - t_start
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        GK.reset_launches()
        traced_s = None
        if trace:
            # the span untraced is the window; the same span traced (the
            # driver is deterministic) gives the device's side of it
            t0 = time.perf_counter()
            spans = [run_span(cell, cfg, device, float("inf"), outroot, 0)]
            tracer = TR.Tracer(cuda)
            GK.reset_launches()
            tracer.start()
            t1 = time.perf_counter()
            last = run_span(cell, cfg, device, float("inf"), outroot, 1)
            traced_s = last["end"] - t1
            tracer.stop()
            launches = dict(GK.LAUNCHES_BY_SHAPE)
        else:
            tracer, launches = None, {}
            t0, spans = run_window(
                lambda deadline, i: run_span(cell, cfg, device, deadline, outroot, i), seconds)
            last = spans[-1] if spans else None
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        found = forbidden_modules()
        if found:
            raise RuntimeError(f"forbidden modules loaded after the window: {found}")
        if not spans:
            raise RuntimeError(f"no span completed in {seconds} s; lengthen --seconds")
        window_s = spans[-1]["end"] - t0
        ticks = sum(s["ticks"] for s in spans)
        phase = {k: sum(s["phase_times"][k] for s in spans) for k in spans[0]["phase_times"]}
        if last["outdir"]:
            last["bytes"] = _dir_bytes(last["outdir"])
        for s in spans:
            if s is not last:
                s["snaps"] = None
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        outcome = CH.evaluate(cfg, last["snaps"], last["events"], seed, device,
                              outdir=last["outdir"])
        correct, checks = CH.verdict(outcome, cell.limits)
        marks.append(("check_s", time.perf_counter() - t_check))
        t_reduce = time.perf_counter()
        ctx = dict(cfg=cfg, traffic=cell.traffic, window_s=window_s, ticks=ticks,
                   spans=len(spans), phase_times=phase, launches=launches,
                   stage_s=sum(s["stage_s"] for s in spans),
                   zoom={k: sum(s["zoom"][k] for s in spans) for k in ZOOM_COUNTERS},
                   trace=TR.reduce(tracer) if tracer else None)
        marks.append(("trace_reduce_s", time.perf_counter() - t_reduce))
        section = "per_layer" if trace else "end_to_end"
        metrics = {}
        for m in metrics_for(manifest, workload, section):
            if m["name"] == "ticks_per_s":
                value = rate(spans, t0)
            elif m["name"] == "setup_s":
                value = setup_s
            else:
                value = load_reader(m["name"], bench).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        dev = dict(platform="gpu" if cuda else "cpu",
                   kind=torch.cuda.get_device_name(0) if cuda else "cpu",
                   count=1, memory_peak_bytes=int(peak))
        result = dict(correct=bool(correct), attempted=len(spans) + (traced_s is not None),
                      failed=0, metrics=metrics, device=dev)
        if ctx["trace"]:
            dev.update(busy_s=ctx["trace"]["busy_s"], window_s=ctx["trace"]["window_s"])
            result["breakdown"] = ctx["trace"]["breakdown"]
        result["checks"] = checks
        log(json.dumps(dict(
            workload=workload, seed=seed, trajectory=cfg.seed, spans=len(spans),
            ticks=ticks, window_s=window_s, traced_span_s=traced_s,
            span_walls=[s["end"] - (spans[i - 1]["end"] if i else t0)
                        for i, s in enumerate(spans)],
            phase_times=phase, stats=last["stats"], events=sorted(last["events"]),
            bytes_per_span=last.get("bytes"), notes=outcome.notes, marks=marks,
            trace_clock=ctx["trace"]["clock"] if ctx["trace"] else None,
            trace_seconds=ctx["trace"]["seconds"] if ctx["trace"] else None,
            device_ops=ctx["trace"]["device_ops"] if ctx["trace"] else None,
            power=power_limit() if cuda else None)))
        return result
    finally:
        shutil.rmtree(outroot, ignore_errors=True)


def power_limit() -> str:
    """The card's name, power limit, SM clock and temperature, as
    ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
                               "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"
