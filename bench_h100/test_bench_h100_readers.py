"""The per-layer readers on synthetic phase walls and traces, the span rule
of ``ticks_per_s``, the trace reduction, and the frozen arithmetic.  CPU
only."""

import time
from types import SimpleNamespace

import pytest
import torch

from bench_h100 import arith
from bench_h100 import harness as H
from bench_h100 import trace as TR


def _ctx(**kw):
    phase = dict(init=2.0, seed=1.0, evolve=0.0, optimize=3.0, output=4.0, opt_reselect=0.5,
                 opt_tune=0.0, opt_fit=0.0, fused=5.0, fused_abort=6.0)
    cfg = SimpleNamespace(num_points=1024, num_extra_points=5120, reopt_freq=10,
                          initial_population=(1.0, 0.0))
    ctx = dict(cfg=cfg, window_s=40.0, ticks=600, phase_times=phase, trace=None, launches={})
    ctx.update(kw)
    return ctx


@pytest.mark.parametrize("name,want", [("init_pct", 5.0), ("abort_pct", 15.0),
                                       ("walk_pct", 3.75), ("reopt_pct", 7.5),
                                       ("output_pct", 10.0)])
def test_phase_readers(name, want):
    assert H.load_reader(name).read(_ctx()) == pytest.approx(want)


def test_tick_mfu_reader():
    flops = arith.tick_flops(1024, 5120, (True, False, False), 10)
    got = H.load_reader("tick_mfu").read(_ctx())
    assert got == pytest.approx(100 * flops * 600 / (40.0 * 67e12))


def test_trace_readers():
    trace = dict(busy_s=30.0, window_s=45.0, kernel_s={
        "void rbf_gram_kernel<double, 4>(...)": 2e-3,
        "void rbf_predict_partial_kernel<double>(...)": 3e-3,
        "void rbf_predict_reduce_kernel<double>(...)": 1e-3, "gemm": 1.0})
    launches = {("rbf_gram", (5, 1024, 1024, 2, "float64")): 100,
                ("rbf_predict_mean", (2, 10240, 1024, 1, 2, "float64")): 50}
    ctx = _ctx(trace=trace, launches=launches)
    # idle against the untraced window (40 s), not the traced one (45 s)
    assert H.load_reader("device_idle_pct").read(ctx) == pytest.approx(25.0)
    gram_ms = arith.gram_bound(5, 1024, 1024, 2)[0]
    assert H.load_reader("rbf_gram_roofline").read(ctx) == pytest.approx(
        100 * 100 * gram_ms / 1e3 / 2e-3)
    pred_ms = arith.predict_bound(2, 10240, 1024, 1, 2)[0]
    assert H.load_reader("rbf_predict_roofline").read(ctx) == pytest.approx(
        100 * 50 * pred_ms / 1e3 / 4e-3)


def test_vjp_roofline_readers():
    trace = dict(busy_s=30.0, window_s=45.0, kernel_s={
        "void rbf_vjp_kernel<double, 2, 0, true>(double const*, double const*)": 2e-3,
        "void rbf_vjp_kernel<double, 2, 1, false>(double const*, double const*)": 6e-3,
        "void rbf_gram_kernel<double, 4>(...)": 1.0})
    launches = {("rbf_gram_vjp", (2, 1024, 1024, 2, "float64")): 200,
                ("rbf_predict_vjp", (2, 5120, 1024, 1, 2, "float64")): 100,
                ("rbf_gram", (2, 1024, 1024, 2, "float64")): 7}
    ctx = _ctx(trace=trace, launches=launches)
    gram_ms = arith.gram_vjp_bound(2, 1024, 1024, 2)[0]
    assert H.load_reader("rbf_gram_vjp_roofline").read(ctx) == pytest.approx(
        100 * 200 * gram_ms / 1e3 / 2e-3)
    pred_ms = arith.predict_vjp_bound(2, 5120, 1024, 1, 2)[0]
    assert H.load_reader("rbf_predict_vjp_roofline").read(ctx) == pytest.approx(
        100 * 100 * pred_ms / 1e3 / 6e-3)
    for name in ("rbf_gram_vjp_roofline", "rbf_predict_vjp_roofline"):
        assert H.load_reader(name).read(_ctx()) is None
        assert H.load_reader(name).read(_ctx(trace=trace, launches={})) is None


@pytest.mark.parametrize("name,want", [("ladder_eval_ms", 1e3 * 6.0 / 300),
                                       ("zoom_syncs_per_iter", 297 / 100)])
def test_ladder_readers(name, want):
    zoom = dict(solves=10, iterations=100, evaluations=300, syncs=297)
    assert H.load_reader(name).read(_ctx(stage_s=6.0, zoom=zoom)) == pytest.approx(want)
    # no ladder ran: nothing to read
    none = dict(solves=0, iterations=0, evaluations=0, syncs=0)
    assert H.load_reader(name).read(_ctx(stage_s=0.0, zoom=none)) is None


def test_ladder_mfu_reader():
    zoom = dict(solves=10, iterations=100, evaluations=300, syncs=297)
    flops = (arith.cutoff_tick_flops(1024, 5120, (True, False, False), 10) * 600
             + arith.ladder_eval_flops(1024, 5120, (True, False, False)) * 300)
    got = H.load_reader("ladder_mfu").read(_ctx(stage_s=6.0, zoom=zoom))
    assert got == pytest.approx(100 * flops / (40.0 * 67e12))
    none = dict(solves=0, iterations=0, evaluations=0, syncs=0)
    assert H.load_reader("ladder_mfu").read(_ctx(stage_s=0.0, zoom=none)) is None


def test_cutoff_tick_and_ladder_flops_at_n1024():
    n, ne = 1024, 5120
    e0, e1 = 4 * 2 + 2, 4 * 2 + 2 + 2
    var = lambda m: m * n * e1 + 2.0 * m * n * n + 2.0 * m * n
    fit = n * n * e0 + n ** 3 + 10.0 * n * n
    obs = n * n * e0 + 2.0 * n * n + 10.0 * n
    tick = var(9 * n) + var(9 * ne) + 2 * var(9 * n) + fit + obs + (fit + var(ne) + obs) / 10
    assert arith.cutoff_tick_flops(n, ne, (True, False, False), 10) == pytest.approx(tick)
    forward = fit + 2.0 * n + ne * n * e1 + obs
    assert arith.ladder_eval_flops(n, ne, (True, False, False)) == pytest.approx(3 * forward)
    # the cutoff evolve's variance outweighs the raw means' tick four times over
    assert tick > 3.5 * arith.tick_flops(n, ne, (True, False, False), 10)


def test_trace_readers_find_nothing_untraced():
    for name in ("device_idle_pct", "rbf_gram_roofline", "rbf_predict_roofline"):
        assert H.load_reader(name).read(_ctx()) is None
    ctx = _ctx(trace=dict(busy_s=1.0, window_s=2.0, kernel_s={}), launches={})
    assert H.load_reader("rbf_gram_roofline").read(ctx) is None


def test_bounds_pinned_to_the_kernel_table():
    # PERF.md's kernel table: the bound column at these shapes
    assert arith.gram_bound(5, 1024, 1024, 2)[0] * 1e3 == pytest.approx(12.57, abs=0.005)
    assert arith.gram_bound(3, 10240, 1024, 2)[0] * 1e3 == pytest.approx(75.28, abs=0.005)
    assert arith.gram_bound(3, 40000, 1024, 2)[0] * 1e3 == pytest.approx(294.03, abs=0.005)
    assert arith.predict_bound(2, 10240, 1024, 1, 2)[0] * 1e3 == pytest.approx(25.91, abs=0.005)
    assert arith.predict_bound(3, 51200, 1024, 2, 2)[0] * 1e3 == pytest.approx(203.55, abs=0.005)
    assert arith.gram_bound(5, 1024, 1024, 2)[1] == "bytes"
    assert arith.predict_bound(2, 10240, 1024, 1, 2)[1] == "operations"
    # the backward kernels' table: the ladder's length cotangents
    assert arith.gram_vjp_bound(2, 1024, 1024, 2)[0] * 1e3 == pytest.approx(5.03, abs=0.005)
    assert arith.gram_vjp_bound(5, 1024, 1024, 2)[0] * 1e3 == pytest.approx(12.57, abs=0.005)
    assert arith.predict_vjp_bound(2, 5120, 1024, 1, 2)[0] * 1e3 == pytest.approx(15.42,
                                                                                 abs=0.005)
    assert arith.predict_vjp_bound(3, 5120, 1024, 2, 2)[0] * 1e3 == pytest.approx(24.06,
                                                                                 abs=0.005)
    assert arith.gram_vjp_bound(2, 1024, 1024, 2)[1] == "bytes"
    assert arith.predict_vjp_bound(2, 5120, 1024, 1, 2)[1] == "operations"


def test_tick_flops_terms_at_n1024():
    n, ne = 1024, 5120
    e0, e1 = 4 * 2 + 2, 4 * 2 + 2 + 2           # an entry; with one right-hand side
    evolve = 9 * n * n * e1 + 9 * ne * n * e1      # element (0,0) alone is active
    small = 2 * (9 * n * n * e1 + 2.0 * 9 * n * n * n + 2.0 * 9 * n * n)
    refit = n * n * e0 + n ** 3 + 10.0 * n * n
    obs = n * n * e0 + 2.0 * n * n + 10.0 * n
    period = 2 * refit + ne * n * e1 + obs
    want = evolve + small + refit + obs + period / 10
    assert arith.tick_flops(n, ne, (True, False, False), 10) == pytest.approx(want)
    assert want == pytest.approx(4.0932e10, rel=1e-4)
    # all three active: no activation test, the coherence's two kernels
    full = arith.tick_flops(n, ne, (True, True, True), 10)
    assert full < want


def test_window_counts_completed_spans_only():
    ends = []

    def run_one(deadline, i):
        time.sleep(0.05)
        if time.perf_counter() > deadline:
            return None
        ends.append(time.perf_counter())
        return dict(end=ends[-1], ticks=10, outdir=None)

    t0, spans = H.run_window(run_one, 0.32)
    assert 4 <= len(spans) <= 7
    assert ends[-1] - t0 <= 0.32
    # every completed span counts; the cut one does not
    assert len(ends) == len(spans)
    assert H.rate(spans, t0) == pytest.approx(10 * len(spans) / (spans[-1]["end"] - t0))


def test_every_span_runs_the_cells_trajectory():
    manifest = H.read_json(H.ROOT / "BENCHMARK.json")
    for w in manifest["workloads"]:
        cell = H.Cell(manifest, w["name"])
        assert cell.gple_config(cell.trajectory).seed == cell.traffic["trajectory_seed"]


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (10, 12)]
    assert TR._union(iv) == 6
    assert TR._gaps(iv, 0, 11) == [(3, 5), (6, 10)]


class _Event:
    def __init__(self, a, b, name, cpu=False):
        self.a, self.b, self.n, self.cpu = a, b, name, cpu

    def start_ns(self):
        return self.a

    def end_ns(self):
        return self.b

    def name(self):
        return self.n

    def device_type(self):
        return torch.autograd.DeviceType.CPU if self.cpu else torch.autograd.DeviceType.CUDA


def test_trace_reduction_on_synthetic_events():
    tr = TR.Tracer.__new__(TR.Tracer)
    base = 10 ** 12
    tr.clocks0 = dict(perf=0, real=base, mono=5)
    tr.clocks1 = dict(perf=10 ** 9, real=base + 10 ** 9, mono=5 + 10 ** 9)
    tr.stop_s = 0.0
    events = [_Event(base + 1e8, base + 3e8, "gemm"), _Event(base + 2e8, base + 4e8, "exp"),
              _Event(base + 6e8, base + 7e8, "gemm"), _Event(base, base + 1e9, "host", True)]
    tr.prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    tr.sampler = SimpleNamespace(samples=[(int(5e8), "driver._advance_fused"),
                                          (int(8e8), "mc._chain_block")])
    out = TR.reduce(tr)
    assert out["clock"] == "real"
    assert out["busy_s"] == pytest.approx(0.4) and out["window_s"] == pytest.approx(1.0)
    assert dict(out["breakdown"]["device_ops"])["gemm"] == pytest.approx(0.3)
    idle = dict(out["breakdown"]["idle_gaps"])
    assert idle["driver._advance_fused"] == pytest.approx(0.3)   # [0, .1] takes the next sample
    assert idle["mc._chain_block"] == pytest.approx(0.3)
