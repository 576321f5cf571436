"""PyTorch port: the span recorder (``gple_tpu_torch/utils/spans.py``) and
the driver's spans.

Spans nest with their parents, roots and self times; a span closed with
``ok=False`` adds to ``<name>_abort``; ``GPLEDriver.phase_times`` is a view
of a run's totals with the same keys in every run; a short fused and a
short chunked trajectory give bit-identical records with the timeline on and
off; a callback that raises leaves no span open; and a ``profile_dir`` trace
holds the program's spans as ranges.
"""

import contextlib
import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from gple_tpu_torch import driver as TD
from gple_tpu_torch.config import GPLEConfig
from gple_tpu_torch.ops import graphs as GR
from gple_tpu_torch.utils import spans
from test_torch_kernels import _warm_torch_exp, one_torch_thread  # noqa: F401 (fixtures)

TICKS = 6
#: reopt and output every 2 ticks, far from the coupling: no activation
CFG = GPLEConfig(model="SAC", mass=2000.0, x0=-10.0, p0=30.0, sigma_p0=1.5, output_time=2.0,
                 reopt_time=2.0, dt=1.0, num_points=16)
#: fused segments of two periods, or the chunked path
ROUTES = {"fused": 4, "chunked": 0}


class Stop(Exception):
    pass


def _run(fused_chunk: int, timeline: bool, callback=None, ticks: int = TICKS):
    drv = TD.GPLEDriver(dataclasses.replace(CFG, fused_chunk=fused_chunk), device="cpu")
    with spans.timeline() if timeline else contextlib.nullcontext():
        drv.run(max_ticks=ticks, callback=callback)
    return drv


@pytest.fixture(scope="module")
def runs():
    return {(route, timeline): _run(chunk, timeline)
            for route, chunk in ROUTES.items() for timeline in (False, True)}


def test_spans_nest_with_parents_and_self_time():
    with spans.collect() as totals, spans.timeline() as tl:
        with spans.span("outer", tick=3) as outer:
            with spans.span("inner") as first:
                time.sleep(0.01)
            with spans.span("inner") as second:
                spans.count("hits", 2)
            time.sleep(0.005)
            outer.set(ok=True)
    assert [r.name for r in tl.records] == ["inner", "inner", "outer"]
    assert outer.parent is None and outer.root == outer.id
    assert first.parent == second.parent == outer.id and first.root == outer.id
    assert outer.attrs == {"tick": 3, "ok": True}
    assert set(tl.anchor) == {"perf", "real", "mono"}
    assert totals.calls("inner") == 2 and totals.count("hits") == 2
    assert totals.seconds("outer") == pytest.approx(outer.seconds, rel=1e-12)
    own = tl.self_seconds()
    assert own["outer"] == pytest.approx(outer.seconds - first.seconds - second.seconds,
                                         rel=1e-9)
    assert own["outer"] >= 0.005 and own["inner"] >= 0.01
    assert [r.name for r in tl.under(first).records] == ["inner"]
    assert len(tl.under(outer).records) == 3
    assert spans.open_spans() == []


def test_totals_without_a_timeline():
    with spans.collect() as totals:
        with spans.span("segment") as aborted:
            aborted.set(ok=False)
        with spans.span("segment") as clean:
            clean.set(ok=True)
        spans.add("dev.segment", 0.25)
        with spans.collect(totals):         # already collecting: counted once
            spans.count("hits")
    with spans.span("outside"):
        spans.count("hits")
    assert aborted.id is None and spans.open_spans() == []
    assert totals.calls("segment") == totals.calls("segment_abort") == 1
    assert totals.seconds("dev.segment") == 0.25 and totals.count("hits") == 1
    assert totals.calls("outside") == 0


def test_cpu_graphs_make_no_spans():
    state = torch.zeros(1)
    with spans.collect() as totals:
        GR.Graph(lambda: state.add_(1.0), state, "tick")()
    assert state.item() == 1.0 and totals.spans == {}


def _records_equal(a, b) -> bool:
    return len(a.history) == len(b.history) and all(
        all(np.array_equal(getattr(x, f.name), getattr(y, f.name))
            for f in dataclasses.fields(x))
        for x, y in zip(a.history, b.history))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_timeline_changes_no_record(runs, route):
    off, on = runs[route, False], runs[route, True]
    assert off.spans is None and on.spans is not None
    assert _records_equal(off, on) and len(on.history) == TICKS // 2 + 1
    for a, b in zip(GR.leaves((off.density, off.extra, off.gps)),
                    GR.leaves((on.density, on.extra, on.gps))):
        assert torch.equal(a, b)
    assert off.rng.seed == on.rng.seed


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_phase_times_is_a_view_of_the_totals(runs, route):
    drv = runs[route, True]
    times = drv.phase_times
    fresh = TD.GPLEDriver(CFG, device="cpu").phase_times
    assert list(times) == list(fresh) == list(TD.PHASE_SPANS)
    assert set(fresh.values()) == {0.0}
    # each key is its spans' total, as the timeline has them
    ns = {}
    for r in drv.spans.records:
        ns[r.key] = ns.get(r.key, 0) + r.end - r.start
    for key, names in TD.PHASE_SPANS.items():
        assert times[key] == sum(drv.totals.seconds(n) for n in names)
        assert times[key] == pytest.approx(sum(ns.get(n, 0) for n in names) * 1e-9,
                                           rel=1e-12, abs=0.0)
    assert times["init"] > 0.0 and times["output"] > 0.0 and times["wait"] > 0.0
    # the CPU captures and replays no graph and records no device event
    assert times["capture"] == times["launch"] == times["dev.fused_tick"] == 0.0


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_the_runs_span_tree(runs, route):
    records = runs[route, True].spans.records
    by_id = {r.id: r for r in records}
    run = records[-1]
    assert run.name == "run" and all(r.root == run.id for r in records)
    assert [by_id[r.parent].name for r in records if r.name == "init"] == ["run"]
    assert {r.name for r in records if r.parent is not None
            and by_id[r.parent].name == "init"} >= {"mc_select", "extra", "optimize", "refit"}
    children = {}
    for r in records:
        if r.parent is not None:
            children.setdefault(by_id[r.parent].name, set()).add(r.name)
    assert children["output"] >= {"observe"}
    if route == "fused":
        fused = [r for r in records if r.name == "fused"]
        assert [(r.attrs["tick"], r.attrs["n"], r.attrs["ok"]) for r in fused] == [
            (1, 4, True)]
    else:
        assert children["step"] >= {"evolve", "reopt"}
        assert children["reopt"] == {"reselect", "tune", "fit"}
        assert all(r.attrs["ok"] for r in records if r.name == "chunk")


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_a_raising_callback_leaves_no_span_open(route):
    def stop(rec):
        raise Stop

    with spans.timeline() as tl:
        drv = TD.GPLEDriver(dataclasses.replace(CFG, fused_chunk=ROUTES[route]),
                            device="cpu")
        with pytest.raises(Stop):
            drv.run(max_ticks=TICKS, callback=stop)
        assert spans.open_spans() == []
    assert tl.records[-1].name == "run" and all(r.end is not None for r in tl.records)
    with spans.span("after"):
        pass
    assert drv.totals.calls("after") == 0 and drv.totals.calls("run") == 1


def test_profile_dir_trace_holds_the_program_spans(tmp_path, monkeypatch):
    """The initialization restored from the cache (a cold run first): the
    Metropolis walks of an initialization make a large trace on the CPU."""
    monkeypatch.setenv(TD.INIT_CACHE_ENV, str(tmp_path / "cache"))
    cfg = dataclasses.replace(CFG, init_cache=True, fused_chunk=0)
    TD.GPLEDriver(cfg, device="cpu").run(max_ticks=1)
    drv = TD.GPLEDriver(cfg, device="cpu", profile_dir=str(tmp_path / "prof"))
    drv.run(max_ticks=2)
    with open(drv.trace_path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert {"run", "init", "restore", "reopt", "output", "wait"} <= names
    assert {r.name for r in drv.spans.records} >= {"run", "init", "restore", "reopt"}
    assert spans.current_timeline() is None
