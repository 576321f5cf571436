"""``correct``'s two readings at a size a test can hold, on the CPU: the
control (the reference in float32 in the program's place) and the program
with its timed path broken underneath come out not correct under the cells'
limits, and the program as it is comes out correct.  Each drives a whole run
(set-up, window, check) without the look for a chip."""

import json
import shutil

import pytest
import torch

from bench_h100 import check as CH
from bench_h100 import harness as H

#: name: (the cell it stands for, writers, its span's ticks, a window that
#: holds a span); the flight's span is one fused segment of the cell's 100 ticks
CELLS = {"tiny.flight": ("sac1024.flight", False, 100, 20.0),
         "tiny.cli": ("sac1024.cli", True, 20, 4.0)}
#: the per-layer metrics no reader finds on the CPU: the device trace's and
#: those of the CUDA graphs' and CUDA events' spans
CPU_SILENT = {"rbf_gram_roofline", "rbf_predict_roofline", "device_idle_pct", "capture_pct",
              "launch_pct", "tick_dev_ms", "period_end_dev_ms"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("bench")
    bench = root / "bench_h100"
    for sub in ("configs", "traffic", "limits"):
        (bench / sub).mkdir(parents=True)
    shutil.copytree(H.BENCH / "metrics", bench / "metrics")
    manifest = H.read_json(H.ROOT / "BENCHMARK.json")
    manifest["configs"] = [dict(name="tiny", source="-", file="bench_h100/configs/tiny.json",
                                reduced=["num_points"], why="-")]
    manifest["workloads"] = [dict(name=w, config="tiny", traffic=w.split(".")[1], chips=1,
                                  why="-") for w in CELLS]
    for m in manifest["per_layer"]:
        m["workloads"] = [w for w, (real, *_) in CELLS.items() if real in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    gple = dict(H.read_json(H.BENCH / "configs" / "tully_sac_n1024.json")["gple"],
                num_points=24)
    (bench / "configs" / "tiny.json").write_text(json.dumps(dict(name="tiny", gple=gple)))
    for name, (real, writers, ticks, _) in CELLS.items():
        traffic = dict(span_ticks=ticks, writers=writers, overrides={}, warm_ticks=10,
                       trajectory_seed=2 ** 31 + 3)
        (bench / "traffic" / f"{name.split('.')[1]}.json").write_text(json.dumps(traffic))
        shutil.copy(H.BENCH / "limits" / f"{real}.json", bench / "limits" / f"{name}.json")
    return root


def _run(root, workload, seed=2 ** 31 + 5, trace=False):
    manifest = H.read_json(root / "BENCHMARK.json")
    return H.run_cell(manifest, workload, seed, CELLS[workload][3], trace, "cpu", root=root,
                      bench=root / "bench_h100", log=lambda line: None)


@pytest.mark.parametrize("workload", list(CELLS))
@pytest.mark.parametrize("trace", [False, True])
def test_program_is_correct(root, workload, trace):
    manifest = H.read_json(root / "BENCHMARK.json")
    res = _run(root, workload, trace=trace)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and res["attempted"] >= 1
    want = {m["name"] for m in H.metrics_for(manifest, workload,
                                             "per_layer" if trace else "end_to_end")}
    # on the CPU no device operation is traced, no CUDA graph captured or
    # replayed and no CUDA event timed: those readers find none
    assert set(res["metrics"]) == want - (CPU_SILENT if trace else set())


@pytest.mark.parametrize("workload", list(CELLS))
def test_control_is_not_correct(root, workload):
    manifest = H.read_json(root / "BENCHMARK.json")
    cell = H.Cell(manifest, workload, root, root / "bench_h100")
    cfg = cell.gple_config(2 ** 31 + 9)
    span = H.run_span(cell, cfg, "cpu", float("inf"), root, 0)
    prog = CH.evaluate(cfg, span["snaps"], span["events"], 1, "cpu", outdir=span["outdir"])
    ctl = CH.evaluate(cfg, span["snaps"], span["events"], 1, "cpu", outdir=span["outdir"],
                      control_dtype=torch.float32)
    assert CH.verdict(prog, cell.limits)[0]
    assert not CH.verdict(ctl, cell.limits)[0], ctl.values


def _unchanged_tick(monkeypatch):
    import gple_tpu_torch.driver as D

    def tick(model, mass, dt, density, extra, gps, *args):
        return density, extra, ~density.active, gps
    monkeypatch.setattr(D, "_tick_core", tick)


def _half_the_points(monkeypatch):
    from gple_tpu_torch.dynamics import evolve as EV
    real = EV.evolve_step

    def evolve(model, mass, dt, density, *args, **kw):
        new = real(model, mass, dt, density, *args, **kw)
        half = density.points.shape[1] // 2
        pts, rho = new.points.clone(), new.rho.clone()
        pts[:, half:], rho[:, half:] = density.points[:, half:], density.rho[:, half:]
        return new._replace(points=pts, rho=rho)
    monkeypatch.setattr(EV, "evolve_step", evolve)


def _altered_answer(monkeypatch):
    from gple_tpu_torch import observables as OBS
    real = OBS.observe_all

    def observe(*args, **kw):
        out = real(*args, **kw)
        out["pop_prm"] = out["pop_prm"] * (1.0 + 1e-6)
        return out
    monkeypatch.setattr(OBS, "observe_all", observe)


@pytest.mark.parametrize("workload", list(CELLS))
@pytest.mark.parametrize("fault", [_unchanged_tick, _half_the_points, _altered_answer])
def test_broken_timed_path_is_not_correct(root, monkeypatch, workload, fault):
    fault(monkeypatch)
    res = _run(root, workload)
    assert not res["correct"], res["checks"]
