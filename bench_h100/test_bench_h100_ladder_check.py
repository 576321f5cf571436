"""The ladder check on the CPU, on a tiny reference-parity cell: a whole run
(set-up, window, check) without the look for a chip reads correct, and the
control (the reference in float32 in the program's place) reads not
correct.  The cell's files are made by :func:`tiny_root`, which the tests of
the planted faults share."""

import json
import shutil

import pytest
import torch

from bench_h100 import check as CH
from bench_h100 import harness as H

CELL = "sac1024.ladder"
TINY = "tiny.ladder"


def tiny_root(root):
    """A checkout at ``root`` with one cell, ``tiny.ladder``: the ladder cell's
    configuration at N = 24, one period a span, its limits and readers."""
    torch.set_num_threads(2)
    bench = root / "bench_h100"
    for sub in ("configs", "traffic", "limits"):
        (bench / sub).mkdir(parents=True)
    shutil.copytree(H.BENCH / "metrics", bench / "metrics")
    manifest = H.read_json(H.ROOT / "BENCHMARK.json")
    manifest["configs"] = [dict(name="tiny", source="-", file="bench_h100/configs/tiny.json",
                                reduced=["num_points"], why="-")]
    manifest["workloads"] = [dict(name=TINY, config="tiny", traffic="ladder", chips=1,
                                  why="-")]
    for m in manifest["per_layer"]:
        m["workloads"] = [TINY] if CELL in m["workloads"] else []
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    gple = dict(H.read_json(H.BENCH / "configs" / "tully_sac_n1024_parity.json")["gple"],
                num_points=24)
    (bench / "configs" / "tiny.json").write_text(json.dumps(dict(name="tiny", gple=gple)))
    traffic = dict(span_ticks=10, writers=False, overrides={}, warm_ticks=1,
                   trajectory_seed=2 ** 31 + 11)
    (bench / "traffic" / "ladder.json").write_text(json.dumps(traffic))
    shutil.copy(H.BENCH / "limits" / f"{CELL}.json", bench / "limits" / f"{TINY}.json")
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


def run(root, trace=False, seconds=3.0):
    manifest = H.read_json(root / "BENCHMARK.json")
    return H.run_cell(manifest, TINY, 2 ** 31 + 5, seconds, trace, "cpu", root=root,
                      bench=root / "bench_h100", log=lambda line: None)


@pytest.mark.parametrize("trace", [False, True])
def test_ladder_cell_is_correct(root, trace):
    manifest = H.read_json(root / "BENCHMARK.json")
    res = run(root, trace)
    assert res["correct"], res["checks"]
    assert {"ladder_gap", "kkt", "decisions", "pairs"} <= set(res["checks"])
    assert res["checks"]["pairs"][0] >= 1
    want = {m["name"] for m in H.metrics_for(manifest, TINY,
                                             "per_layer" if trace else "end_to_end")}
    # on the CPU no device operation is traced: the device readers find none
    device = {m["name"] for m in manifest["per_layer"] if m["source"] == "device_trace"}
    assert set(res["metrics"]) == (want - device if trace else want)


def test_control_is_not_correct(root):
    manifest = H.read_json(root / "BENCHMARK.json")
    cell = H.Cell(manifest, TINY, root, root / "bench_h100")
    cfg = cell.gple_config(2 ** 31 + 9)
    span = H.run_span(cell, cfg, "cpu", float("inf"), root, 0)
    prog = CH.evaluate(cfg, span["snaps"], span["events"], 1, "cpu")
    ctl = CH.evaluate(cfg, span["snaps"], span["events"], 1, "cpu",
                      control_dtype=torch.float32)
    assert CH.verdict(prog, cell.limits)[0], prog.values
    assert not CH.verdict(ctl, cell.limits)[0], ctl.values
