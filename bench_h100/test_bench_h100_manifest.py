"""BENCHMARK.json against the harness's files: every cell, configuration,
traffic mix, limit and per-layer reader is found by name, and the manifest
keeps the contract's shapes.  CPU only."""

import json
import re

import pytest

from bench_h100 import harness as H

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(scope="module")
def manifest():
    return H.read_json(H.ROOT / "BENCHMARK.json")


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert manifest["paths"] == ["bench_h100"]
    assert manifest["command"] == ["python3", "bench_h100/run.py"]
    assert 1 <= manifest["run_seconds"] <= 51
    assert len(json.dumps(manifest)) < 64 * 1024


def test_configs_hold_what_they_run(manifest):
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("bench_h100/configs/")
        cfg = H.read_json(H.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in manifest["workloads"])


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      H.read_json(H.ROOT / "BENCHMARK.json")["workloads"]])
def test_cell_discovery(manifest, workload):
    cell = H.Cell(manifest, workload)
    assert NAME.match(workload) and cell.entry["chips"] == 1
    assert cell.traffic["span_ticks"] > 0 and cell.traffic["warm_ticks"] > 0
    assert cell.limits["decisions"] == 1.0 and cell.limits["pairs"] >= 1
    cfg = cell.gple_config(2 ** 31 + 7)
    assert cfg.seed == 2 ** 31 + 7 and not cfg.init_cache and cfg.dtype == "float64"
    assert cfg.output_freq == cfg.reopt_freq
    assert (cfg.total_ticks >= cell.traffic["span_ticks"]
            and cell.traffic["span_ticks"] % cfg.reopt_freq == 0)
    e2e = [m["name"] for m in H.metrics_for(manifest, workload, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert H.metrics_for(manifest, workload, "per_layer")


def test_metrics_have_readers(manifest):
    names = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in manifest["workloads"]}
    for m in manifest["per_layer"]:
        assert callable(H.load_reader(m["name"]).read)
        assert m["moves"] in {e["name"] for e in manifest["end_to_end"]}
        assert set(m["workloads"]) <= cells
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    import sys
    import types

    assert "gple_tpu_torch" not in H.FORBIDDEN
    monkeypatch.setitem(sys.modules, "gple_tpu_torch_fake.sub", types.ModuleType("x"))
    assert H.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "gple_tpu.driver", types.ModuleType("x"))
    assert H.forbidden_modules() == ["gple_tpu", "jax"]
