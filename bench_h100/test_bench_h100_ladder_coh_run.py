"""A whole run (set-up, window, check) of the tiny coherence ladder cell
(:func:`test_bench_h100_ladder_coh.tiny_root`) on the CPU, without the look
for a chip: it reads correct, with a compared chunked pair and a compared
ladder whose accepted stage ran the full pass."""

import json
import time

import pytest

from bench_h100 import harness as H
from bench_h100.test_bench_h100_ladder_coh import TINY, tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


def one_span(run_one, seconds):
    """:func:`harness.run_window` cut to its first span: on the CPU a span of
    the tiny cell takes ~40 s, and a second one would run to its first
    output before the window's end stopped it."""
    t0 = time.perf_counter()
    return t0, [run_one(float("inf"), 0)]


def test_coherence_cell_is_correct(root, monkeypatch):
    monkeypatch.setattr(H, "run_window", one_span)
    manifest = H.read_json(root / "BENCHMARK.json")
    lines = []
    res = H.run_cell(manifest, TINY, 2 ** 31 + 5, 1.0, False, "cpu", root=root,
                     bench=root / "bench_h100", log=lines.append)
    assert res["correct"], res["checks"]
    assert {"ladder_gap", "kkt", "decisions", "pairs"} <= set(res["checks"])
    assert res["checks"]["pairs"][0] >= 1
    notes = json.loads(lines[-1])["notes"]
    assert any("ladder at tick 20" in n and "(full pass)" in n for n in notes), notes
