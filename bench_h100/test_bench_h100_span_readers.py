"""The readers of the program's span totals (``capture_pct``, ``launch_pct``,
``tick_dev_ms``, ``period_end_dev_ms``) on synthetic contexts: each reads
its key of ``phase_times``, and finds nothing where the key is missing (a
program without the spans) or 0 (a CPU run).  CPU only."""

from types import SimpleNamespace

import pytest

from bench_h100 import harness as H

READERS = ("capture_pct", "launch_pct", "tick_dev_ms", "period_end_dev_ms")


def _ctx(**phase):
    cfg = SimpleNamespace(num_points=1024, num_extra_points=5120, reopt_freq=10,
                          initial_population=(1.0, 0.0))
    times = dict(init=2.0, output=4.0, fused=30.0, fused_abort=0.0)
    times.update(phase)
    return dict(cfg=cfg, window_s=40.0, ticks=600, phase_times=times, trace=None,
                launches={})


@pytest.mark.parametrize("name,key,want", [
    ("capture_pct", "capture", 100 * 2.0 / 40.0),
    ("launch_pct", "launch", 100 * 2.0 / 40.0),
    ("tick_dev_ms", "dev.fused_tick", 1e3 * 2.0 / 600),
    ("period_end_dev_ms", "dev.fused_period_end", 1e3 * 2.0 / 60),
])
def test_span_readers(name, key, want):
    assert H.load_reader(name).read(_ctx(**{key: 2.0})) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_span_readers_find_nothing_without_the_spans(name):
    reader = H.load_reader(name)
    assert reader.read(_ctx()) is None
    keys = ("capture", "launch", "dev.fused_tick", "dev.fused_period_end")
    assert reader.read(_ctx(**{k: 0.0 for k in keys})) is None


def test_span_readers_are_in_the_manifest():
    manifest = H.read_json(H.ROOT / "BENCHMARK.json")
    entries = {m["name"]: m for m in manifest["per_layer"]}
    assert set(READERS) <= set(entries)
    for name in READERS:
        m = entries[name]
        assert (m["source"], m["moves"], m["layer"], m["better"]) == (
            "program_span", "ticks_per_s", "step / tick", "lower")
    assert entries["capture_pct"]["workloads"] == ["sac1024.flight", "dac256.band",
                                                   "sac1024.cli"]
    assert entries["launch_pct"]["workloads"] == ["dac256.band", "sac1024.cli"]
    assert entries["tick_dev_ms"]["workloads"] == ["sac1024.flight"]
    assert entries["period_end_dev_ms"]["workloads"] == ["sac1024.flight"]
