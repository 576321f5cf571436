"""The control of the tiny coherence ladder cell on the CPU: on one span of
:func:`test_bench_h100_ladder_coh.tiny_root`'s cell, the program reads
correct and the reference computed in float32 in its place reads not
correct, with a number for every reading."""

import math

import pytest
import torch

from bench_h100 import check as CH
from bench_h100 import harness as H
from bench_h100.test_bench_h100_ladder_coh import TINY, TRAJECTORY, tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


def test_control_is_not_correct(root):
    manifest = H.read_json(root / "BENCHMARK.json")
    cell = H.Cell(manifest, TINY, root, root / "bench_h100")
    cfg = cell.gple_config(TRAJECTORY)
    span = H.run_span(cell, cfg, "cpu", float("inf"), root, 0)
    prog = CH.evaluate(cfg, span["snaps"], span["events"], 1, "cpu")
    ctl = CH.evaluate(cfg, span["snaps"], span["events"], 1, "cpu",
                      control_dtype=torch.float32)
    assert CH.verdict(prog, cell.limits)[0], prog.values
    assert prog.values["pairs"] >= 1
    assert not CH.verdict(ctl, cell.limits)[0], ctl.values
    assert all(math.isfinite(v) for v in ctl.values.values()), ctl.values
