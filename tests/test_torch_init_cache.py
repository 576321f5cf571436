"""PyTorch port: the driver's init cache (``GPLEConfig.init_cache``) and its
``torch.profiler`` trace (``GPLEDriver(profile_dir=...)``).

The contract is the JAX package's (``tests/test_checkpoint.py::
test_init_cache_equivalence``): a run that restores its cached
initialization is bitwise identical to the cold run that wrote it, and to a
run with the cache off -- records, density, extra cloud, GP state and the
random key.
"""

import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

from gple_tpu_torch import driver as TD
from gple_tpu_torch.config import GPLEConfig
from gple_tpu_torch.driver import GPLEDriver
from test_torch_kernels import _warm_torch_exp, one_torch_thread  # noqa: F401 (fixtures)

TICKS = 12
CFG = GPLEConfig(model="SAC", mass=2000.0, x0=-2.0, p0=20.0, sigma_p0=1.0, output_time=2.0,
                 reopt_time=2.0, dt=1.0, num_points=16, init_cache=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A cold run with the cache on, a second run of the same config, and a
    run with the cache off; each with its log."""
    cache = str(tmp_path_factory.mktemp("init_cache"))
    mp = pytest.MonkeyPatch()
    mp.setenv(TD.INIT_CACHE_ENV, cache)
    out = {}
    try:
        for name, cfg in (("cold", CFG), ("warm", CFG),
                          ("off", dataclasses.replace(CFG, init_cache=False))):
            drv = GPLEDriver(cfg, device="cpu")
            logs = []
            drv._log = logs.append
            exists_before = os.path.exists(drv._init_cache_path())
            hist = drv.run(max_ticks=TICKS)
            out[name] = types.SimpleNamespace(drv=drv, hist=hist, logs=logs,
                                              exists_before=exists_before)
    finally:
        mp.undo()
    out["cache"] = cache
    return out


def test_cold_run_writes_the_cache_and_the_second_restores_it(runs):
    cold, warm = runs["cold"], runs["warm"]
    assert not cold.exists_before and warm.exists_before
    restored = [line for line in warm.logs if line.startswith("init restored from cache ")]
    assert len(restored) == 1
    path = restored[0].removeprefix("init restored from cache ")
    assert os.path.dirname(os.path.dirname(path)) == runs["cache"]
    assert os.path.basename(path).startswith("init_") and path.endswith("_cpu.npz")
    assert not any("restored" in line for line in cold.logs + runs["off"].logs)


@pytest.mark.parametrize("other", ["warm", "off"])
def test_records_are_bitwise_equal(runs, other):
    ours, theirs = runs["cold"].hist, runs[other].hist
    assert len(ours) == len(theirs) == TICKS // CFG.output_freq + 1
    for a, b in zip(ours, theirs):
        for field in dataclasses.fields(a):
            np.testing.assert_array_equal(np.asarray(getattr(a, field.name)),
                                          np.asarray(getattr(b, field.name)),
                                          err_msg=f"t={a.time}: {field.name}")


@pytest.mark.parametrize("other", ["warm", "off"])
def test_state_is_bitwise_equal(runs, other):
    a, b = runs["cold"].drv, runs[other].drv
    for name, x, y in (("density", a.density, b.density), ("extra", a.extra, b.extra),
                       ("gps", a.gps, b.gps)):
        flat_x, flat_y = _leaves(x), _leaves(y)
        assert len(flat_x) == len(flat_y) > 0
        for i, (u, v) in enumerate(zip(flat_x, flat_y)):
            assert torch.equal(u, v), f"{name} leaf {i}"
    assert a.rng.seed == b.rng.seed
    assert a.stats == b.stats
    np.testing.assert_array_equal(a.optimizer.off_params, b.optimizer.off_params)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [leaf for sub in tree for leaf in _leaves(sub)]
    return []


def _path(cfg):
    holder = types.SimpleNamespace(cfg=cfg, device=torch.device("cpu"))
    return GPLEDriver._init_cache_path(holder)


def _other(value):
    if isinstance(value, bool):
        return not value
    if isinstance(value, (int, float)):
        return value + 1
    if isinstance(value, str):
        return value + "_"
    if isinstance(value, tuple):
        return value + (0.0,)
    return 1.0


def test_the_key_ignores_the_knob_and_tracks_every_other_field(tmp_path, monkeypatch):
    monkeypatch.setenv(TD.INIT_CACHE_ENV, str(tmp_path))
    base = _path(CFG)
    assert _path(dataclasses.replace(CFG, init_cache=False)) == base
    names = [f.name for f in dataclasses.fields(CFG) if f.name != "init_cache"]
    assert len(names) > 30
    for name in names:
        changed = dataclasses.replace(CFG, **{name: _other(getattr(CFG, name))})
        assert _path(changed) != base, name


def test_profile_dir_writes_a_trace(tmp_path, monkeypatch):
    """Ticks far from the crossing, their initialization restored from the
    cache: the Metropolis walks of an initialization or an activation are
    ~10^6 small operations, hundreds of MB of trace on the CPU."""
    monkeypatch.setenv(TD.INIT_CACHE_ENV, str(tmp_path / "cache"))
    cfg = dataclasses.replace(CFG, x0=-10.0, p0=30.0, sigma_p0=1.5)
    GPLEDriver(cfg, device="cpu").run(max_ticks=1)
    drv = GPLEDriver(cfg, device="cpu", profile_dir=str(tmp_path / "prof"))
    drv.run(max_ticks=2)
    assert drv.stats["element_activations"] == 0
    assert drv.trace_path and os.path.dirname(drv.trace_path) == str(tmp_path / "prof")
    with open(drv.trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    assert drv.profiler.key_averages()


def test_profile_stops_when_the_run_raises(tmp_path):
    """The trace is written in ``run``'s ``finally``, as the JAX package
    stops its trace there."""
    cfg = dataclasses.replace(CFG, init_cache=False)
    drv = GPLEDriver(cfg, device="cpu", profile_dir=str(tmp_path))

    def fail():
        raise RuntimeError("initialization failed")

    drv.initialize = fail
    with pytest.raises(RuntimeError, match="initialization failed"):
        drv.run(max_ticks=2)
    assert drv.trace_path and os.path.exists(drv.trace_path)
