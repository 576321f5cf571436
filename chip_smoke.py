#!/usr/bin/env python3
"""Drive the PyTorch port (``gple_tpu_torch``) on one CUDA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the CUDA kernels from ``gple_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card at the
   shapes of the main path, with the stated tolerance, and both times;
4. agreement: one fit+evolve step at N = 256 on the GPU (kernels) against the
   same step on the CPU (plain versions);
5. slice: at N = 1024, 2 warm-up + 10 timed ``make_step_fn`` steps and 5
   ``_tick_core`` ticks with 5N extra points; every output finite and both
   kernels launched by the main path.

The second-to-last lines are a JSON object ``{"kernels": [...]}`` and the
``nvidia-smi`` name/power line; the last line is
``{"ok": true, "device": {...}}``.  TF32 is off for matmuls and convolutions:
the port computes in float64, and float32 cases are compared in full float32.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

MODEL, MASS, DT = "SAC", 2000.0, 1.0
N_AGREE = 256
N_SLICE = 1024
WARMUP_STEPS, TIMED_STEPS, TICKS = 2, 10, 5
TOL_GRAM_F64 = 1e-12        # absolute, entries in [0, 1]
TOL_GRAM_F32 = 1e-6         # absolute, float32 rounding of d2 and exp
TOL_PREDICT_F64 = 1e-10     # relative to the largest |plain sum|
TOL_POINTS, TOL_RHO, TOL_ALPHA = 1e-12, 1e-8, 1e-8   # tests/test_sharding.py:68-73


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` in ms over ``iters`` calls, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cloud(rng, batch: int, n: int, dev, dtype):
    """Points shaped like the example cloud: r0 + sigma * N(0, 1)."""
    pts = np.array([-10.0, 30.0]) + rng.normal(size=(batch, n, 2)) * np.array([1 / 3, 1.5])
    return torch.tensor(pts, dtype=dtype, device=dev)


def lengths_like(rng, batch: int, dev, dtype):
    ls = np.array([1 / 3, 1.5]) * rng.uniform(0.5, 2.0, size=(batch, 2))
    return torch.tensor(ls, dtype=dtype, device=dev)


def kernel_phase():
    """Each kernel against its plain version at the main path's shapes."""
    from gple_tpu_torch.ops import gram_kernels as GK

    rng = np.random.default_rng(0)
    dev = "cuda"
    cases = []
    gram_shapes = [  # (B, Na, Nb, dtype, what)
        (5, N_SLICE, N_SLICE, torch.float64, "refit grams"),
        (3, 10 * N_SLICE, N_SLICE, torch.float64, "complex variance cross-grams"),
        (2, 10 * N_SLICE, N_SLICE, torch.float64, "diagonal variance cross-grams"),
        (5, N_SLICE, N_SLICE, torch.float32, "refit grams, float32"),
    ]
    for batch, na, nb, dtype, what in gram_shapes:
        l = lengths_like(rng, batch, dev, dtype)
        xa, xb = cloud(rng, batch, na, dev, dtype), cloud(rng, batch, nb, dev, dtype)
        out = GK.gram_cuda(l, xa, xb)
        ref = GK.gram_plain(l, xa, xb)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = TOL_GRAM_F64 if dtype == torch.float64 else TOL_GRAM_F32
        ms = cuda_ms(lambda: GK.gram_cuda(l, xa, xb), 20)
        plain_ms = cuda_ms(lambda: GK.gram_plain(l, xa, xb), 5)
        cases.append(dict(kernel="rbf_gram", shape=f"B={batch} {na}x{nb} D=2 {dtype}",
                          what=what, max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms))
        del out, ref
    predict_shapes = [  # (B, M, N, C, what)
        (2, 10 * N_SLICE, N_SLICE, 1, "diagonal mean, density query fan"),
        (3, 10 * N_SLICE, N_SLICE, 2, "complex mean, density query fan"),
        (3, 50 * N_SLICE, N_SLICE, 2, "complex mean, extra-cloud query fan"),
    ]
    for batch, m, n, c, what in predict_shapes:
        dtype = torch.float64
        l = lengths_like(rng, batch, dev, dtype)
        xt, xtr = cloud(rng, batch, m, dev, dtype), cloud(rng, batch, n, dev, dtype)
        alpha = torch.tensor(rng.normal(size=(batch, n, c)), dtype=dtype, device=dev)
        out = GK.predict_mean_cuda(l, xt, xtr, alpha)
        ref = GK.predict_mean_plain(l, xt, xtr, alpha)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        ms = cuda_ms(lambda: GK.predict_mean_cuda(l, xt, xtr, alpha), 10)
        plain_ms = cuda_ms(lambda: GK.predict_mean_plain(l, xt, xtr, alpha), 3)
        cases.append(dict(kernel="rbf_predict_mean",
                          shape=f"B={batch} M={m} N={n} C={c} D=2 {dtype}", what=what,
                          max_abs_err=err, rel_err=rel, tol=TOL_PREDICT_F64, ms=ms,
                          plain_ms=plain_ms))
        del out, ref
    for case in cases:
        log("kernel " + json.dumps(case))
    for case in cases:
        measured = case.get("rel_err", case["max_abs_err"])
        if not measured <= case["tol"]:
            raise AssertionError(f"kernel disagrees with its plain version: {case}")
    return cases


def agreement_phase():
    """One step at N_AGREE on the GPU (kernels) against the CPU (plain)."""
    from gple_tpu_torch.entry import example_state
    from gple_tpu_torch.parallel.sharding import make_step_fn

    step = make_step_fn(MODEL, MASS, DT)
    outs = {}
    for dev in ("cuda", "cpu"):
        density, gps = example_state(N_AGREE, dev, generator=torch.Generator().manual_seed(0))
        outs[dev] = step(density, gps)
    torch.cuda.synchronize()
    (dg, gg), (dc, gc) = outs["cuda"], outs["cpu"]
    errs = {
        "points": (dg.points.cpu() - dc.points).abs().max().item(),
        "rho": (dg.rho.cpu() - dc.rho).abs().max().item(),
        "alpha": (gg.diag.alpha.cpu() - gc.diag.alpha).abs().max().item(),
    }
    log(f"agreement N={N_AGREE} GPU vs CPU step: " + json.dumps(errs))
    for key, tol in (("points", TOL_POINTS), ("rho", TOL_RHO), ("alpha", TOL_ALPHA)):
        if not errs[key] <= tol:
            raise AssertionError(f"GPU step disagrees with CPU step on {key}: "
                                 f"{errs[key]} > {tol}")


def _check_finite(name, tree):
    for leaf in _leaves(tree):
        if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
            raise AssertionError(f"{name}: non-finite values")


def _leaves(tree):
    if isinstance(tree, tuple):
        for t in tree:
            yield from _leaves(t)
    elif isinstance(tree, torch.Tensor):
        yield tree


def slice_phase():
    """The main path at N_SLICE: steps then ticks, launch counts read around them."""
    from gple_tpu_torch import driver
    from gple_tpu_torch.entry import example_extra, example_state
    from gple_tpu_torch.ops import gram_kernels as GK
    from gple_tpu_torch.parallel.sharding import make_step_fn

    gen = torch.Generator().manual_seed(0)
    density, gps = example_state(N_SLICE, "cuda", generator=gen)
    extra = example_extra(5 * N_SLICE, "cuda", generator=gen)
    pop0 = gps.population().item()
    log(f"slice N={N_SLICE}: population before {pop0!r}")
    step = make_step_fn(MODEL, MASS, DT)
    torch.cuda.synchronize()

    GK.reset_launches()
    for _ in range(WARMUP_STEPS):
        density, gps = step(density, gps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        density, gps = step(density, gps)
    torch.cuda.synchronize()
    s_step = (time.perf_counter() - t0) / TIMED_STEPS
    pop_steps = gps.population().item()

    tick_s = []
    smalls = []
    for _ in range(TICKS):
        t0 = time.perf_counter()
        density, extra, small, gps = driver._tick_core(
            MODEL, MASS, DT, density, extra, gps, gps.diag.params, gps.offdiag.params,
            driver.gp_dist_all_nocut, "none", 0, 2.0, True)
        torch.cuda.synchronize()
        tick_s.append(time.perf_counter() - t0)
        smalls.append(small.tolist())
    launches = dict(GK.LAUNCHES)
    pop1 = gps.population().item()

    log(f"slice N={N_SLICE}: s/step {s_step!r} (mean of {TIMED_STEPS} after "
        f"{WARMUP_STEPS} warm-up, host clock around synchronize)")
    log(f"slice N={N_SLICE}: s/tick {sum(tick_s) / len(tick_s)!r} (each: {tick_s!r})")
    log(f"slice N={N_SLICE}: population after steps {pop_steps!r}, after ticks {pop1!r}; "
        f"purity {gps.purity().item()!r}; is_very_small {smalls[-1]}")
    log(f"slice launches: {json.dumps(launches)}")

    for name, tree in (("density", density), ("extra", extra), ("gps", gps)):
        _check_finite(name, tree)
    if density.points.shape != (3, N_SLICE, 2) or extra.rho.shape != (3, 5 * N_SLICE, 2):
        raise AssertionError("slice: unexpected output shapes")
    if not abs(pop1 / pop0 - 1.0) < 0.05:
        raise AssertionError(f"slice: population drifted from {pop0} to {pop1}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"slice: kernel {name} was not launched by the main path")
    return launches, s_step


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from gple_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device {torch.cuda.get_device_name(0)}; count {torch.cuda.device_count()}")
    log(f"nvidia-smi: {smi}")

    _build.library()
    log(f"build: {_build.BUILD_INFO['seconds']!r} s -> {_build.BUILD_INFO['path']}")
    for line in _build.BUILD_INFO["log"].splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log("  nvcc: " + line.strip())

    cases = kernel_phase()
    agreement_phase()
    launches, _ = slice_phase()

    sources = {"rbf_gram": ("gple_tpu_torch/csrc/rbf_gram.cu",
                            "gple_tpu/ops/pallas_gram.py:78"),
               "rbf_predict_mean": ("gple_tpu_torch/csrc/rbf_predict.cu",
                                    "gple_tpu/ops/pallas_gram.py:124")}
    kernels = []
    for name, (source, replaces) in sources.items():
        mine = [c for c in cases if c["kernel"] == name]
        head = mine[0]
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=launches[name],
                            max_abs_err=max(c["max_abs_err"] for c in mine),
                            ms=head["ms"], plain_ms=head["plain_ms"], shape=head["shape"]))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
