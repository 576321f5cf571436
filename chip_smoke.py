#!/usr/bin/env python3
"""Drive the PyTorch port (``gple_tpu_torch``) on one CUDA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the CUDA kernels from ``gple_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card at every
   shape of the main path, with the stated tolerance; two launches on the same
   inputs bit for bit; the kernel's device time (median of 5 runs of >= 200
   back-to-back launches and >= 20 ms) and the plain version's, beside the
   kernel's bound (``gple_tpu_torch/ops/kernel_bench.py``);
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


def kernel_phase():
    """Each kernel against its plain version at the main path's shapes: the
    agreement, two launches bit for bit, and the device times against the
    bound (``gple_tpu_torch.ops.kernel_bench``)."""
    from gple_tpu_torch.ops import _build
    from gple_tpu_torch.ops import gram_kernels as GK
    from gple_tpu_torch.ops import kernel_bench as KB

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    lib = _build.library()
    cases = []
    for case in KB.GRAM_CASES:
        l = KB.lengths_like(rng, case.batch, dev, case.dtype)
        xa = KB.cloud(rng, case.batch, case.na, dev, case.dtype)
        xb = KB.cloud(rng, case.batch, case.nb, dev, case.dtype)
        out, again = GK.gram_cuda(l, xa, xb), GK.gram_cuda(l, xa, xb)
        ref = GK.gram_plain(l, xa, xb)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = TOL_GRAM_F64 if case.dtype == torch.float64 else TOL_GRAM_F32
        ms = KB.device_ms(KB.raw_gram(lib, l, xa, xb, out))
        plain_ms = KB.device_ms(lambda: GK.gram_plain(l, xa, xb), launches=5, min_ms=0,
                                repeats=3)
        bound, by = KB.gram_bound(case.batch, case.na, case.nb, 2, case.dtype.itemsize)
        cases.append(dict(kernel="rbf_gram", shape=case.shape, what=case.what,
                          per_step=case.per_step, per_tick=case.per_tick,
                          max_abs_err=err, tol=tol, bitwise_repeat=bool(torch.equal(out, again)),
                          ms=ms, plain_ms=plain_ms, bound_us=bound * 1e3, bound_by=by,
                          share=bound / ms))
        del out, again, ref
    for case in KB.PREDICT_CASES:
        l = KB.lengths_like(rng, case.batch, dev, case.dtype)
        xt = KB.cloud(rng, case.batch, case.m, dev, case.dtype)
        xtr = KB.cloud(rng, case.batch, case.n, dev, case.dtype)
        alpha = torch.tensor(rng.normal(size=(case.batch, case.n, case.c)), dtype=case.dtype,
                             device=dev)
        out = GK.predict_mean_cuda(l, xt, xtr, alpha)
        again = GK.predict_mean_cuda(l, xt, xtr, alpha)
        ref = GK.predict_mean_plain(l, xt, xtr, alpha)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        raw_out, scratch, plan = KB.predict_buffers(xt, case.n, case.c)
        ms = KB.device_ms(KB.raw_predict(lib, l, xt, xtr, alpha, raw_out, scratch, plan))
        plain_ms = KB.device_ms(lambda: GK.predict_mean_plain(l, xt, xtr, alpha), launches=3,
                                min_ms=0, repeats=3)
        bound, by = KB.predict_bound(case.batch, case.m, case.n, case.c, 2)
        cases.append(dict(kernel="rbf_predict_mean", shape=case.shape, what=case.what,
                          per_step=case.per_step, per_tick=case.per_tick, plan=list(plan),
                          max_abs_err=err, rel_err=err / ref.abs().max().item(),
                          tol=TOL_PREDICT_F64, bitwise_repeat=bool(torch.equal(out, again)),
                          ms=ms, plain_ms=plain_ms, bound_us=bound * 1e3, bound_by=by,
                          share=bound / ms))
        del out, again, ref, raw_out, scratch
    for case in cases:
        log("kernel " + json.dumps(case))
    for case in cases:
        measured = case.get("rel_err", case["max_abs_err"])
        if not measured <= case["tol"]:
            raise AssertionError(f"kernel disagrees with its plain version: {case}")
        if not case["bitwise_repeat"]:
            raise AssertionError(f"two launches on the same inputs differ: {case}")
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
    in_steps = dict(GK.LAUNCHES)

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
    log(f"slice launches: {json.dumps(launches)} ({json.dumps(in_steps)} in the "
        f"{WARMUP_STEPS + TIMED_STEPS} steps, the rest in the {TICKS} ticks)")

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


def kernel_summary(cases, launches):
    """One entry per kernel for the ``{"kernels": [...]}`` line.  Its top-level
    times are those of the shape where the main path spends the most kernel
    time (launches per step + tick times ms); every shape is in ``cases``."""
    sources = {"rbf_gram": ("gple_tpu_torch/csrc/rbf_gram.cu",
                            "gple_tpu/ops/pallas_gram.py:78"),
               "rbf_predict_mean": ("gple_tpu_torch/csrc/rbf_predict.cu",
                                    "gple_tpu/ops/pallas_gram.py:124")}
    kernels = []
    for name, (source, replaces) in sources.items():
        mine = [c for c in cases if c["kernel"] == name]
        head = max(mine, key=lambda c: (c["per_step"] + c["per_tick"]) * c["ms"])
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=max(c["max_abs_err"] for c in mine),
            ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_us"] / 1e3,
            bound_by=head["bound_by"], library_ms=None, shape=head["shape"],
            cases=[{k: c[k] for k in ("shape", "per_step", "per_tick", "ms", "plain_ms",
                                      "bound_us", "bound_by", "share", "max_abs_err")}
                   for c in mine]))
    return kernels


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

    print(json.dumps({"kernels": kernel_summary(cases, launches)}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
