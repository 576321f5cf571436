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
   kernels launched by the main path;
6. trajectory: ``GPLEDriver(entry.trajectory_config(1024), outdir, "cuda")
   .run(max_ticks=40)`` -- the production Tully-A trajectory (initial
   Metropolis selection, 4 chunks + 4 scheduled reopts, 5 outputs with the
   seven files); conservation, finiteness and files checked, and the walls
   of the initialization phases, the ticks, the reopts and the outputs;
7. crossing: ``entry.crossing_config()`` for 240 ticks through the avoided
   crossing (element activations, cloud re-selections), its populations held
   against the committed DVR table ``gple_tpu_torch/data/sac_crossing_dvr.json``;
8. kernels at the trajectory's shapes: every (kernel, shape) that phases 6
   and 7 launched, checked and timed as in phase 3;
9. VJP kernels: ``rbf_gram_vjp`` and ``rbf_predict_vjp`` against their plain
   versions at every shape of the ladder's gradient (1e-10 relative to the
   largest |entry|), two launches bit for bit, times beside the bound;
10. ladder: ``Optimizer(opt_mode="ladder")`` on ``entry.example_state(1024)``
   (all three elements active, so the coherence's full pass runs) with
   ``entry.example_extra(5120)``: the wall of each stage, the accepted stage,
   the constraint checks; then one loss and gradient at N = 256 on the GPU
   against the same on the CPU;
11. reference parity: ``GPLEDriver(replace(entry.trajectory_config(1024),
   reference_parity=True))`` for 20 ticks with a checkpoint every 10, and a
   second driver resumed from the tick-10 file to tick 20, whose populations
   must match the straight run's to 5e-3; the walls of the initialization
   (with the ladder), the ticks, the reopts and the outputs;
12. kernels at the ladder's shapes: every (kernel, shape) that phases 10 and
   11 launched and no earlier phase checked, checked and timed as in phase 3.

Each of phases 5-7, 10 and 11 resets the launch counters just before it and
reads them just after; every forward kernel must have launched in each, and
the two VJP kernels in phases 10 and 11.  The second-to-last
lines are a JSON object ``{"kernels": [...]}`` and the ``nvidia-smi``
name/power line; the last line is ``{"ok": true, "device": {...}}``.  TF32 is
off for matmuls and convolutions: the port computes in float64, and float32
cases are compared in full float32.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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
TRAJ_N, TRAJ_TICKS = 1024, 40
CROSS_TICKS = 240
TOL_VJP = 1e-10             # relative to the largest |plain entry|
LADDER_N, LADDER_AGREE_N = 1024, 256
#: L-BFGS steps of phase 10's ladder (the driver's reoptimization budget)
LADDER_STEPS = 30
TOL_LADDER_AGREE = 1e-8     # GPU against CPU loss and gradient, relative
RP_TICKS, RP_CHECKPOINT = 20, 10
TOL_RESUME = 5e-3           # tests/test_checkpoint.py:78
FORWARD = ("rbf_gram", "rbf_predict_mean")
DVR_TABLE = Path(__file__).resolve().parent / "gple_tpu_torch" / "data" / "sac_crossing_dvr.json"
OUTPUT_FILES = ("ave.txt", "param.txt", "coord.txt", "value.txt", "phase.txt", "var.txt",
                "run.log")


def log(msg: str) -> None:
    print(msg, flush=True)


def kernel_phase(gram_cases=None, predict_cases=None, vjp_cases=()):
    """Each kernel against its plain version at the main path's shapes (by
    default those of ``kernel_bench``): the agreement, two launches bit for
    bit, and the device times against the bound
    (``gple_tpu_torch.ops.kernel_bench``)."""
    from gple_tpu_torch.ops import _build
    from gple_tpu_torch.ops import gram_kernels as GK
    from gple_tpu_torch.ops import kernel_bench as KB

    gram_cases = KB.GRAM_CASES if gram_cases is None else gram_cases
    predict_cases = KB.PREDICT_CASES if predict_cases is None else predict_cases
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    lib = _build.library()
    cases = []
    for case in gram_cases:
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
        cases.append(dict(kernel="rbf_gram", shape=case.shape, key=case.key, what=case.what,
                          per_step=case.per_step, per_tick=case.per_tick,
                          max_abs_err=err, tol=tol, bitwise_repeat=bool(torch.equal(out, again)),
                          ms=ms, plain_ms=plain_ms, bound_us=bound * 1e3, bound_by=by,
                          share=bound / ms))
        del out, again, ref
    for case in predict_cases:
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
        cases.append(dict(kernel="rbf_predict_mean", shape=case.shape, key=case.key,
                          what=case.what,
                          per_step=case.per_step, per_tick=case.per_tick, plan=list(plan),
                          max_abs_err=err, rel_err=err / ref.abs().max().item(),
                          tol=TOL_PREDICT_F64, bitwise_repeat=bool(torch.equal(out, again)),
                          ms=ms, plain_ms=plain_ms, bound_us=bound * 1e3, bound_by=by,
                          share=bound / ms))
        del out, again, ref, raw_out, scratch
    for case in vjp_cases:
        cases.append(_vjp_case(lib, rng, dev, case))
    for case in cases:
        log("kernel " + json.dumps(case))
    for case in cases:
        measured = case.get("rel_err", case["max_abs_err"])
        if not measured <= case["tol"]:
            raise AssertionError(f"kernel disagrees with its plain version: {case}")
        if not case["bitwise_repeat"]:
            raise AssertionError(f"two launches on the same inputs differ: {case}")
    return cases


def _vjp_case(lib, rng, dev, case):
    """One VJP kernel shape: the wrapper twice and the plain version on the
    same inputs, then the bare launch and the plain version timed."""
    from gple_tpu_torch.ops import gram_kernels as GK
    from gple_tpu_torch.ops import kernel_bench as KB

    l = KB.lengths_like(rng, case.batch, dev, case.dtype)
    xa = KB.cloud(rng, case.batch, case.na, dev, case.dtype)
    xb = KB.cloud(rng, case.batch, case.nb, dev, case.dtype)
    alpha = None
    if case.c == 0:
        gw = torch.tensor(rng.normal(size=(case.batch, case.na, case.nb)), dtype=case.dtype,
                          device=dev)
        out, again = GK.gram_vjp_cuda(l, xa, xb, gw), GK.gram_vjp_cuda(l, xa, xb, gw)
        ref = GK.gram_vjp_plain(l, xa, xb, gw)
        bound, by = KB.gram_vjp_bound(case.batch, case.na, case.nb, 2, case.dtype.itemsize)

        def plain():
            return GK.gram_vjp_plain(l, xa, xb, gw)
    else:
        alpha = torch.tensor(rng.normal(size=(case.batch, case.nb, case.c)), dtype=case.dtype,
                             device=dev)
        gw = torch.tensor(rng.normal(size=(case.batch, case.na, case.c)), dtype=case.dtype,
                          device=dev)
        out = GK.predict_vjp_cuda(l, xa, xb, alpha, gw)
        again = GK.predict_vjp_cuda(l, xa, xb, alpha, gw)
        ref = GK.predict_vjp_plain(l, xa, xb, alpha, gw)
        bound, by = KB.predict_vjp_bound(case.batch, case.na, case.nb, case.c, 2,
                                         case.dtype.itemsize)

        def plain():
            return GK.predict_vjp_plain(l, xa, xb, alpha, gw)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    raw_out = torch.empty_like(out)
    scratch = torch.empty((case.batch, GK.vjp_partials(case.na, case.nb), 2),
                          dtype=case.dtype, device=dev)
    ms = KB.device_ms(KB.raw_vjp(lib, l, xa, xb, gw, raw_out, scratch, alpha))
    plain_ms = KB.device_ms(plain, launches=3, min_ms=0, repeats=3)
    return dict(kernel=case.kernel, shape=case.shape, key=case.key, what=case.what,
                per_step=0, per_tick=0, max_abs_err=err,
                rel_err=err / ref.abs().max().item(), tol=TOL_VJP,
                bitwise_repeat=bool(torch.equal(out, again)), ms=ms, plain_ms=plain_ms,
                bound_us=bound * 1e3, bound_by=by, share=bound / ms)


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
    _check_path_launches("slice", launches)
    return launches, s_step


def _instrument(drv, calls):
    """Wrap the driver's initialization, reoptimization and output so each
    call records its wall (after a synchronize) and the kernel launches by
    shape made inside it; what is left of a run's launches is the ticks'."""
    from gple_tpu_torch.ops import gram_kernels as GK

    for name in ("initialize", "_reoptimize", "observe"):
        inner = getattr(drv, name)

        def wrapped(*args, _inner=inner, _name=name, **kw):
            before = dict(GK.LAUNCHES_BY_SHAPE)
            t0 = time.perf_counter()
            out = _inner(*args, **kw)
            torch.cuda.synchronize()
            calls.setdefault(_name, []).append(dict(
                s=time.perf_counter() - t0,
                launches={k: v - before.get(k, 0) for k, v in GK.LAUNCHES_BY_SHAPE.items()
                          if v != before.get(k, 0)}))
            return out

        setattr(drv, name, wrapped)


def _sum_launches(records):
    total = {}
    for rec in records:
        for k, v in rec["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


def _check_path_launches(phase: str, launches: dict, names=FORWARD):
    for name in names:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{phase}: kernel {name} was not launched")


def trajectory_phase():
    """The production trajectory at TRAJ_N through ``GPLEDriver.run`` on the card."""
    from gple_tpu_torch.driver import GPLEDriver
    from gple_tpu_torch.entry import trajectory_config
    from gple_tpu_torch.ops import gram_kernels as GK

    cfg = trajectory_config(TRAJ_N)
    calls = {}
    with tempfile.TemporaryDirectory() as outdir:
        drv = GPLEDriver(cfg, outdir=outdir, device="cuda")
        _instrument(drv, calls)
        torch.cuda.synchronize()
        GK.reset_launches()
        t0 = time.perf_counter()
        hist = drv.run(max_ticks=TRAJ_TICKS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, by_shape = dict(GK.LAUNCHES), dict(GK.LAUNCHES_BY_SHAPE)
        sizes = {name: (Path(outdir) / name).stat().st_size if (Path(outdir) / name).exists()
                 else 0 for name in OUTPUT_FILES}
        ave_rows = np.loadtxt(Path(outdir) / "ave.txt", ndmin=2).shape[0]
    init_s = calls["initialize"][0]["s"]
    reopt_s = [c["s"] for c in calls.get("_reoptimize", [])]
    output_s = [c["s"] for c in calls["observe"]]
    tick_s = (wall - init_s - sum(reopt_s) - sum(output_s)) / TRAJ_TICKS
    per = dict(
        init=_sum_launches(calls["initialize"]),
        reopt={k: v / len(reopt_s) for k, v in _sum_launches(calls["_reoptimize"]).items()},
        output={k: v / len(output_s) for k, v in _sum_launches(calls["observe"]).items()})
    rest = dict(by_shape)
    for group in ("initialize", "_reoptimize", "observe"):
        for k, v in _sum_launches(calls[group]).items():
            rest[k] -= v
    per["tick"] = {k: v / TRAJ_TICKS for k, v in rest.items() if v}
    walls = dict(run_s=wall, init_s=init_s, init_marks=dict(drv.init_marks),
                 s_per_tick=tick_s, reopts=len(reopt_s),
                 mean_reopt_s=sum(reopt_s) / len(reopt_s), reopt_s=reopt_s,
                 outputs=len(output_s), mean_output_s=sum(output_s) / len(output_s),
                 output_s=output_s, phase_times=drv.phase_times, stats=drv.stats,
                 mc_params=[(p.num_steps, p.displacement) for p in drv.mc_params])
    log(f"trajectory N={TRAJ_N}, {TRAJ_TICKS} ticks: " + json.dumps(walls))
    for rec in hist:
        log(f"trajectory record t={rec.time} pop_prm={rec.population_prm!r} "
            f"ppl_mci={rec.population_mci.tolist()} E_prm/pop={rec.energy_prm / rec.population_prm!r} "
            f"purity_prm={rec.purity_prm!r} purity_mci={rec.purity_mci!r} "
            f"<x>={rec.x_average!r} opt={rec.opt_type}")
    log(f"trajectory launches: {json.dumps(launches)}; output files {json.dumps(sizes)}")

    if len(hist) != TRAJ_TICKS // cfg.output_freq + 1 or ave_rows != len(hist):
        raise AssertionError(f"trajectory: {len(hist)} records, {ave_rows} ave.txt rows")
    for rec in hist:
        values = [rec.population_prm, rec.energy_prm, rec.energy_mci, rec.purity_prm,
                  rec.purity_mci, rec.x_average, *rec.population_mci,
                  *rec.population_prm_each]
        if not np.all(np.isfinite(values)):
            raise AssertionError(f"trajectory: non-finite record at t={rec.time}")
        if not abs(sum(rec.population_mci) - 1.0) < 0.05:
            raise AssertionError(f"trajectory: population {rec.population_mci} at t={rec.time}")
        if not abs(rec.energy_prm / rec.population_prm / drv.total_energy - 1.0) < 0.08:
            raise AssertionError(f"trajectory: energy {rec.energy_prm / rec.population_prm} "
                                 f"vs {drv.total_energy} at t={rec.time}")
    for name, tree in (("density", drv.density), ("extra", drv.extra), ("gps", drv.gps)):
        _check_finite(f"trajectory {name}", tree)
    missing = [name for name, size in sizes.items() if size <= 0]
    if missing:
        raise AssertionError(f"trajectory: output files missing or empty: {missing}")
    _check_path_launches("trajectory", launches)
    return launches, by_shape, per, walls


def crossing_phase():
    """The crossing trajectory on the card against the exact DVR populations."""
    from gple_tpu_torch.driver import GPLEDriver
    from gple_tpu_torch.entry import crossing_config
    from gple_tpu_torch.ops import gram_kernels as GK

    with open(DVR_TABLE) as f:
        table = json.load(f)
    drv = GPLEDriver(crossing_config(), device="cuda")
    torch.cuda.synchronize()
    GK.reset_launches()
    t0 = time.perf_counter()
    hist = drv.run(max_ticks=CROSS_TICKS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_shape = dict(GK.LAUNCHES), dict(GK.LAUNCHES_BY_SHAPE)
    gt = np.array([r.time for r in hist])
    gp0 = np.array([r.population_mci[0] for r in hist])
    sp0 = np.interp(gt, table["times"], np.array(table["populations"])[:, 0])
    rmse = float(np.sqrt(np.mean((gp0 - sp0) ** 2)))
    pop_dev = float(np.max(np.abs([r.population_mci.sum() - 1.0 for r in hist])))
    result = dict(run_s=wall, ticks=CROSS_TICKS, records=len(hist), rmse_vs_dvr=rmse,
                  final_population_mci=hist[-1].population_mci.tolist(),
                  max_population_deviation=pop_dev, stats=drv.stats,
                  active=drv.density.active.tolist(), phase_times=drv.phase_times,
                  init_marks=dict(drv.init_marks))
    log("crossing: " + json.dumps(result))
    log(f"crossing launches: {json.dumps(launches)}")
    if not hist[-1].population_mci[1] > 0.25:
        raise AssertionError(f"crossing: final upper population {hist[-1].population_mci}")
    if not all(result["active"]):
        raise AssertionError("crossing: not every element became active")
    if drv.stats["element_activations"] < 2 or drv.stats["cloud_reselections"] < 1:
        raise AssertionError(f"crossing: non-adiabatic machinery did not fire: {drv.stats}")
    if not pop_dev < 0.12:
        raise AssertionError(f"crossing: total population off by {pop_dev}")
    if not rmse < 0.055:
        raise AssertionError(f"crossing: RMSE vs DVR {rmse} >= 0.055")
    _check_path_launches("crossing", launches)
    return launches, by_shape, result


def trajectory_kernel_phase(traj_by_shape, cross_by_shape):
    """Phase 3's checks and times at every (kernel, shape) that the trajectory
    and crossing phases launched and phase 3 does not cover."""
    from gple_tpu_torch.ops import kernel_bench as KB

    keys = set(traj_by_shape) | set(cross_by_shape)
    grams, predicts, vjps = KB.cases_from_launches(keys, "trajectory / crossing")
    cases = kernel_phase(grams, predicts, vjps)
    log(f"trajectory kernel phase: {len(cases)} new (kernel, shape) cases")
    return cases


def vjp_phase():
    """Phase 9: both VJP kernels at every shape of the ladder's gradient."""
    from gple_tpu_torch.ops import kernel_bench as KB

    cases = kernel_phase((), (), KB.VJP_CASES)
    log(f"vjp kernel phase: {len(cases)} (kernel, shape) cases")
    return cases


def _ladder_problem(n: int, dev):
    """The example state (all three elements active) and its 5N extra cloud,
    the surface energies and the targets: total energy weighted by the
    populations, purity 1."""
    from gple_tpu_torch import observables as OBS
    from gple_tpu_torch.entry import example_extra, example_state

    gen = torch.Generator().manual_seed(0)
    density, _ = example_state(n, dev, generator=gen)
    extra = example_extra(5 * n, dev, generator=gen)
    energies = OBS.total_energy_each_surface(MODEL, density, MASS)
    pops = OBS.population_each_surface(density)
    e0 = float(torch.sum(pops * energies) / torch.sum(pops))
    return density, extra, energies, e0


def ladder_phase():
    """Phase 10: the constrained ladder at full width, every kernel launched."""
    from gple_tpu_torch.entry import SIGMA
    from gple_tpu_torch.gp.opt import Optimizer
    from gple_tpu_torch.ops import gram_kernels as GK

    density, extra, energies, e0 = _ladder_problem(LADDER_N, "cuda")
    optimizer = Optimizer(model=MODEL, mass=MASS, total_energy=e0, purity=1.0,
                          sigma_r0=np.asarray(SIGMA), lbfgs_steps=LADDER_STEPS,
                          opt_mode="ladder", device="cuda")
    stage_launches = _count_stage_launches()
    torch.cuda.synchronize()
    GK.reset_launches()
    t0 = time.perf_counter()
    try:
        res = optimizer.optimize(density, extra, energies)
    finally:
        stage_launches.restore()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_shape = dict(GK.LAUNCHES), dict(GK.LAUNCHES_BY_SHAPE)
    stages = [dict(tag=st["tag"], seconds=st["seconds"], error=st["error"],
                   averages=st["averages"].tolist(), check=st["check"].tolist(),
                   launches={f"{k[0]} {k[1]}": v for k, v in counts.items()})
              for st, counts in zip(optimizer.stages, stage_launches.records)]
    result = dict(n=LADDER_N, lbfgs_steps=LADDER_STEPS, wall_s=wall, accepted=res.opt_type,
                  error=res.error, stages=stages, targets=[1.0, e0, 1.0],
                  diag_lengths=optimizer.diag_lengths.tolist(),
                  off_params=optimizer.off_params.tolist(),
                  al_lam=optimizer._al_lam.tolist(), launches=launches)
    log("ladder: " + json.dumps(result))
    if not np.isfinite(res.error) or res.opt_type not in ("local_previous", "local_initial",
                                                          "global"):
        raise AssertionError(f"ladder: result {res}")
    if not all(np.all(np.isfinite(st["averages"])) for st in stages):
        raise AssertionError("ladder: non-finite averages")
    _check_path_launches("ladder", launches, tuple(launches))
    return launches, by_shape, result


def _count_stage_launches():
    """Record the kernel launches by shape of every ladder stage
    (``gp.opt._run_stage`` call) until ``.restore()``."""
    import types

    from gple_tpu_torch.gp import opt as O
    from gple_tpu_torch.ops import gram_kernels as GK

    inner = O._run_stage
    rec = types.SimpleNamespace(records=[])

    def counted(*args, **kw):
        before = dict(GK.LAUNCHES_BY_SHAPE)
        out = inner(*args, **kw)
        rec.records.append({k: v - before.get(k, 0) for k, v in GK.LAUNCHES_BY_SHAPE.items()
                            if v != before.get(k, 0)})
        return out

    O._run_stage = counted
    rec.restore = lambda: setattr(O, "_run_stage", inner)
    return rec


def ladder_agreement_phase():
    """Phase 10b: one ladder loss and its gradient at N = 256 on the GPU
    against the same on the CPU."""
    from gple_tpu_torch.entry import SIGMA
    from gple_tpu_torch.gp import opt as O

    outs = {}
    for dev in ("cuda", "cpu"):
        density, extra, energies, e0 = _ladder_problem(LADDER_AGREE_N, dev)
        optimizer = O.Optimizer(model=MODEL, mass=MASS, total_energy=e0, purity=1.0,
                                sigma_r0=np.asarray(SIGMA), opt_mode="ladder", device=dev)
        data, _ = optimizer._pack_data(density, extra, energies)
        diag = torch.tensor(np.tile(SIGMA, (2, 1)), device=dev, requires_grad=True)
        off = torch.tensor([0.8, *SIGMA, 1.2, *SIGMA, 0.4], dtype=torch.float64, device=dev,
                           requires_grad=True)
        loss = (O._diag_loss(diag, data) + O._off_loss(off, data)
                + torch.sum(O._raw_averages(diag, off, data, True)))
        grads = torch.autograd.grad(loss, (diag, off))
        outs[dev] = [loss.detach().cpu(), *(g.cpu() for g in grads)]
    torch.cuda.synchronize()
    errs = {name: ((g - c).abs().max() / c.abs().max()).item()
            for name, g, c in zip(("loss", "d_diag", "d_off"), outs["cuda"], outs["cpu"])}
    log(f"ladder agreement N={LADDER_AGREE_N} GPU vs CPU loss and gradient (relative): "
        + json.dumps(errs))
    for name, err in errs.items():
        if not err <= TOL_LADDER_AGREE:
            raise AssertionError(f"ladder: GPU {name} disagrees with the CPU: {err}")


def _walls(calls: dict, wall: float, ticks: int) -> dict:
    """Initialization, per-tick, reopt and output walls from ``_instrument``."""
    init_s = sum(c["s"] for c in calls.get("initialize", []))
    reopt_s = [c["s"] for c in calls.get("_reoptimize", [])]
    output_s = [c["s"] for c in calls.get("observe", [])]
    return dict(run_s=wall, init_s=init_s,
                s_per_tick=(wall - init_s - sum(reopt_s) - sum(output_s)) / ticks,
                reopts=len(reopt_s), reopt_s=reopt_s, outputs=len(output_s),
                output_s=output_s)


def _check_records(phase, hist, total_energy):
    for rec in hist:
        values = [rec.population_prm, rec.energy_prm, rec.energy_mci, rec.purity_prm,
                  rec.purity_mci, rec.x_average, *rec.population_mci,
                  *rec.population_prm_each]
        if not np.all(np.isfinite(values)):
            raise AssertionError(f"{phase}: non-finite record at t={rec.time}")
        if not abs(sum(rec.population_mci) - 1.0) < 0.05:
            raise AssertionError(f"{phase}: population {rec.population_mci} at t={rec.time}")
        if not abs(rec.energy_prm / rec.population_prm / total_energy - 1.0) < 0.08:
            raise AssertionError(f"{phase}: energy {rec.energy_prm / rec.population_prm} "
                                 f"vs {total_energy} at t={rec.time}")


def parity_phase():
    """Phase 11: the reference-parity trajectory with a checkpoint, resumed."""
    import dataclasses
    import shutil

    from gple_tpu_torch import observables as OBS
    from gple_tpu_torch.driver import GPLEDriver
    from gple_tpu_torch.entry import trajectory_config
    from gple_tpu_torch.ops import gram_kernels as GK

    cfg = dataclasses.replace(trajectory_config(TRAJ_N), reference_parity=True)
    with tempfile.TemporaryDirectory() as tmp:
        path, at10 = f"{tmp}/ck.npz", f"{tmp}/ck{RP_CHECKPOINT}.npz"

        def keep(rec):
            if round(rec.time / cfg.dt) == RP_CHECKPOINT:
                shutil.copyfile(path, at10)

        calls = {}
        drv = GPLEDriver(cfg, outdir=f"{tmp}/straight", device="cuda")
        _instrument(drv, calls)
        torch.cuda.synchronize()
        GK.reset_launches()
        t0 = time.perf_counter()
        hist = drv.run(max_ticks=RP_TICKS, callback=keep, checkpoint_path=path,
                       checkpoint_every=RP_CHECKPOINT)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, by_shape = dict(GK.LAUNCHES), dict(GK.LAUNCHES_BY_SHAPE)

        rcalls = {}
        resumed = GPLEDriver(cfg, outdir=f"{tmp}/resumed", device="cuda")
        _instrument(resumed, rcalls)
        t0 = time.perf_counter()
        rhist = resumed.run(max_ticks=RP_TICKS, resume_from=at10)
        torch.cuda.synchronize()
        rwall = time.perf_counter() - t0
        resume_by_shape = dict(GK.LAUNCHES_BY_SHAPE)
    pop = OBS.population_each_surface(drv.density).cpu().numpy()
    rpop = OBS.population_each_surface(resumed.density).cpu().numpy()
    walls = _walls(calls, wall, RP_TICKS)
    walls.update(init_marks=dict(drv.init_marks), phase_times=drv.phase_times,
                 stages=[dict(tag=st["tag"], seconds=st["seconds"], check=st["check"].tolist())
                         for st in drv.optimizer.stages],
                 resumed=_walls(rcalls, rwall, RP_TICKS - RP_CHECKPOINT),
                 populations=pop.tolist(), resumed_populations=rpop.tolist(),
                 resume_max_abs_diff=float(np.max(np.abs(pop - rpop))),
                 opt_types=[rec.opt_type for rec in hist],
                 resumed_opt_types=[rec.opt_type for rec in rhist])
    log(f"reference parity N={TRAJ_N}, {RP_TICKS} ticks: " + json.dumps(walls))
    log(f"reference parity launches: {json.dumps(launches)}")
    if len(hist) != RP_TICKS // cfg.output_freq + 1 or len(rhist) != 1:
        raise AssertionError(f"reference parity: {len(hist)} / {len(rhist)} records")
    _check_records("reference parity", hist + rhist, drv.total_energy)
    if not walls["resume_max_abs_diff"] <= TOL_RESUME:
        raise AssertionError(f"reference parity: the resumed populations {rpop} differ from "
                             f"the straight run's {pop}")
    _check_path_launches("reference parity", launches, tuple(launches))
    return launches, by_shape, resume_by_shape, walls


def ladder_kernel_phase(known, *by_shapes):
    """Phase 12: phase 3's checks and times at every (kernel, shape) that the
    ladder and the reference-parity phases launched and no earlier phase
    checked."""
    from gple_tpu_torch.ops import kernel_bench as KB

    keys = set().union(*by_shapes)
    grams, predicts, vjps = KB.cases_from_launches(keys, "ladder / reference parity",
                                                   known=known)
    cases = kernel_phase(grams, predicts, vjps)
    log(f"ladder kernel phase: {len(cases)} new (kernel, shape) cases")
    return cases


def kernel_summary(cases, paths, per):
    """One entry per kernel for the ``{"kernels": [...]}`` line.  ``launches``
    is the count of the kernel's main path: the trajectory phase for the
    forward kernels, the ladder phase for the VJP kernels; its top-level
    times are those of the shape where that path spends the most kernel time
    (launches x ms); every shape is in ``cases`` with its launches in each
    path and, for the trajectory, per tick, per reopt and per output."""
    sources = {
        "rbf_gram": ("gple_tpu_torch/csrc/rbf_gram.cu", "gple_tpu/ops/pallas_gram.py:78",
                     "trajectory"),
        "rbf_predict_mean": ("gple_tpu_torch/csrc/rbf_predict.cu",
                             "gple_tpu/ops/pallas_gram.py:124", "trajectory"),
        "rbf_gram_vjp": ("gple_tpu_torch/csrc/rbf_vjp.cu",
                         "gple_tpu/gp/opt.py:297 (no Pallas kernel: XLA's autodiff of "
                         "gple_tpu/ops/kernels.py:gram inside jax.grad)", "ladder"),
        "rbf_predict_vjp": ("gple_tpu_torch/csrc/rbf_vjp.cu",
                            "gple_tpu/gp/opt.py:297 (no Pallas kernel: XLA's autodiff of "
                            "gple_tpu/ops/kernels.py:gram inside jax.grad)", "ladder"),
    }
    kernels = []
    for name, (source, replaces, main_path) in sources.items():
        mine = [c for c in cases if c["kernel"] == name]
        for c in mine:
            key = (c["kernel"], tuple(c["key"][1]))
            c["launches_by_path"] = {path: by_shape.get(key, 0)
                                     for path, (_, by_shape) in paths.items()}
            c["trajectory_per"] = {what: per[what].get(key, 0)
                                   for what in ("tick", "reopt", "output", "init")}
        head = max(mine, key=lambda c: c["launches_by_path"][main_path] * c["ms"])
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=paths[main_path][0][name], main_path=main_path,
            launches_by_path={path: launches.get(name, 0)
                              for path, (launches, _) in paths.items()},
            max_abs_err=max(c["max_abs_err"] for c in mine),
            ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_us"] / 1e3,
            bound_by=head["bound_by"], library_ms=None, shape=head["shape"],
            cases=[{k: c[k] for k in ("shape", "what", "per_step", "per_tick",
                                      "launches_by_path", "trajectory_per", "ms",
                                      "plain_ms", "bound_us", "bound_by", "share",
                                      "max_abs_err")}
                   for c in mine]))
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from gple_tpu_torch.ops import _build
    from gple_tpu_torch.ops import gram_kernels as GK

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
    slice_launches, _ = slice_phase()
    slice_by_shape = dict(GK.LAUNCHES_BY_SHAPE)
    traj_launches, traj_by_shape, per, _ = trajectory_phase()
    cross_launches, cross_by_shape, _ = crossing_phase()
    cases += trajectory_kernel_phase(traj_by_shape, cross_by_shape)
    cases += vjp_phase()
    ladder_launches, ladder_by_shape, _ = ladder_phase()
    ladder_agreement_phase()
    rp_launches, rp_by_shape, resume_by_shape, _ = parity_phase()
    cases += ladder_kernel_phase({(c["key"][0], tuple(c["key"][1])) for c in cases},
                                 ladder_by_shape, rp_by_shape, resume_by_shape)
    paths = {"slice": (slice_launches, slice_by_shape),
             "trajectory": (traj_launches, traj_by_shape),
             "crossing": (cross_launches, cross_by_shape),
             "ladder": (ladder_launches, ladder_by_shape),
             "reference_parity": (rp_launches, rp_by_shape)}

    print(json.dumps({"kernels": kernel_summary(cases, paths, per)}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
