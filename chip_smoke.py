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
   ``_tick_core`` ticks with 5N extra points, as replays of one captured CUDA
   graph (the first call captures); every output finite and both kernels
   launched by the main path;
6. trajectory: ``GPLEDriver(entry.trajectory_config(1024), outdir, "cuda")
   .run(max_ticks=40)`` -- the production Tully-A trajectory (initial
   Metropolis selection, 4 chunks + 4 scheduled reopts, 5 outputs with the
   seven files); conservation, finiteness and files checked, and the walls
   of the initialization phases, the ticks, the reopts and the outputs;
7. crossing: ``entry.crossing_config()`` for 240 ticks through the avoided
   crossing (element activations, cloud re-selections); the exact populations
   come from the port's own DVR oracle on the card
   (``entry.crossing_dvr_config()``), held against the committed table
   ``gple_tpu_torch/data/sac_crossing_dvr.json`` (the JAX package's values)
   to 1e-8, and the trajectory's RMSE is taken against them;
8. kernels at the trajectory's shapes: every (kernel, shape) that phases 6
   and 7 launched, checked and timed as in phase 3;
9. VJP kernels: ``rbf_gram_vjp`` and ``rbf_predict_vjp`` against their plain
   versions at every shape of the ladder's gradient (1e-10 relative to the
   largest |entry|; ``rbf_gram_vjp`` also on a transposed, a stride-0-batch
   and an odd-row-stride cotangent), two launches bit for bit, times beside
   the bound;
10. ladder: ``Optimizer(opt_mode="ladder")`` on ``entry.example_state(1024)``
   (all three elements active, so the coherence's full pass runs) with
   ``entry.example_extra(5120)`` and the default inner solver, the zoom line
   search: the wall of each stage, its L-BFGS iterations, loss evaluations
   and host pulls per iteration, the accepted stage, the constraint checks;
   the first stage once more with the fixed fan for its wall, and once more
   with the zoom inside ``torch.profiler`` (``ladder_trace``: the device-busy
   share, device time by family with each hand-written kernel apart, host
   pulls and loss evaluations per iteration, and one device kernel for each
   length-cotangent call); how ``rbf_gram_vjp`` read its cotangents; then one loss
   and gradient at N = 256 on the GPU against the same on the CPU, and the
   ladder's first zoom solve (the diagonal lengths) at N = 256 on the GPU
   against the same solve on the CPU (the final iterate, 1e-8 relative);
11. reference parity: ``GPLEDriver(replace(entry.trajectory_config(1024),
   reference_parity=True))`` for 20 ticks with a checkpoint every 10, and a
   second driver resumed from the tick-10 file to tick 20, whose populations
   must match the straight run's to 5e-3; the walls of the initialization
   (with the ladder, on the zoom), the ticks, the reopts and the outputs;
12. kernels at the ladder's shapes: every (kernel, shape) that phases 10 and
   11 launched and no earlier phase checked, checked and timed as in phase 3;
13. oracles at the production input (SAC, x0 = -10, p0 = 30, sigma_p = 1.5,
   x in [-20, 20]): ``cli.main(["se", ..., "--boundary", "absorbing",
   "--no-wigner"])`` on the card to its stop condition (the walls of H with
   its ``eigh`` and of a Strang step; norm and energy before the absorber);
   the Wigner frames of phase 14's two snapshots at n = 1295, one timed and
   held against the same transform on the CPU; ``LiouvilleSolver`` for 20 outputs (a Trotter step's wall, the
   norm, the Hermiticity); then both oracles on ``tests/test_validation.py``'s
   physics (n = 385 / 97) on the card against the CPU (1e-9 relative; the
   DVR run whole, the Liouville rho after 400 Trotter steps) and against each
   other (populations within 0.05);
14. validation: ``screenshot_fit`` axis-aligned and full-ARD (the zoom line
   search) on three frames of the production DVR (1,677,025 grid points, 200
   selected): the initial packet, the packet at <x> = -4 (t = 400), whose
   Wigner function free flight has tilted, and the run's last output after
   the crossing (t = 980), whose fits must leave their starting lengths;
   ``evolve_fit`` over every frame of phase 13's
   ``test_validation`` run, and the tilted snapshot of
   ``tests/test_full_ard.py``; held to those tests' bounds (the axis-aligned
   fit of the tilted production frame is recorded, and must lose to the
   full-ARD fit by the factor the tilted snapshot must); the strides of the
   cotangents ``rbf_gram_vjp_points`` read and the branch each side took;
   the t = 400 full-ARD fit once more inside ``torch.profiler``
   (``validation_trace``: the device-busy share, device time by family with
   each hand-written kernel apart, the zoom's iterations, evaluations and
   host pulls, and one ``rbf_gram_vjp_points`` device kernel for each Gram
   backward, both point sets: 2 launches a gradient evaluation, where the
   one-sided kernel took 4); then one NLL loss and its gradient (vector and
   full-ARD, N = 200) on the card against the CPU (1e-9 relative);
15. kernels at the validation's shapes: every (kernel, shape) that phases 13
   and 14 launched and no earlier phase checked, checked and timed as in
   phase 3, and ``kernel_bench.POINTS_VJP_CASES`` (the 1024^2 guard): the
   ``rbf_gram_vjp_points`` pair call on a contiguous, a transposed, a
   stride-0-batch and an odd-row-stride cotangent, both sides and each
   alone, timed by both timers beside the latency floor (an empty kernel,
   ``kernel_bench.floor_us``, printed once);
16. booster: ``GPLEDriver(entry.booster_config(1024))`` for 80 ticks -- the
   crossing physics with 1024 extra points in the coherence fit at divisor
   6, per-tick tracking of the coherence, the coherence-only cutoff, both
   conservation rescales and the relabel rules: the walls, the rescale /
   backoff / eject counters, population, energy and purity at every output;
   every record finite, the coherence fit at N + k points, a rescale fired;
   then 5 booster ``_tick_core`` ticks from its last state thinned to every
   fourth point (N = 256, k = 256) on the card against the same ticks on the
   CPU (1e-9 relative);
17. kernels at the booster's shapes, checked and timed as in phase 3;
18. ECR gate (``tests/test_ecr_parity.py``): Tully C at x0 = -2, p0 = 20,
   N = 64, 400 ticks against the port's reflective DVR: population RMSE
   < 1e-3 and the total population within 2% of 1 at every output;
19. kernels at the ECR run's shapes not seen before, as in phase 3;
20. sharding: ``parallel.sharding.sharded_step_fn`` (``shard_refit=True``)
   at N = 1024 on ``entry.example_state(1024)`` on an in-process NCCL group
   of world size 1 (a file store in a temporary directory), 2 warm-up + 10
   timed steps against as many ``make_step_fn`` steps (1e-12 relative to the
   largest |entry|; s/step of both); ``entry.dryrun_multichip`` on every
   card; and two gloo ranks with CUDA tensors on the one card (NCCL refuses
   two ranks on one card), their gathered state against the same steps;
21. profile: ``trajectory_config(1024)`` with ``init_cache`` for 10 ticks
   cold, then again with ``profile_dir`` restored from the cache (records
   and state bit for bit the cold run's): the trace must name the device
   kernels of ``rbf_gram`` and ``rbf_predict_mean``; prints the five device
   operations that took the most time, the time by family and the
   device-busy share of the traced window; then the kernels at the shapes
   of phases 20-21 not seen before, as in phase 3;
22. graphs and the fused path: (a) ``trajectory_config(1024)`` initialized;
   from its state 10 eager ticks of the tick graph's function
   (``driver._tick_program``: ``_tick_core`` and the tick's row) against 10
   replays of its graph, bit for bit (or within 1e-12 relative, should
   cuBLAS pick another algorithm under capture); s/tick of both in turns,
   the host's launch calls a tick of both, the device-busy share of a
   traced window of 10 replays, the capture's wall and the graph pool's
   memory; then the tick graph as the driver captures it (the activation
   test on the host's active tuple) against one captured with all nine
   pairs: device ms a tick in turns, the cuBLAS GEMMs of one replay of each,
   and both replays' states bit for bit; (b) ``run(max_ticks=200)`` without writers, ``fused_chunk`` 100
   against 0 in turns (chunked, fused, fused, chunked): records 1e-6
   relative, points 1e-7, rho 1e-6, keys and stats equal
   (``tests/test_fused_trajectory.py``'s tolerances), the fused path taken;
   (c) ``crossing_config()`` (N = 64) for 100 ticks with one-period fused
   segments against the chunked run: a segment must run and one roll back,
   and the records equal the chunked run's as in (b);
23. walks (``walk_phase``): from an initialized ``entry.parity_config("SAC",
   1024)``, the tuned initial walk and a tuned surrogate re-selection walk of
   element (0, 0), each on one key through the straight loop and through the
   chain graphs (``sampler/mc.py``) in turns: walls, host launch calls of a
   traced walk of each, capture wall and pool; bit for bit, graph replays,
   and the graphed walk's host launches below 1% of the eager walk's; then
   ``tests/test_torch_graphs.py``'s failed-capture test in its own process
   (a chain whose distribution pulls to the host must raise);
24. the reference band (``band_phase``): each row of ``entry.PARITY_ROWS``
   (SAC N = 1024, ECR, SAC and DAC at N = 256) run whole with
   ``GPLEDriver(entry.parity_config(model, N)).run()`` to its stop condition,
   against the port's reflective DVR on the card held to the committed table
   ``gple_tpu_torch/data/parity_dvr.json`` (1e-8): ground-state population
   RMSE by both estimators (``benchmarks/parity.py``'s alignment), mci within
   the row's limit, every record finite, an element activation, the packet
   gone; then the kernels at the shapes of phases 23-24 not seen before, as
   in phase 3.

Each of phases 5-7, 10, 11, 14, 16, 18, 20-22 and each walk and row of 23-24
resets the launch counters just before it and reads them just after (a
launch inside a CUDA graph counts at each replay); phases 6, 7, 21 and 24
must have replayed graphs; every forward kernel must have launched in each
but 20, which must launch ``rbf_gram`` (its predicts
carry the variance, through a cross-Gram and cuBLAS), and 23, which must
launch ``rbf_predict_mean`` (the re-selection's labels), the two length VJP
kernels in phases 10 and 11, and ``rbf_gram_vjp_points`` in phase 14.  The second-to-last
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

from gple_tpu_torch.utils import spans

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
TOL_DVR_TABLE = 1e-8        # the port's DVR on the card against the JAX package's table
LE_OUTPUTS = 20             # phase 13's production Liouville run
LE_CPU_STEPS = 400          # Trotter steps of phase 13's Liouville card-against-CPU check
TOL_ORACLE_AGREE = 1e-9     # card against CPU, relative to the largest |entry|
TOL_ORACLE_CROSS = 0.05     # DVR against Liouville populations, tests/test_liouville.py:87
TOL_WIGNER_CPU = 1e-10      # one production Wigner frame, card against CPU, relative
TOL_CONSERVED = 1e-6        # norm and energy of the absorbing DVR before the absorber
#: tests/test_validation.py's and tests/test_full_ard.py's bounds
VAL_REL_RMSE, VAL_POP_REL, FULL_ARD_GAIN = 5e-3, 0.02, 0.7
TOL_NLL_AGREE = 1e-9        # NLL loss and gradient, card against CPU, relative
TOL_ZOOM_AGREE = 1e-8       # one zoom L-BFGS solve at N = 256, card against CPU, relative
BOOST_N, BOOST_TICKS = 1024, 80
#: the booster run's seed (see ``booster_phase``)
BOOST_SEED = 0
BOOST_AGREE_TICKS, BOOST_AGREE_STRIDE = 5, 4
TOL_BOOST_AGREE = 1e-9      # booster ticks, card against CPU, relative to the largest |entry|
ECR_N, ECR_TICKS = 64, 400
ECR_RMSE, ECR_POP = 1e-3, 0.02   # tests/test_ecr_parity.py
#: phase 20: the sharded step against make_step_fn, relative to the largest |entry|
TOL_SHARDED = 1e-12
#: phase 21: ticks of the profiled trajectory
PROFILE_TICKS = 10
#: phase 22: graphed ticks against eager ticks; the fused run's and the fused
#: crossing run's ticks, the crossing's segment length (one reopt period, so
#: an event aborts one segment); tests/test_fused_trajectory.py's tolerances
GRAPH_TICKS, FUSED_TICKS, FUSED_CROSS_TICKS, FUSED_CROSS_CHUNK = 10, 200, 100, 20
TOL_FUSED_RECORD, TOL_FUSED_POINTS, TOL_FUSED_RHO = 1e-6, 1e-7, 1e-6
#: phase 23: the tuned initial walk and a surrogate re-selection walk of the
#: SAC whole run at N = WALK_N, eager against graphed in turns on one key;
#: the graphed walk's host launches must stay below WALK_LAUNCH_SHARE of the
#: eager walk's
WALK_N, WALK_SEED, WALK_LAUNCH_SHARE = 1024, 9, 0.01
#: phase 24: the JAX package's DVR populations of the reference band's rows
PARITY_TABLE = Path(__file__).resolve().parent / "gple_tpu_torch" / "data" / "parity_dvr.json"
#: runtime / driver calls that launch device work from the host
HOST_LAUNCHES = ("LaunchKernel", "GraphLaunch", "MemcpyAsync", "MemsetAsync")
FORWARD = ("rbf_gram", "rbf_predict_mean")
LENGTH_VJPS = ("rbf_gram_vjp", "rbf_predict_vjp")
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


#: the latency floor (``kernel_bench.floor_us``), measured once a run
_FLOOR: dict = {}


def latency_floor() -> dict:
    """An empty kernel's us a launch by both timers, measured at the first call."""
    from gple_tpu_torch.ops import kernel_bench as KB

    if not _FLOOR:
        _FLOOR.update(KB.floor_us())
        log("latency floor (an empty kernel, 1 x 32): " + json.dumps(_FLOOR))
    return _FLOOR


def _points_case(lib, rng, dev, case):
    """One ``rbf_gram_vjp_points`` shape: the pair wrapper on a contiguous, a
    transposed, a stride-0-batch and an odd-row-stride cotangent, each for
    both point sets and for each alone (the other output None), twice (bit
    for bit), against the pair's plain counterpart
    (``gram_vjp_points_pair_plain``: two plain calls, the second on the
    transposed cotangent); the bare pair call timed by both timers beside
    the latency floor and the bound, the plain pair timed."""
    from gple_tpu_torch.ops import gram_kernels as GK
    from gple_tpu_torch.ops import kernel_bench as KB

    l, xa, xb, gw = KB.points_operands(rng, case, dev)
    gt = torch.tensor(rng.normal(size=(case.batch, case.nb, case.na)), dtype=case.dtype,
                      device=dev).transpose(1, 2)
    g0 = torch.tensor(rng.normal(size=(1, case.na, case.nb)), dtype=case.dtype,
                      device=dev).expand(case.batch, -1, -1)
    gs = torch.tensor(rng.normal(size=(case.batch, case.na, case.nb + 1)), dtype=case.dtype,
                      device=dev)[:, :, :case.nb]
    reads, err = {}, 0.0
    for name, g in (("contiguous", gw), ("transposed", gt), ("stride-0 batch", g0),
                    ("odd row stride", gs)):
        ref = GK.gram_vjp_points_pair_plain(l, xa, xb, g)
        rel, repeat = 0.0, True
        for sides in ((True, True), (True, False), (False, True)):
            out = GK.gram_vjp_points_cuda(l, xa, xb, g, *sides)
            again = GK.gram_vjp_points_cuda(l, xa, xb, g, *sides)
            torch.cuda.synchronize()
            for o, a, r, want in zip(out, again, ref, sides):
                if (o is None) == want:
                    raise AssertionError(f"rbf_gram_vjp_points {case.shape} {name}: sides "
                                         f"{sides} returned {[x is None for x in out]}")
                if want:
                    err = max(err, (o - r).abs().max().item())
                    rel = max(rel, _rel(o.cpu(), r.cpu()))
                    repeat = repeat and bool(torch.equal(o, a))
        reads[name] = dict(rel_err=rel, bitwise_repeat=repeat, strides=list(g.stride()),
                           read_a=GK.points_vjp_read(g.stride(), "a"),
                           read_b=GK.points_vjp_read(g.stride(), "b"))
    del gt, g0, gs
    outs = [torch.empty_like(x) for x in (xa, xb)]
    ms = KB.device_ms(KB.raw_points_vjp(lib, l, xa, xb, gw, *outs))
    graph_ms = KB.graph_us(lambda: KB.raw_points_vjp(lib, l, xa, xb, gw, *outs)) / 1e3
    plain_ms = KB.device_ms(lambda: GK.gram_vjp_points_pair_plain(l, xa, xb, gw), launches=3,
                            min_ms=0, repeats=3)
    bound, by = KB.gram_vjp_points_bound(case.batch, case.na, case.nb, 2, case.dtype.itemsize)
    floor = latency_floor()
    plan = GK.points_plan(case.batch, case.na, case.nb, True, True, GK._sm_count(dev))
    return dict(kernel=case.kernel, shape=case.shape, key=case.key, what=case.what,
                per_step=0, per_tick=0, plan=list(plan), max_abs_err=err,
                rel_err=max(r["rel_err"] for r in reads.values()), tol=TOL_VJP, reads=reads,
                bitwise_repeat=all(r["bitwise_repeat"] for r in reads.values()), ms=ms,
                graph_ms=graph_ms, plain_ms=plain_ms, bound_us=bound * 1e3, bound_by=by,
                share=bound / ms, graph_share=bound / graph_ms,
                floor_graph_us=floor["graph_us"], floor_bare_us=floor["bare_us"],
                graph_over_floor=graph_ms * 1e3 / floor["graph_us"])


def _vjp_case(lib, rng, dev, case):
    """One length-cotangent shape: the wrapper twice and the plain version on
    the same inputs (``rbf_gram_vjp`` also on a transposed, a stride-0-batch
    and an odd-row-stride cotangent), then the bare launch timed by both
    timers (``graph_ms``: replays of a CUDA graph of launches, without the
    host's cost of a launch) and the plain version timed."""
    from gple_tpu_torch.ops import gram_kernels as GK
    from gple_tpu_torch.ops import kernel_bench as KB

    if isinstance(case, KB.PointsVjpCase):
        return _points_case(lib, rng, dev, case)
    l = KB.lengths_like(rng, case.batch, dev, case.dtype)
    xa = KB.cloud(rng, case.batch, case.na, dev, case.dtype)
    xb = KB.cloud(rng, case.batch, case.nb, dev, case.dtype)
    gw, alpha = KB.vjp_operands(rng, case, dev)
    bound, by = KB.vjp_bound(case)
    reads = {}
    if case.c == 0:
        def vjp(g):
            return GK.gram_vjp_cuda(l, xa, xb, g)

        def plain(g=gw):
            return GK.gram_vjp_plain(l, xa, xb, g)

        gt = torch.tensor(rng.normal(size=(case.batch, case.nb, case.na)), dtype=case.dtype,
                          device=dev).transpose(1, 2)
        g0 = torch.tensor(rng.normal(size=(1, case.na, case.nb)), dtype=case.dtype,
                          device=dev).expand(case.batch, -1, -1)
        # an odd row stride: the kernel's strided branch
        gs = torch.tensor(rng.normal(size=(case.batch, case.na, case.nb + 1)),
                          dtype=case.dtype, device=dev)[:, :, :case.nb]
        for name, g in (("transposed", gt), ("stride-0 batch", g0), ("odd row stride", gs)):
            out_g, again_g = vjp(g), vjp(g)
            reads[name] = dict(rel_err=_rel(out_g.cpu(), plain(g).cpu()),
                               bitwise_repeat=bool(torch.equal(out_g, again_g)),
                               read=GK.gram_vjp_read(g))
        del gt, g0, gs
    else:
        def vjp(g):
            return GK.predict_vjp_cuda(l, xa, xb, alpha, g)

        def plain(g=gw):
            return GK.predict_vjp_plain(l, xa, xb, alpha, g)
    out, again = vjp(gw), vjp(gw)
    ref = plain()
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    rel = max([err / ref.abs().max().item()] + [r["rel_err"] for r in reads.values()])
    repeat = bool(torch.equal(out, again)) and all(r["bitwise_repeat"] for r in reads.values())
    ms = KB.device_ms(KB.raw_vjp(lib, l, xa, xb, gw, torch.empty_like(out), alpha))
    graph_ms = KB.graph_us(lambda: KB.raw_vjp(lib, l, xa, xb, gw, torch.empty_like(out),
                                              alpha)) / 1e3
    plain_ms = KB.device_ms(plain, launches=3, min_ms=0, repeats=3)
    plan = GK.vjp_plan(case.batch, case.na, case.nb, GK._sm_count(dev))
    return dict(kernel=case.kernel, shape=case.shape, key=case.key, what=case.what,
                per_step=0, per_tick=0, plan=list(plan), max_abs_err=err, rel_err=rel,
                tol=TOL_VJP, other_reads=reads, bitwise_repeat=repeat, ms=ms,
                graph_ms=graph_ms, plain_ms=plain_ms, bound_us=bound * 1e3, bound_by=by,
                share=bound / ms, graph_share=bound / graph_ms)


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
    from gple_tpu_torch.ops import graphs as GR
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

    # the ticks as replays of one captured graph of _tick_core
    state = GR.clone((density, extra, gps))
    params = GR.clone((gps.diag.params, gps.offdiag.params))
    small = torch.zeros(3, dtype=torch.bool, device="cuda")

    def tick_fn():
        d, e, sm, g = driver._tick_core(MODEL, MASS, DT, *state, *params,
                                        driver.gp_dist_all_nocut, "none", 0, 2.0, True)
        GR.copy_((state, small), ((d, e, g), sm))

    graph = GR.Graph(tick_fn, (state, params, small), "tick")
    tick_s = []
    smalls = []
    with spans.collect() as totals:
        for _ in range(TICKS):
            t0 = time.perf_counter()
            graph()
            torch.cuda.synchronize()
            tick_s.append(time.perf_counter() - t0)
            smalls.append(small.tolist())
    launches = dict(GK.LAUNCHES)
    density, extra, gps = state
    pop1 = gps.population().item()

    log(f"slice N={N_SLICE}: s/step {s_step!r} (mean of {TIMED_STEPS} after "
        f"{WARMUP_STEPS} warm-up, host clock around synchronize)")
    log(f"slice N={N_SLICE}: s/tick {sum(tick_s[1:]) / (len(tick_s) - 1)!r} graph replays "
        f"(each: {tick_s!r}; the first captures, {totals.seconds('capture')!r} s, pool "
        f"{graph.pool_bytes / 2**20:.1f} MiB)")
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


#: the initialization's spans, the children of a run's ``init``
INIT_SPANS = ("mc_select", "extra", "optimize", "refit")


def _init_phases(drv) -> dict:
    """Wall seconds of the driver's initialization phases (its spans)."""
    return {name: drv.totals.seconds(name) for name in INIT_SPANS}


def _graphs(totals) -> dict:
    """The CUDA graphs captured and replayed in a collection of spans, and
    the walls of the captures and of the replays' launches."""
    return dict(captures=totals.calls("capture"), replays=totals.calls("launch"),
                capture_s=totals.seconds("capture"), launch_s=totals.seconds("launch"))


def _span_summary(timeline) -> dict:
    """A run's timeline (``GPLEDriver.spans``): its spans' count and their
    seconds by name less their children's."""
    if timeline is None:
        return {}
    return dict(records=len(timeline.records), self_s=timeline.self_seconds())


def _check_graphs(phase: str, totals) -> dict:
    """The CUDA graphs captured and replayed in ``totals`` (a driver's, or a
    collection's): the ticks of a phase that runs the driver went through
    the tick graph."""
    counts = _graphs(totals)
    log(f"{phase} graphs: {json.dumps(counts)}")
    if not counts["replays"] > 0:
        raise AssertionError(f"{phase}: no CUDA graph was replayed")
    return counts


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
    walls = dict(run_s=wall, init_s=init_s, init_phases=_init_phases(drv),
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
    _check_graphs("trajectory", drv.totals)
    return launches, by_shape, per, walls


def crossing_phase():
    """The crossing trajectory on the card against the exact DVR populations,
    computed by the port's DVR oracle on the card and held to the committed
    table."""
    from gple_tpu_torch.driver import GPLEDriver
    from gple_tpu_torch.entry import crossing_config, crossing_dvr_config
    from gple_tpu_torch.oracles import DVRSolver
    from gple_tpu_torch.ops import gram_kernels as GK

    with open(DVR_TABLE) as f:
        table = json.load(f)
    t0 = time.perf_counter()
    dvr = DVRSolver(crossing_dvr_config(), "cuda").run(store_wigner=False)
    dvr_s = time.perf_counter() - t0
    table_err = float(np.max(np.abs(dvr.populations - np.array(table["populations"]))))
    log(f"crossing: the port's DVR on the card in {dvr_s!r} s, {len(dvr.times)} outputs, "
        f"max |populations - table| {table_err!r}")
    if not (np.array_equal(dvr.times, table["times"]) and table_err <= TOL_DVR_TABLE):
        raise AssertionError(f"crossing: the port's DVR differs from the table: {table_err}")
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
    sp0 = np.interp(gt, dvr.times, dvr.populations[:, 0])
    rmse = float(np.sqrt(np.mean((gp0 - sp0) ** 2)))
    pop_dev = float(np.max(np.abs([r.population_mci.sum() - 1.0 for r in hist])))
    result = dict(run_s=wall, ticks=CROSS_TICKS, records=len(hist), rmse_vs_dvr=rmse,
                  final_population_mci=hist[-1].population_mci.tolist(),
                  max_population_deviation=pop_dev, stats=drv.stats,
                  active=drv.density.active.tolist(), phase_times=drv.phase_times,
                  chains=_chains_info(drv._chains), graphs=_graphs(drv.totals),
                  init_phases=_init_phases(drv))
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
    _check_graphs("crossing", drv.totals)
    return launches, by_shape, result


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
    reads = dict(GK.GRAM_VJP_READS)
    stages = [dict(tag=st["tag"], seconds=st["seconds"], error=st["error"],
                   averages=st["averages"].tolist(), check=st["check"].tolist(),
                   zoom=_zoom_summary(st["zoom"]),
                   launches={f"{k[0]} {k[1]}": v for k, v in counts.items()})
              for st, counts in zip(optimizer.stages, stage_launches.records)]
    fan = _first_stage(optimizer, density, extra, energies, "fan")
    trace = ladder_trace(optimizer, density, extra, energies, stages[0]["seconds"])
    result = dict(n=LADDER_N, lbfgs_steps=LADDER_STEPS, line_search=optimizer.line_search,
                  wall_s=wall, accepted=res.opt_type,
                  error=res.error, stages=stages, targets=[1.0, e0, 1.0],
                  diag_lengths=optimizer.diag_lengths.tolist(),
                  off_params=optimizer.off_params.tolist(),
                  al_lam=optimizer._al_lam.tolist(), launches=launches,
                  gram_vjp_reads=reads, fan_first_stage=fan)
    log("ladder: " + json.dumps(result))
    log("ladder traced first stage: " + json.dumps(trace))
    if not np.isfinite(fan["error"]):
        raise AssertionError(f"ladder: the fan's stage {fan}")
    if not np.isfinite(res.error) or res.opt_type not in ("local_previous", "local_initial",
                                                          "global"):
        raise AssertionError(f"ladder: result {res}")
    if not all(np.all(np.isfinite(st["averages"])) for st in stages):
        raise AssertionError("ladder: non-finite averages")
    _check_path_launches("ladder", launches, FORWARD + LENGTH_VJPS)
    return launches, by_shape, result


def _zoom_summary(counts) -> dict:
    """The zoom's counts of a stage with its host pulls per L-BFGS iteration."""
    its = max(counts["iterations"], 1)
    return dict(counts, evaluations_per_iteration=counts["evaluations"] / its,
                syncs_per_iteration=counts["syncs"] / its)


def _first_stage(optimizer, density, extra, energies, line_search) -> dict:
    """The ladder's first stage (a fresh optimizer's ``local_previous``: the
    initial parameters, zero multipliers) once more with ``line_search``:
    the fixed fan for its wall beside the zoom's, or the zoom inside a
    trace."""
    from gple_tpu_torch.gp import opt as O

    with torch.inference_mode(False), torch.enable_grad():
        data, active = optimizer._pack_data(density, extra, energies)
        data = {k: v.clone() for k, v in data.items()}
        host = {k: data[k].cpu().numpy() for k in ("dlb", "dub", "olb", "oub")}
        f64 = dict(dtype=torch.float64, device=density.points.device)
        start_diag = np.clip(np.tile(optimizer.sigma_r0, (2, 1)), host["dlb"], host["dub"])
        start_off = np.clip(optimizer._initial_off(), host["olb"], host["oub"])
        _sync(density.points.device.type)
        t0 = time.perf_counter()
        out = O._run_stage(torch.tensor(start_diag, **f64), torch.tensor(start_off, **f64),
                           torch.zeros((2, 3), **f64), data, bool(active[1]),
                           optimizer.lbfgs_steps, O.AL_OUTER, line_search)
        err = float(out[2])
        return dict(line_search=line_search, seconds=time.perf_counter() - t0, error=err,
                    averages=out[3].cpu().numpy().tolist())


#: device kernels of the hand-written kernels in a trace, by wrapper; the
#: length cotangents share one template, told apart by its rank argument C
_KERNEL_PATTERNS = (("rbf_gram_vjp", r"rbf_vjp_kernel<[^,]+, *\d+, *0\b"),
                    ("rbf_predict_vjp", r"rbf_vjp_kernel<[^,]+, *\d+, *[12]\b"),
                    ("rbf_gram_vjp_points", r"rbf_gram_vjp_points_kernel"),
                    ("rbf_gram", r"rbf_gram_kernel"),
                    ("rbf_predict_mean", r"rbf_predict_(partial|reduce)_kernel"))
#: the first design's two kernels of a length cotangent: no call may launch them
_TWO_KERNEL_VJP = ("rbf_vjp_partial_kernel", "rbf_vjp_reduce_kernel")


def device_trace(run, untraced_s: float, device: str = "cuda"):
    """``run()`` once more inside ``torch.profiler``, recording the device's
    activity only (the CUDA runtime's calls and the device's operations:
    recording every host op too more than doubles a zoom stage's wall).
    Returns ``run``'s result and, from the profiler's events (not a chrome
    export: a ladder stage is ~10^6 events), the traced wall, the
    device-busy share of the traced window and of the untraced wall
    (``untraced_s``), device time by family with each hand-written kernel
    apart, the device kernels of each wrapper against its launches, and the
    zoom's iterations, loss evaluations and host pulls in the window."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from gple_tpu_torch.gp import opt as O
    from gple_tpu_torch.ops import gram_kernels as GK

    activities = [ProfilerActivity.CUDA if device == "cuda" else ProfilerActivity.CPU]
    launch0 = dict(GK.LAUNCHES)
    _sync(device)
    with spans.collect() as totals, profile(activities=activities) as prof:
        t0 = time.perf_counter()
        out = run()
        _sync(device)
        traced_s = time.perf_counter() - t0
    zoom = _zoom_summary({k: totals.count("zoom." + k) for k in O.ZOOM_COUNTERS})
    calls = {k: GK.LAUNCHES[k] - launch0[k] for k in GK.LAUNCHES}
    t0 = time.perf_counter()
    events = prof.profiler.kineto_results.events()
    first = min(e.start_ns() for e in events)
    window = max(e.end_ns() for e in events) - first
    device_events = [e for e in events if e.device_type() != torch.autograd.DeviceType.CPU]
    families, kernels = {}, {name: 0 for name, _ in _KERNEL_PATTERNS}
    for e in device_events:
        name, ns = e.name(), e.end_ns() - e.start_ns()
        family = next((k for k, pattern in _KERNEL_PATTERNS if re.search(pattern, name)), None)
        if family is not None:
            kernels[family] += 1
        else:
            family = next((f for f, keys in DEVICE_FAMILIES if any(k in name for k in keys)),
                          "other")
        calls_ns = families.get(family, (0, 0))
        families[family] = (calls_ns[0] + 1, calls_ns[1] + ns)
    busy = _busy((e.start_ns(), e.end_ns()) for e in device_events)
    two_kernel = sorted({e.name()[:80] for e in device_events
                         if any(k in e.name() for k in _TWO_KERNEL_VJP)})
    return out, dict(
        traced_s=traced_s, untraced_s=untraced_s, zoom=zoom,
        window_ms=window / 1e6, device_busy_ms=busy / 1e6,
        device_busy_share=busy / window if window else 0.0,
        busy_share_of_untraced=busy / 1e9 / untraced_s, device_ops=len(device_events),
        host_ops=len(events) - len(device_events),
        families={f: dict(calls=c, ms=ns / 1e6, share_of_busy=ns / busy if busy else 0.0)
                  for f, (c, ns) in sorted(families.items(), key=lambda kv: -kv[1][1])},
        device_kernels=kernels, launches=calls, two_kernel_names=two_kernel,
        parse_s=time.perf_counter() - t0)


def ladder_trace(optimizer, density, extra, energies, untraced_s: float,
                 device: str = "cuda") -> dict:
    """Phase 10's trace (``device_trace``): the ladder's first zoom stage once
    more; each length cotangent must run one device kernel a call, and no
    kernel of the two-kernel design."""
    stage, result = device_trace(
        lambda: _first_stage(optimizer, density, extra, energies, "zoom"), untraced_s, device)
    result["error"] = stage["error"]
    calls, kernels = result["launches"], result["device_kernels"]
    if device == "cuda":
        for name in LENGTH_VJPS:
            if not calls[name] or kernels[name] != calls[name]:
                raise AssertionError(f"ladder trace: {calls[name]} {name} calls ran "
                                     f"{kernels[name]} device kernels")
        if result["two_kernel_names"]:
            raise AssertionError(f"ladder trace: two-kernel cotangents "
                                 f"{result['two_kernel_names']}")
    return result


def validation_trace(coords, values, da, untraced_s: float, device: str = "cuda") -> dict:
    """Phase 14's trace (``device_trace``): one full-ARD ``screenshot_fit``
    (the zoom) once more.  Each gradient evaluation backs through two Grams
    (the fit's and the NLL's), each Gram's backward must be one
    ``rbf_gram_vjp_points`` call for both point sets (``z = W x``), and each
    call one device kernel: 2 launches an evaluation, where the one-sided
    kernel took 4 (one a point set)."""
    from gple_tpu_torch import validation as V
    from gple_tpu_torch.ops import gram_kernels as GK
    from gple_tpu_torch.sampler.keys import RandomKeys

    reads0 = dict(GK.POINTS_VJP_READS)
    fit, result = device_trace(
        lambda: V.screenshot_fit(RandomKeys(0, "cpu"), coords, values, da, full_ard=True,
                                 device=device), untraced_s, device)
    reads = {k: v - reads0.get(k, 0) for k, v in GK.POINTS_VJP_READS.items()}
    calls, evals = result["launches"]["rbf_gram_vjp_points"], result["zoom"]["evaluations"]
    one_sided = sum(len(sides) * n for (_, sides), n in reads.items())
    result.update(mse=fit.mse, points_launches_per_evaluation=calls / max(evals, 1),
                  one_sided_launches_per_evaluation=one_sided / max(evals, 1),
                  points_reads={f"strides {list(st)} sides {sides}": n
                                for (st, sides), n in reads.items() if n})
    if device == "cuda":
        kernels = result["device_kernels"]["rbf_gram_vjp_points"]
        if not (calls and kernels == calls and calls == 2 * evals and one_sided == 2 * calls):
            raise AssertionError(f"validation trace: {evals} evaluations made {calls} "
                                 f"rbf_gram_vjp_points calls, {kernels} device kernels, "
                                 f"{one_sided} one-sided launches")
    return result


def zoom_agreement_phase():
    """Phase 10c: the ladder's first zoom L-BFGS solve (the elementwise fit
    of the diagonal lengths, to its convergence test) at N = 256 on the card
    against the same solve on the CPU: the final iterate, relative.  (A solve
    of the coherence's parameters walks a flat valley towards its bounds,
    where rounding-level differences of the loss move the end point: not a
    comparison of the two devices.)"""
    from gple_tpu_torch.entry import SIGMA
    from gple_tpu_torch.gp import opt as O

    outs = {}
    for dev in ("cuda", "cpu"):
        density, extra, energies, e0 = _ladder_problem(LADDER_AGREE_N, dev)
        optimizer = O.Optimizer(model=MODEL, mass=MASS, total_energy=e0, purity=1.0,
                                sigma_r0=np.asarray(SIGMA), opt_mode="ladder", device=dev)
        with torch.inference_mode(False), torch.enable_grad():
            data, _ = optimizer._pack_data(density, extra, energies)
            data = {k: v.clone() for k, v in data.items()}
            dlb, dub = data["dlb"], data["dub"]
            z0 = O._bounds_to_sigmoid(torch.tensor(np.tile(SIGMA, (2, 1)), device=dev),
                                      dlb, dub)

            def loss(z):
                return O._diag_loss(O._sigmoid_to_bounds(z, dlb, dub), data)

            with spans.collect() as totals:
                t0 = time.perf_counter()
                z = O._lbfgs_zoom(loss, z0, LADDER_STEPS)
                z_host = z.detach().cpu()
            outs[dev] = (z_host, time.perf_counter() - t0,
                         {k: totals.count("zoom." + k) for k in O.ZOOM_COUNTERS})
    err = _rel(outs["cuda"][0].numpy(), outs["cpu"][0].numpy())
    moved = float((outs["cuda"][0] - z0.cpu()).abs().max())
    log(f"zoom agreement N={LADDER_AGREE_N}: final z card vs CPU (relative) {err!r}; "
        f"moved {moved!r}; card {outs['cuda'][1]!r} s {json.dumps(outs['cuda'][2])}; "
        f"CPU {outs['cpu'][1]!r} s {json.dumps(outs['cpu'][2])}")
    if not (err <= TOL_ZOOM_AGREE and moved > 1e-6):
        raise AssertionError(f"zoom: the card's solve disagrees with the CPU's ({err}) "
                             f"or did not move ({moved})")


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
        reads = dict(GK.GRAM_VJP_READS)

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
    walls.update(init_phases=_init_phases(drv), phase_times=drv.phase_times,
                 stages=[dict(tag=st["tag"], seconds=st["seconds"], check=st["check"].tolist(),
                              zoom=_zoom_summary(st["zoom"]))
                         for st in drv.optimizer.stages],
                 line_search=drv.optimizer.line_search,
                 resumed=_walls(rcalls, rwall, RP_TICKS - RP_CHECKPOINT),
                 populations=pop.tolist(), resumed_populations=rpop.tolist(),
                 resume_max_abs_diff=float(np.max(np.abs(pop - rpop))),
                 opt_types=[rec.opt_type for rec in hist],
                 resumed_opt_types=[rec.opt_type for rec in rhist])
    log(f"reference parity N={TRAJ_N}, {RP_TICKS} ticks: " + json.dumps(walls))
    log(f"reference parity launches: {json.dumps(launches)}; rbf_gram_vjp cotangent "
        f"reads: {json.dumps(reads)}")
    if len(hist) != RP_TICKS // cfg.output_freq + 1 or len(rhist) != 1:
        raise AssertionError(f"reference parity: {len(hist)} / {len(rhist)} records")
    _check_records("reference parity", hist + rhist, drv.total_energy)
    if not walls["resume_max_abs_diff"] <= TOL_RESUME:
        raise AssertionError(f"reference parity: the resumed populations {rpop} differ from "
                             f"the straight run's {pop}")
    _check_path_launches("reference parity", launches, FORWARD + LENGTH_VJPS)
    return launches, by_shape, resume_by_shape, walls


def new_shapes_phase(what: str, known, *by_shapes, extra=()):
    """Phases 8, 12 and 15: phase 3's checks and times at every (kernel,
    shape) that the ``what`` phases launched (``by_shapes``, their
    ``LAUNCHES_BY_SHAPE``) and no earlier phase checked (``known``), and at
    the backward cases ``extra`` that neither covers."""
    import gc

    from gple_tpu_torch.ops import kernel_bench as KB

    # the plain versions need room: free what the phases before left to the
    # collector (their drivers' graph pools among it)
    gc.collect()
    torch.cuda.empty_cache()
    keys = set().union(*by_shapes)
    grams, predicts, vjps = KB.cases_from_launches(keys, what, known=known)
    seen = set(known) | {c.key for c in vjps}
    vjps += tuple(c for c in extra if c.key not in seen)
    cases = kernel_phase(grams, predicts, vjps)
    log(f"{what} kernel phase: {len(cases)} new (kernel, shape) cases")
    return cases


def _timed(cls, name, calls):
    """Wrap ``cls.name`` so each call records (seconds after a synchronize,
    the instance, the arguments, the result) in ``calls[name]``; returns the
    undo."""
    inner = getattr(cls, name)

    def wrapped(self, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(self, *args, **kw)
        torch.cuda.synchronize()
        calls.setdefault(name, []).append((time.perf_counter() - t0, self, args, out))
        return out

    setattr(cls, name, wrapped)
    return lambda: setattr(cls, name, inner)


def _write_input(path, cfg):
    """The reference's 8-field input file of a ``GPLEConfig``."""
    fields = (("mass", cfg.mass), ("x0", cfg.x0), ("p0", cfg.p0), ("sigma p0", cfg.sigma_p0),
              ("output time", cfg.output_time), ("reoptimization time", cfg.reopt_time),
              ("dt", cfg.dt), ("number of points", cfg.num_points))
    Path(path).write_text("".join(f"{name}\n{value}\n" for name, value in fields))


def _rel(ours, theirs) -> float:
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    return float(np.abs(ours - theirs).max() / np.abs(theirs).max())


#: outputs of the production DVR that phase 14 fits: the initial packet, the
#: packet at <x> = -4 before the crossing (t = 400), sheared in phase space by
#: its free flight (a tilted Wigner function), and the run's last output after
#: the crossing (t = 980), where the fixed fan could not leave its start
TILT_FRAME, POST_FRAME = 40, -1
SHOT_FRAMES = (0, TILT_FRAME, POST_FRAME)
#: points of each evolve_fit snapshot (tests/test_validation.py:66)
EVOLVE_POINTS = 150
#: tests/test_validation.py's DVR physics (n = 385; the Liouville grid n = 97)
VALIDATION_PHYSICS = dict(model=MODEL, mass=MASS, x0=-4.0, p0=20.0, sigma_p=1.0, xmin=-6.0,
                          xmax=6.0, dx_input=1.0, output_time=250.0, dt_input=1.0)


def oracles_phase():
    """Phase 13: the ``se`` CLI and the Liouville solver at the production
    input on the card, the Wigner frames of phase 14's snapshots, and both
    oracles on the validation physics on the card against the CPU."""
    from gple_tpu_torch import cli
    from gple_tpu_torch.entry import trajectory_config
    from gple_tpu_torch.ops import kernel_bench as KB
    from gple_tpu_torch.oracles import liouville as L
    from gple_tpu_torch.oracles import schrodinger as S

    cfg = trajectory_config(TRAJ_N)
    calls = {}
    undo = [_timed(S.DVRSolver, name, calls) for name in ("__init__", "_strang_steps", "run")]
    try:
        with tempfile.TemporaryDirectory() as tmp:
            _write_input(f"{tmp}/input", cfg)
            t0 = time.perf_counter()
            rc = cli.main(["se", "--input", f"{tmp}/input", "--outdir", f"{tmp}/se",
                           "--model", MODEL, "--boundary", "absorbing", "--no-wigner"])
            torch.cuda.synchronize()
            se_wall = time.perf_counter() - t0
            averages = np.loadtxt(f"{tmp}/se/averages.txt", ndmin=2)
            psi_rows = np.loadtxt(f"{tmp}/se/psi.txt", ndmin=2).shape
    finally:
        for u in undo:
            u()
    if rc != 0:
        raise AssertionError(f"oracles: se exited with {rc}")
    init_s, solver = calls["__init__"][0][0], calls["__init__"][0][1]
    strang_s = sum(c[0] for c in calls["_strang_steps"])
    strang_steps = sum(c[2][1] for c in calls["_strang_steps"])
    res = calls["run"][0][3]
    norm, energy = averages[:, 4] + averages[:, 5], averages[:, 1]
    se = dict(n=solver.cfg.n_grids, h_dim=2 * solver.cfg.n_grids, dt=solver.cfg.dt,
              wall_s=se_wall, h_eigh_s=init_s, strang_steps=strang_steps,
              strang_us_per_step=strang_s / strang_steps * 1e6, outputs=len(res.times),
              final_x=float(res.averages[-1, 1]), final_populations=res.populations[-1].tolist(),
              max_norm_dev=float(np.max(np.abs(norm - 1.0))),
              max_energy_rel_dev=float(np.max(np.abs(energy / energy[0] - 1.0))),
              psi_txt_shape=list(psi_rows))
    log("oracles: se at the production input: " + json.dumps(se))
    if se["max_norm_dev"] > TOL_CONSERVED or se["max_energy_rel_dev"] > TOL_CONSERVED:
        raise AssertionError(f"oracles: se does not conserve norm or energy: {se}")
    if not (se["final_x"] > 0.0 and averages.shape[0] == len(res.times)):
        raise AssertionError(f"oracles: se did not reach a stop condition past x = 0: {se}")

    # the Wigner frames of phase 14's snapshots at n = 1295, the last one
    # timed and held against the same transform on the CPU
    c = solver.cfg
    shots = {}
    for i in SHOT_FRAMES:
        psi = torch.tensor(res.psis[i], device="cuda")
        frame = S.wigner_transform(psi, c.x_grid, c.p_grid, c.dx, c.boundary)
        shots[i] = frame[0, 0].real.cpu().numpy()
    wigner_ms = KB.device_ms(lambda: S.wigner_transform(psi, c.x_grid, c.p_grid, c.dx,
                                                        c.boundary), launches=5, min_ms=0,
                             repeats=3)
    t0 = time.perf_counter()
    cpu_frame = S.wigner_transform(psi.cpu(), c.x_grid, c.p_grid, c.dx, c.boundary)
    wigner_cpu_s = time.perf_counter() - t0
    frame_h = frame.cpu().numpy()
    wig = dict(n=c.n_grids, time=float(res.times[SHOT_FRAMES[-1]]), ms=wigner_ms,
               cpu_s=wigner_cpu_s,
               gflop=8.0 * 4 * c.n_grids * (2 * c.n_grids - 1) * c.n_grids / 1e9,
               rel_err_vs_cpu=_rel(frame_h, cpu_frame.numpy()),
               hermitian_dev=_rel(frame_h[0, 1], np.conj(frame_h[1, 0])))
    log("oracles: one Wigner frame: " + json.dumps(wig))
    if not (wig["rel_err_vs_cpu"] <= TOL_WIGNER_CPU and wig["hermitian_dev"] <= 1e-12):
        raise AssertionError(f"oracles: Wigner frame {wig}")
    del solver, calls, psi, frame

    # the Liouville oracle at the production input
    lcfg = L.LiouvilleConfig(model=MODEL, mass=cfg.mass, x0=cfg.x0, p0=cfg.p0,
                             sigma_p=cfg.sigma_p0, xmin=cfg.xmin, xmax=cfg.xmax, dx_input=1.0,
                             output_time=cfg.output_time, dt_input=cfg.dt)
    lcalls = {}
    undo = _timed(L.LiouvilleSolver, "_step", lcalls)
    try:
        t0 = time.perf_counter()
        lres = L.LiouvilleSolver(lcfg, "cuda").run(store_rho=False, max_outputs=LE_OUTPUTS)
        torch.cuda.synchronize()
        le_wall = time.perf_counter() - t0
    finally:
        undo()
    rho = lcalls["_step"][-1][3]
    steps = sum(call[2][1] for call in lcalls["_step"])
    le = dict(n=lcfg.n_grids, dt=lcfg.dt, outputs=len(lres.times), steps=steps, wall_s=le_wall,
              us_per_step=sum(call[0] for call in lcalls["_step"]) / steps * 1e6,
              max_norm_dev=float(np.max(np.abs(lres.populations.sum(axis=1) - 1.0))),
              hermitian_dev=float((rho - rho.transpose(-1, -2).conj()).abs().max()),
              final_populations=lres.populations[-1].tolist())
    # where a Trotter step's time goes (a step is 2 quantum, 2 position and
    # 1 momentum substeps): each substep and its parts back to back on the
    # step's last rho, ms a call by CUDA events
    ls, dt = L.LiouvilleSolver(lcfg, "cuda"), lcfg.dt
    parts = {"quantum": lambda: ls.quantum_liouville(rho, dt / 2.0),
             "position": lambda: ls.classical_position(rho, dt / 2.0),
             "momentum": lambda: ls.classical_momentum(rho, dt),
             "fft_x": lambda: torch.fft.fft(rho, dim=0),
             "fft_p": lambda: torch.fft.fft(rho, dim=1),
             "hermitize": lambda: L._hermitize(rho),
             "basis_change": lambda: ls.to_adiabatic(rho)}
    le["part_ms"] = {k: KB.device_ms(f, launches=20, min_ms=0, repeats=3)
                     for k, f in parts.items()}
    log("oracles: le at the production input: " + json.dumps(le))
    if le["outputs"] != LE_OUTPUTS or le["max_norm_dev"] > TOL_CONSERVED or \
            le["hermitian_dev"] > 1e-12:
        raise AssertionError(f"oracles: le {le}")
    del rho, lcalls, ls

    # both oracles on the validation physics: the card's runs against each
    # other, and against the CPU's (the DVR run whole; the Liouville rho after
    # its first LE_CPU_STEPS Trotter steps, with its populations and
    # averages).  The CPU on one intra-op thread: thousands of small tensor
    # ops run faster so.
    runs, threads = {}, torch.get_num_threads()
    try:
        for dev in ("cuda", "cpu"):
            torch.set_num_threads(1 if dev == "cpu" else threads)
            t0 = time.perf_counter()
            dvr = S.DVRSolver(S.DVRConfig(boundary="reflective", **VALIDATION_PHYSICS),
                              dev).run(store_wigner=True, max_outputs=3)
            t1 = time.perf_counter()
            ls = L.LiouvilleSolver(L.LiouvilleConfig(**VALIDATION_PHYSICS), dev)
            rho = ls.to_adiabatic(ls._step(ls.to_diabatic(ls.initial_density()), LE_CPU_STEPS))
            seen = (rho.cpu().numpy(), ls.populations(rho).cpu().numpy(),
                    torch.stack(ls.averages(rho)).cpu().numpy())
            t2 = time.perf_counter()
            liou = ls.run(store_rho=False, max_outputs=2) if dev == "cuda" else None
            runs[dev] = (dvr, seen, liou, t1 - t0, t2 - t1, time.perf_counter() - t2)
    finally:
        torch.set_num_threads(threads)
    (dg, sg, lg, *cuda_s), (dc, sc, _, *cpu_s) = runs["cuda"], runs["cpu"]
    n = min(len(dg.times), len(lg.times))
    agree = dict(dvr_n=dg.cfg.n_grids, le_n=lg.cfg.n_grids, le_cpu_steps=LE_CPU_STEPS,
                 le_run_steps=int(lg.times[-1] / lg.cfg.dt), cuda_s=cuda_s, cpu_s=cpu_s[:2],
                 rel_err={"dvr_psis": _rel(dg.psis, dc.psis),
                          "dvr_populations": _rel(dg.populations, dc.populations),
                          "dvr_averages": _rel(dg.averages, dc.averages),
                          "dvr_wigners": _rel(dg.wigners, dc.wigners),
                          "le_rho": _rel(sg[0], sc[0]),
                          "le_populations": _rel(sg[1], sc[1]),
                          "le_averages": _rel(sg[2], sc[2])},
                 dvr_vs_le=float(np.max(np.abs(dg.populations[:n] - lg.populations[:n]))))
    log("oracles: validation physics, card against CPU: " + json.dumps(agree))
    bad = {k: v for k, v in agree["rel_err"].items() if not v <= TOL_ORACLE_AGREE}
    if bad or not agree["dvr_vs_le"] < TOL_ORACLE_CROSS:
        raise AssertionError(f"oracles: card and CPU disagree: {bad or agree['dvr_vs_le']}")
    return dict(se=se, wigner=wig, le=le, agree=agree), res, shots, dg


def _grid_coords(x_grid, p_grid):
    gx, gp = np.meshgrid(x_grid, p_grid, indexing="ij")
    return np.stack([gx.ravel(), gp.ravel()], axis=-1)


def validation_phase(se_res, shots, val_dvr):
    """Phase 14: the validation harness on the card, held to its tests'
    bounds.  The keys are host keys (``RandomKeys(seed, "cpu")``): the
    selections are those the CPU tests draw from the same seeds."""
    from gple_tpu_torch import validation as V
    from gple_tpu_torch.ops import gram_kernels as GK
    from gple_tpu_torch.sampler.keys import RandomKeys

    cfg = se_res.cfg
    coords = _grid_coords(cfg.x_grid, cfg.p_grid)
    da = cfg.dx * (cfg.p_grid[1] - cfg.p_grid[0])
    vc = val_dvr.cfg
    frames = val_dvr.wigners[:, [0, 1], [0, 1]].real
    g = np.linspace(-6.0, 6.0, 61)
    tilted_coords = _grid_coords(g, g)
    c, s = np.cos(0.6), np.sin(0.6)
    tilted = 0.3 * np.exp(-0.5 * (((c * tilted_coords[:, 0] + s * tilted_coords[:, 1]) / 0.8)
                                  ** 2 + ((-s * tilted_coords[:, 0] + c * tilted_coords[:, 1])
                                          / 1.6) ** 2))
    torch.cuda.synchronize()
    GK.reset_launches()
    walls, fits = {}, {}
    for i in SHOT_FRAMES:
        for name, full in (("axis", False), ("full_ard", True)):
            t0 = time.perf_counter()
            fits[i, name] = V.screenshot_fit(RandomKeys(0, "cpu"), coords, shots[i].ravel(), da,
                                             full_ard=full, device="cuda")
            torch.cuda.synchronize()
            walls[f"screenshot_t{se_res.times[i]:g}_{name}_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    evolve = V.evolve_fit(RandomKeys(1, "cpu"), val_dvr.times, frames, vc.x_grid, vc.p_grid,
                          MODEL, vc.mass, n_points=EVOLVE_POINTS, device="cuda")
    torch.cuda.synchronize()
    walls["evolve_fit_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tilt = {full: V.screenshot_fit(RandomKeys(7, "cpu"), tilted_coords, tilted,
                                   (g[1] - g[0]) ** 2, n_points=160, full_ard=full,
                                   device="cuda") for full in (False, True)}
    torch.cuda.synchronize()
    walls["tilted_pair_s"] = time.perf_counter() - t0
    launches, by_shape = dict(GK.LAUNCHES), dict(GK.LAUNCHES_BY_SHAPE)
    points_reads = {f"strides {list(st)} sides {sides}": dict(
        launches=n, read_a=GK.points_vjp_read(st, "a"), read_b=GK.points_vjp_read(st, "b"))
        for (st, sides), n in GK.POINTS_VJP_READS.items()}
    log("validation: the cotangents rbf_gram_vjp_points read: " + json.dumps(points_reads))
    t_tilt = f"t{se_res.times[TILT_FRAME]:g}"
    trace = validation_trace(coords, shots[TILT_FRAME].ravel(), da,
                             walls[f"screenshot_{t_tilt}_full_ard_s"])
    log(f"validation traced full-ARD fit ({t_tilt}, 200 points): " + json.dumps(trace))

    snaps = {f"t{se_res.times[i]:g}_{name}": dict(
        mse=f.mse, rel_rmse=float(np.sqrt(f.mse) / np.abs(shots[i]).max()), nll=f.nll,
        population_grid=f.population_grid, population_prm=f.population_prm,
        lengths=f.state.params.lengths.cpu().numpy().tolist(),
        start=(0.5 * V.grid_weighted_selection(RandomKeys(0, "cpu"), coords, shots[i].ravel(),
                                               V.DEFAULT_NUM_POINTS)[0].std(axis=0)).tolist())
        for (i, name), f in fits.items()}
    result = dict(grid_points=coords.shape[0], walls=walls, screenshots=snaps,
                  evolve=[dict(time=fr.time, mse=fr.mse,
                               population_grid=fr.population_grid.tolist(),
                               population_prm=fr.population_prm.tolist(),
                               population_rescaled=fr.population_rescaled.tolist())
                          for fr in evolve],
                  tilted=dict(axis_mse=tilt[False].mse, full_mse=tilt[True].mse,
                              w10=float(tilt[True].state.params.lengths[1, 0])),
                  launches=launches, points_reads=points_reads)
    log("validation: " + json.dumps(result))

    def within(shot):
        return (shot["rel_rmse"] < VAL_REL_RMSE
                and abs(shot["population_prm"] / shot["population_grid"] - 1.0) < VAL_POP_REL)

    # every fit within the bounds, except the axis-aligned fit of the tilted
    # production frame, which is recorded (its population is what the full
    # ARD repairs) and must lose to the full-ARD fit
    t_post = f"t{se_res.times[POST_FRAME]:g}"
    for name, shot in snaps.items():
        if name.startswith(t_post):
            # the post-crossing frame: both fits must leave their start
            # (lengths0 = std / 2 of the selection; the cross term 0)
            lengths = np.asarray(shot["lengths"])
            fitted = 1.0 / np.abs(np.diagonal(lengths)) if lengths.ndim == 2 else lengths
            moved = float(np.max(np.abs(fitted / np.asarray(shot["start"]) - 1.0)))
            shot.update(moved=moved, within_bounds=bool(within(shot)))
            log(f"validation: post-crossing {name}: moved {moved!r}, within the "
                f"snapshot bounds {shot['within_bounds']}")
            if not (moved > 1e-3 and np.all(np.isfinite(lengths))):
                raise AssertionError(f"validation: the {name} fit kept its start: {shot}")
        elif name != f"{t_tilt}_axis" and not within(shot):
            raise AssertionError(f"validation: screenshot {name} {shot}")
    for axis, full in ((snaps[f"{t_tilt}_axis"]["mse"], snaps[f"{t_tilt}_full_ard"]["mse"]),
                       (result["tilted"]["axis_mse"], result["tilted"]["full_mse"])):
        if not full < FULL_ARD_GAIN * axis:
            raise AssertionError(f"validation: full ARD does not beat the axis-aligned fit: "
                                 f"{full} against {axis}")
    if not abs(result["tilted"]["w10"]) > 1e-3:
        raise AssertionError(f"validation: the full-ARD fit left its cross term: {result}")
    for fr in evolve:
        tol = np.maximum(0.02, 0.15 * fr.population_grid)
        if not (np.all(np.abs(fr.population_prm - fr.population_grid) < tol)
                and abs(fr.population_rescaled.sum() - 1.0) < 1e-8 and fr.mse < 1e-5):
            raise AssertionError(f"validation: evolve_fit frame {fr}")
    _check_path_launches("validation", launches, FORWARD + ("rbf_gram_vjp_points",))
    nll_agreement(coords, shots[TILT_FRAME].ravel())
    return launches, by_shape, result


def nll_agreement(coords, vals):
    """One NLL loss and its gradient at N = 200, vector and full-ARD, on the
    card against the CPU."""
    from gple_tpu_torch import validation as V
    from gple_tpu_torch.ops import kernels as RK
    from gple_tpu_torch.sampler.keys import RandomKeys

    feats, labels = V.grid_weighted_selection(RandomKeys(3, "cpu"), coords, vals, 200)
    std = feats.std(axis=0)
    errs = {}
    for name, theta in (("vector", 0.5 * std), ("full_ard", np.r_[0.5 * std, 0.3])):
        outs = {}
        for dev in ("cuda", "cpu"):
            th = torch.tensor(theta, device=dev, requires_grad=True)
            lengths = th
            if name == "full_ard":
                cross = torch.zeros((2, 2), dtype=th.dtype, device=dev)
                cross[1, 0] = 1.0
                lengths = torch.diag_embed(1.0 / th[:2]) + th[2] * cross
            one = torch.ones((), dtype=th.dtype, device=dev)
            st = RK.fit_real(RK.KernelParams(one, lengths, one * V.FIT_NOISE),
                             torch.tensor(feats, device=dev), torch.tensor(labels, device=dev))
            loss = V.nll_loss(st)
            (grad,) = torch.autograd.grad(loss, th)
            outs[dev] = (loss.detach().cpu(), grad.cpu())
        errs[name] = dict(loss=_rel(outs["cuda"][0], outs["cpu"][0]),
                          grad=_rel(outs["cuda"][1], outs["cpu"][1]))
    log(f"validation: NLL loss and gradient N=200, card against CPU (relative): "
        + json.dumps(errs))
    for name, e in errs.items():
        if not max(e.values()) <= TOL_NLL_AGREE:
            raise AssertionError(f"validation: NLL {name} disagrees: {e}")


def booster_phase():
    """Phase 16: the crossing physics at N = 1024 with the booster (1024
    extra coherence points) and every default-off flag through
    ``GPLEDriver.run`` on the card."""
    from gple_tpu_torch.driver import GPLEDriver
    from gple_tpu_torch.entry import booster_config
    from gple_tpu_torch.ops import gram_kernels as GK

    cfg = booster_config(BOOST_N, seed=BOOST_SEED)
    drv = GPLEDriver(cfg, device="cuda")
    calls, coh_points = {}, []
    _instrument(drv, calls)

    def seen(rec):
        coh_points.append((rec.time, bool(drv.gps.active[1]),
                           int(drv.gps.offdiag.features.shape[0]), drv._coh_k))

    torch.cuda.synchronize()
    GK.reset_launches()
    t0 = time.perf_counter()
    hist = drv.run(max_ticks=BOOST_TICKS, callback=seen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_shape = dict(GK.LAUNCHES), dict(GK.LAUNCHES_BY_SHAPE)
    walls = _walls(calls, wall, BOOST_TICKS)
    counters = {k: drv.stats.get(k, 0) for k in ("coh_rescales", "pop_rescales",
                                                 "coh_len_backoffs", "coh_boost_ejected")}
    result = dict(n=BOOST_N, k=cfg.coh_fit_extra, ticks=BOOST_TICKS, walls=walls,
                  init_phases=_init_phases(drv), phase_times=drv.phase_times,
                  chains=_chains_info(drv._chains),
                  counters=counters, stats=drv.stats, coh_div_eff=drv._coh_div_eff,
                  coherence_points_at_outputs=coh_points, launches=launches)
    log(f"booster N={BOOST_N}: " + json.dumps(result))
    for rec in hist:
        log(f"booster record t={rec.time} population_mci={sum(rec.population_mci)!r} "
            f"ppl_mci={rec.population_mci.tolist()} pop_prm={rec.population_prm!r} "
            f"E_prm/pop={rec.energy_prm / rec.population_prm!r} E_mci={rec.energy_mci!r} "
            f"purity_prm={rec.purity_prm!r} purity_mci={rec.purity_mci!r} opt={rec.opt_type}")
    for rec in hist:
        values = [rec.population_prm, rec.energy_prm, rec.energy_mci, rec.purity_prm,
                  rec.purity_mci, rec.x_average, *rec.population_mci, *rec.population_prm_each]
        if not np.all(np.isfinite(values)):
            raise AssertionError(f"booster: non-finite record at t={rec.time}")
    for name, tree in (("density", drv.density), ("extra", drv.extra), ("gps", drv.gps)):
        _check_finite(f"booster {name}", tree)
    boosted = [pts for _, active, pts, k in coh_points if active and k == cfg.coh_fit_extra]
    if not (boosted and all(p == BOOST_N + cfg.coh_fit_extra for p in boosted)):
        raise AssertionError(f"booster: the coherence never held N + k points: {coh_points}")
    if drv.gps.offdiag.features.shape[0] != BOOST_N + drv._coh_k:
        raise AssertionError("booster: the live coherence fit is not N + k points")
    if counters["coh_rescales"] + counters["pop_rescales"] < 1:
        raise AssertionError(f"booster: no rescale fired: {counters}")
    if drv.stats["element_activations"] < 1 or walls["reopts"] < 1:
        raise AssertionError(f"booster: no activation or reopt: {drv.stats}")
    _check_path_launches("booster", launches)
    return launches, by_shape, drv


def booster_seed_scan(seeds=range(12), ticks: int = 12, n: int = BOOST_N, device="cuda"):
    """For each seed, the booster run's first ``ticks`` ticks on ``device``:
    the ticks at which elements activated and the first tick with a
    non-finite label.  Not a phase of ``main`` (it picked ``BOOST_SEED``):
    ``python3 -c "import chip_smoke as c; c.booster_seed_scan()"``."""
    from gple_tpu_torch.driver import GPLEDriver
    from gple_tpu_torch.entry import booster_config

    for seed in seeds:
        drv = GPLEDriver(booster_config(n, seed=seed), device=device)
        drv.initialize()
        activations, first_nan = [], None
        for t in range(1, ticks + 1):
            before = drv.density.active.tolist()
            drv.step(t)
            if drv.density.active.tolist() != before:
                activations.append((t, drv.density.active.tolist()))
            if first_nan is None and not bool(torch.isfinite(drv.density.rho).all()):
                first_nan = t
        log(f"booster seed scan N={n} on {device}: " + json.dumps(dict(
            seed=seed, activations=activations, first_nan_tick=first_nan, stats=drv.stats)))


def booster_agreement(drv):
    """Phase 16b: BOOST_AGREE_TICKS booster ``_tick_core`` ticks on the card
    against the same ticks on the CPU from one state, relative to each
    array's largest |entry|.  The state is the booster run's last one thinned
    to every BOOST_AGREE_STRIDE-th point of each cloud -- the first k / stride
    coherence extra points are then booster points, a booster state at
    N / stride -- refitted on the card and copied to the CPU: at N = 1024 the
    plain versions take ~64 s a tick on the card's host."""
    from gple_tpu_torch import convert
    from gple_tpu_torch import driver as D
    from gple_tpu_torch.storage import Density, fit_gp_states

    cfg = drv.cfg
    diag, off = drv.optimizer.fitted_params()
    step = BOOST_AGREE_STRIDE
    density, extra = (Density(points=c.points[:, ::step], rho=c.rho[:, ::step],
                              active=c.active) for c in (drv.density, drv.extra))
    args = dict(track=drv._track_moments, k=drv._coh_k // step, div=drv._coh_div_eff,
                block=drv._block_diag())
    with torch.inference_mode():
        gps = fit_gp_states(diag, off, density, off_extra=D._off_extra_slice(extra, args["k"]),
                            block_diag=args["block"])
    start = (density, extra, gps, diag, off)
    outs = {}
    for dev in ("cuda", "cpu"):
        density, extra, gps, dp, op = (
            start if dev == "cuda" else
            [convert.to_torch(convert.to_numpy(x), "cpu") for x in start])
        t0 = time.perf_counter()
        for _ in range(BOOST_AGREE_TICKS):
            density, extra, small, gps = D._tick_core(
                cfg.model, cfg.mass, cfg.dt, density, extra, gps, dp, op,
                D._evolve_dist_for(cfg.evolve_cutoff), args["track"], args["k"],
                args["div"], args["block"])
        outs[dev] = dict(rho=density.rho.cpu(), extra_rho=extra.rho.cpu(),
                         points=density.points.cpu(), v=gps.offdiag.v.cpu(),
                         alpha=gps.diag.alpha.cpu(), small=small.cpu(),
                         s=time.perf_counter() - t0)
    errs = {k: _rel(outs["cuda"][k].numpy(), outs["cpu"][k].numpy())
            for k in ("points", "rho", "extra_rho", "alpha", "v")}
    log(f"booster agreement: {BOOST_AGREE_TICKS} ticks card vs CPU (relative) "
        + json.dumps(dict(errs, n=int(outs["cpu"]["points"].shape[1]),
                          coherence_points=int(outs["cpu"]["v"].shape[0]),
                          card_s=outs["cuda"]["s"], cpu_s=outs["cpu"]["s"], **args)))
    if not torch.equal(outs["cuda"]["small"], outs["cpu"]["small"]):
        raise AssertionError("booster: the card's activation flags differ from the CPU's")
    bad = {k: v for k, v in errs.items() if not v <= TOL_BOOST_AGREE}
    if bad:
        raise AssertionError(f"booster: card and CPU ticks disagree: {bad}")


def ecr_phase():
    """Phase 18: the ECR gate of ``tests/test_ecr_parity.py`` on the card:
    Tully C at x0 = -2, p0 = 20, N = 64 for 400 ticks against the port's
    reflective DVR (dx_input = 1)."""
    from gple_tpu_torch.config import GPLEConfig
    from gple_tpu_torch.driver import GPLEDriver
    from gple_tpu_torch.oracles import DVRConfig, DVRSolver
    from gple_tpu_torch.ops import gram_kernels as GK

    cfg = GPLEConfig(model="ECR", mass=MASS, x0=-2.0, p0=20.0, sigma_p0=1.0, output_time=10.0,
                     reopt_time=10.0, dt=1.0, num_points=ECR_N)
    dvr = DVRSolver(DVRConfig(model="ECR", boundary="reflective", mass=cfg.mass, x0=cfg.x0,
                              p0=cfg.p0, sigma_p=cfg.sigma_p0, xmin=cfg.xmin, xmax=cfg.xmax,
                              dx_input=1.0, output_time=cfg.output_time, dt_input=cfg.dt),
                    "cuda").run(store_wigner=False)
    drv = GPLEDriver(cfg, device="cuda")
    torch.cuda.synchronize()
    GK.reset_launches()
    t0 = time.perf_counter()
    hist = drv.run(max_ticks=ECR_TICKS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_shape = dict(GK.LAUNCHES), dict(GK.LAUNCHES_BY_SHAPE)
    gt = np.array([r.time for r in hist])
    gp0 = np.array([r.population_mci[0] for r in hist])
    sp0 = np.interp(gt, dvr.times, dvr.populations[:, 0])
    n_cmp = min(len(gt), int(np.searchsorted(gt, dvr.times[-1]) + 1))
    rmse = float(np.sqrt(np.mean((gp0[:n_cmp] - sp0[:n_cmp]) ** 2)))
    pop_dev = float(np.max(np.abs([r.population_mci.sum() - 1.0 for r in hist])))
    result = dict(n=ECR_N, ticks=ECR_TICKS, run_s=wall, records=len(hist), compared=n_cmp,
                  rmse_vs_dvr=rmse, max_population_deviation=pop_dev,
                  final_population_mci=hist[-1].population_mci.tolist(), stats=drv.stats,
                  phase_times=drv.phase_times,
                  chains=_chains_info(drv._chains), dvr_outputs=len(dvr.times))
    log("ecr: " + json.dumps(result))
    if not (rmse < ECR_RMSE and pop_dev < ECR_POP and len(hist) > 1):
        raise AssertionError(f"ecr: RMSE {rmse} or population deviation {pop_dev}")
    _check_path_launches("ecr", launches)
    return launches, by_shape, result


def _rel_err(ours, theirs) -> float:
    """The largest |difference| over the largest |reference entry|, over leaves."""
    err = scale = 0.0
    for a, b in zip(_leaves(ours), _leaves(theirs)):
        if b.is_floating_point():
            err = max(err, (a - b).abs().max().item())
            scale = max(scale, b.abs().max().item())
    return err / max(scale, 1e-300)


def sharding_phase(n: int = N_SLICE, device: str = "cuda"):
    """Phase 20: ``sharded_step_fn`` on an in-process group of world size 1
    (NCCL on the card) against ``make_step_fn``, then ``dryrun_multichip`` on
    every card.  Both steps run 2 warm-up and 10 timed steps from the same
    example state; the sharded run's launches are counted alone."""
    import os

    import torch.distributed as dist

    from gple_tpu_torch.entry import dryrun_multichip, example_state
    from gple_tpu_torch.ops import gram_kernels as GK
    from gple_tpu_torch.parallel import sharding as SH

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def timed(step, density, gps):
        for _ in range(WARMUP_STEPS):
            density, gps = step(density, gps)
        sync()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            density, gps = step(density, gps)
        sync()
        return density, gps, (time.perf_counter() - t0) / TIMED_STEPS

    density, gps = example_state(n, device, generator=torch.Generator().manual_seed(0))
    plain = SH.make_step_fn(MODEL, MASS, DT)
    ref_density, ref_gps, s_plain = timed(plain, density, gps)
    with tempfile.TemporaryDirectory() as tmp:
        SH.init_group(0, 1, os.path.join(tmp, "store"), device)
        try:
            mesh = SH.make_mesh(1, device)
            step = SH.sharded_step_fn(MODEL, MASS, DT, mesh, shard_refit=True)
            sync()
            GK.reset_launches()
            local, state, s_sharded = timed(step, SH.shard_density(density, mesh), gps)
            launches, by_shape = dict(GK.LAUNCHES), dict(GK.LAUNCHES_BY_SHAPE)
            # in turns (plain, sharded, sharded, plain): host noise moves
            # s/step by more than the collectives cost at world size 1
            s_sharded = [s_sharded, timed(step, SH.shard_density(density, mesh), gps)[2]]
            s_plain = [s_plain, timed(plain, density, gps)[2]]
            backend = dist.get_backend()
            out_density = SH.gather_density(local, mesh)
            out_gps = SH.gather_gps(state, mesh)
        finally:
            dist.destroy_process_group()
    errs = {"density": _rel_err(out_density, ref_density), "gps": _rel_err(out_gps, ref_gps)}
    identical = all(torch.equal(a, b) for a, b in zip(_leaves((out_density, out_gps)),
                                                       _leaves((ref_density, ref_gps))))
    result = dict(n=n, world_size=1, backend=backend, steps=WARMUP_STEPS + TIMED_STEPS,
                  s_per_step_plain=s_plain, s_per_step_sharded=s_sharded,
                  collectives_s=(sum(s_sharded) - sum(s_plain)) / 2, rel_err=errs,
                  bit_identical=identical, launches=launches)
    log(f"sharding N={n}: " + json.dumps(result))
    for name, tree in (("density", out_density), ("gps", out_gps)):
        _check_finite(f"sharding {name}", tree)
    if not max(errs.values()) <= TOL_SHARDED:
        raise AssertionError(f"sharding: the sharded step differs from make_step_fn: {errs}")
    if device == "cuda":   # the CPU (a rehearsal) takes the plain versions
        _check_path_launches("sharding", launches, names=("rbf_gram",))
    world = torch.cuda.device_count() if device == "cuda" else 1
    t0 = time.perf_counter()
    dryrun_multichip(world, device=device)
    log(f"sharding: dryrun_multichip({world}) {time.perf_counter() - t0!r} s "
        "(rank processes started, built state, one step)")
    if device == "cuda":
        t0 = time.perf_counter()
        two = gloo_one_card(n)
        err = _rel_err(two["out"], (ref_density, ref_gps))
        result["gloo_one_card"] = dict(world_size=2, s_per_step=two["s_per_step"],
                                       rel_err=err, wall_s=time.perf_counter() - t0)
        log(f"sharding N={n}: two gloo ranks on one card, CUDA tensors: "
            + json.dumps(result["gloo_one_card"]))
        if not err <= TOL_SHARDED:
            raise AssertionError(f"sharding: two gloo ranks differ from make_step_fn by {err}")
    return launches, by_shape, result


def _gloo_card_rank(rank: int, world: int, store_path: str, out_dir: str, n: int) -> None:
    """One rank of :func:`gloo_one_card`: a gloo group whose ranks all hold
    card 0, the mesh built by hand (``make_mesh`` pairs cuda with NCCL only)."""
    import os

    import torch.distributed as dist

    from gple_tpu_torch.entry import example_state
    from gple_tpu_torch.parallel import sharding as SH

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=SH.TIMEOUT)
    try:
        dev = torch.device("cuda", 0)
        mesh = SH.PointMesh(group=dist.group.WORLD, rank=rank, size=world, device=dev)
        density, gps = example_state(n, dev, generator=torch.Generator().manual_seed(0))
        step = SH.sharded_step_fn(MODEL, MASS, DT, mesh, shard_refit=True)
        local, state = SH.shard_density(density, mesh), gps
        for _ in range(WARMUP_STEPS):
            local, state = step(local, state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            local, state = step(local, state)
        torch.cuda.synchronize()
        s_step = (time.perf_counter() - t0) / TIMED_STEPS
        whole = (SH.gather_density(local, mesh), SH.gather_gps(state, mesh))
        if rank == 0:
            torch.save(dict(s_per_step=s_step, out=whole), os.path.join(out_dir, "rank0.pt"))
    finally:
        dist.destroy_process_group()


def gloo_one_card(n: int = N_SLICE, world: int = 2):
    """``world`` ranks of the sharded step on the one card over gloo with CUDA
    tensors (NCCL refuses two ranks on one card): rank 0's s/step and its
    gathered state after 2 + 10 steps."""
    import os

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_gloo_card_rank, nprocs=world, join=True,
                 args=(world, os.path.join(tmp, "store"), tmp, n))
        return torch.load(os.path.join(tmp, "rank0.pt"), weights_only=False)


#: device kernels of each wrapper, as a profiler trace names them
KERNEL_SYMBOLS = {"rbf_gram": ("rbf_gram_kernel",),
                  "rbf_predict_mean": ("rbf_predict_partial_kernel",
                                       "rbf_predict_reduce_kernel")}
DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")
#: device operations by family, first match wins
DEVICE_FAMILIES = (("hand-written (csrc)", ("rbf_",)),
                   ("cuBLAS GEMM", ("gemm", "gemv")),
                   ("cuSOLVER / cuBLAS factor and solve", ("potrf", "trsm", "syrk", "cusolver",
                                                            "trsv", "getrf")),
                   ("copies and fills", ("Memcpy", "Memset", "copy_kernel", "fill_kernel")),
                   ("elementwise", ("elementwise_kernel",)),
                   ("reductions", ("reduce_kernel",)))


def _busy(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def trace_breakdown(trace_path: str, top: int = 5) -> dict:
    """From a chrome trace: the ``top`` device operations by summed time, the
    device-busy share of the traced window (first to last event) and the
    device kernels of each wrapper in ``KERNEL_SYMBOLS``."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    window = (max(e["ts"] + e.get("dur", 0) for e in events)
              - min(e["ts"] for e in events))
    device = [e for e in events if e.get("cat") in DEVICE_EVENTS]
    by_name = {}
    for e in device:
        calls, us = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (calls + 1, us + e.get("dur", 0))
    busy = _busy((e["ts"], e["ts"] + e.get("dur", 0)) for e in device)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    families = {}
    for name, (c, us) in by_name.items():
        family = next((f for f, keys in DEVICE_FAMILIES if any(k in name for k in keys)),
                      "other")
        calls, total = families.get(family, (0, 0.0))
        families[family] = (calls + c, total + us)
    return dict(
        window_ms=window / 1e3, device_busy_ms=busy / 1e3,
        device_busy_share=busy / window if window else 0.0,
        device_ops=len(device), host_ops=len(events) - len(device),
        top=[dict(name=name[:120], calls=c, ms=us / 1e3, share_of_busy=us / busy)
             for name, (c, us) in ranked[:top]],
        families={f: dict(calls=c, ms=us / 1e3, share_of_busy=us / busy if busy else 0.0)
                  for f, (c, us) in sorted(families.items(), key=lambda kv: -kv[1][1])},
        kernels={w: sorted({e["name"][:80] for e in device
                            if any(sym in e["name"] for sym in syms)})
                 for w, syms in KERNEL_SYMBOLS.items()})


def profile_phase(n: int = TRAJ_N, device: str = "cuda"):
    """Phase 21: ``trajectory_config(n)`` with ``init_cache`` for PROFILE_TICKS
    ticks, cold (written into a temporary cache), then again with
    ``profile_dir``: restored from the cache (bit for bit the cold run), so
    the trace holds the ticks, one scheduled reoptimization and the outputs,
    not the initial Metropolis walk.  Prints the trace's top device
    operations and the device-busy share of the traced window."""
    import dataclasses
    import os

    from gple_tpu_torch import driver as TD
    from gple_tpu_torch.entry import trajectory_config
    from gple_tpu_torch.ops import gram_kernels as GK

    cfg = dataclasses.replace(trajectory_config(n), init_cache=True)
    before = os.environ.get(TD.INIT_CACHE_ENV)
    with tempfile.TemporaryDirectory() as tmp:
        os.environ[TD.INIT_CACHE_ENV] = os.path.join(tmp, "cache")
        try:
            cold = TD.GPLEDriver(cfg, device=device)
            cold_hist = cold.run(max_ticks=PROFILE_TICKS)
            drv = TD.GPLEDriver(cfg, device=device, profile_dir=os.path.join(tmp, "trace"))
            logs = []
            drv._log = logs.append
            GK.reset_launches()
            t0 = time.perf_counter()
            hist = drv.run(max_ticks=PROFILE_TICKS)
            wall = time.perf_counter() - t0
            launches, by_shape = dict(GK.LAUNCHES), dict(GK.LAUNCHES_BY_SHAPE)
            t1 = time.perf_counter()
            breakdown = trace_breakdown(drv.trace_path)
            breakdown.update(run_s=wall, parse_s=time.perf_counter() - t1,
                             trace_mb=os.path.getsize(drv.trace_path) / 1e6,
                             phase_times=drv.phase_times, launches=launches,
                             spans=_span_summary(drv.spans))
        finally:
            if before is None:
                os.environ.pop(TD.INIT_CACHE_ENV, None)
            else:
                os.environ[TD.INIT_CACHE_ENV] = before
    restored = any(line.startswith("init restored from cache") for line in logs)
    same = len(hist) == len(cold_hist) and all(
        np.array_equal(np.asarray(getattr(a, f.name)), np.asarray(getattr(b, f.name)))
        for a, b in zip(hist, cold_hist) for f in dataclasses.fields(a))
    same_state = all(torch.equal(a, b) for a, b in zip(
        _leaves((drv.density, drv.extra, drv.gps)), _leaves((cold.density, cold.extra, cold.gps))))
    log(f"profile N={n}, {PROFILE_TICKS} ticks restored={restored} records_bitwise={same} "
        f"state_bitwise={same_state}: " + json.dumps(breakdown))
    if not (restored and same and same_state):
        raise AssertionError("profile: the restored run is not the cold run bit for bit")
    if device == "cuda":   # the CPU (a rehearsal) takes the plain versions
        missing = [w for w, names in breakdown["kernels"].items() if not names]
        if missing:
            raise AssertionError(f"profile: the trace names no device kernel of {missing}")
        _check_path_launches("profile", launches)
        _check_graphs("profile", drv.totals)
    return launches, by_shape, breakdown


def _host_launches(trace_path: str) -> dict:
    """The host's launch calls in a chrome trace, by name (kernels, graphs,
    copies and fills), and the device operations they ran."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    calls = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and any(
                k in e["name"] for k in HOST_LAUNCHES):
            calls[e["name"]] = calls.get(e["name"], 0) + 1
    device = sum(1 for e in events if e.get("cat") in DEVICE_EVENTS)
    return dict(calls=calls, total=sum(calls.values()), device_ops=device)


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def _traced(fn, path: str, device: str) -> None:
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    _sync(device)
    with profile(activities=activities) as prof:
        fn()
        _sync(device)
    prof.export_chrome_trace(path)


def graph_phase(n: int = TRAJ_N, device: str = "cuda"):
    """Phase 22(a): ``trajectory_config(n)`` initialized; from its state,
    GRAPH_TICKS eager ticks (the tick graph's function, ``_tick_program`` --
    ``_tick_core`` and its row -- run eagerly) against as many replays of
    its captured graph, bit for bit; s/tick of both in turns (eager, graph,
    graph, eager); the host's launch calls per tick of each and the
    device-busy share of a traced window of replays; the capture's wall and
    the graph pool's memory; and the activation test on the host's tuple
    against all nine pairs (:func:`_activation_pairs`).  ``device="cpu"``
    rehearses it (the graph's function runs eagerly there)."""
    import os

    from gple_tpu_torch import driver as TD
    from gple_tpu_torch.entry import trajectory_config
    from gple_tpu_torch.ops import gram_kernels as GK
    from gple_tpu_torch.ops import graphs as GR

    drv = TD.GPLEDriver(trajectory_config(n), device=device)
    drv.initialize()
    S, tick, _ = drv._programs(drv._host_active())
    drv._load(S)
    with spans.collect() as captured:
        tick()                               # warm-up and capture, then one replay

    def ticks(fn):
        drv._load(S)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(GRAPH_TICKS):
            fn()
        _sync(device)
        return (time.perf_counter() - t0) / GRAPH_TICKS

    with torch.inference_mode():
        s_tick = {"eager": [ticks(tick.fn)]}
        eager = GR.clone((S.density, S.extra, S.gps, S.rows))
        GK.reset_launches()
        s_tick["graph"] = [ticks(tick)]
        launches, by_shape = dict(GK.LAUNCHES), dict(GK.LAUNCHES_BY_SHAPE)
        graphed = GR.leaves((S.density, S.extra, S.gps, S.rows))
        equal = all(torch.equal(a, b) for a, b in zip(graphed, GR.leaves(eager)))
        err = max(_rel_err(a, b) for a, b in zip(graphed, GR.leaves(eager)))
        s_tick["graph"].append(ticks(tick))
        s_tick["eager"].append(ticks(tick.fn))
        with tempfile.TemporaryDirectory() as tmp:
            one = {}
            for name, fn in (("eager", tick.fn), ("graph", tick)):
                drv._load(S)
                _traced(fn, os.path.join(tmp, f"{name}.json"), device)
                one[name] = _host_launches(os.path.join(tmp, f"{name}.json"))
            drv._load(S)
            path = os.path.join(tmp, "window.json")
            _traced(lambda: [tick() for _ in range(GRAPH_TICKS)], path, device)
            window = trace_breakdown(path)
            window["host_launches"] = _host_launches(path)
        pairs = _activation_pairs(drv, S, tick, device)
    result = dict(n=n, ticks=GRAPH_TICKS, s_per_tick=s_tick, bitwise=equal, max_rel_err=err,
                  capture_s=captured.seconds("capture"), pool_mib=tick.pool_bytes / 2**20,
                  launches_per_replay={f"{k[0]} {k[1]}": v for k, v in tick.launches.items()},
                  host_launches_one_tick=one,
                  graphed_window={k: window[k] for k in ("window_ms", "device_busy_ms",
                                                         "device_busy_share", "device_ops",
                                                         "host_launches", "families")},
                  activation_test=pairs)
    log("graph: " + json.dumps(result))
    # cuBLAS and cuSOLVER may pick other algorithms under capture; the
    # replays must then stay within 1e-12 of the eager ticks, relative
    if not (equal or err <= 1e-12):
        raise AssertionError(f"graph: replays differ from the eager ticks by {err}")
    if not (pairs["bitwise"] or pairs["max_rel_err"] <= 1e-12):
        raise AssertionError("graph: the tick on the host's tuple differs from the full "
                             f"tick by {pairs['max_rel_err']}")
    if device == "cuda":
        _check_path_launches("graph", launches)
    return launches, by_shape, result


def _activation_pairs(drv, S, tick, device: str) -> dict:
    """Phase 22(a), the activation test: the driver's tick graph (the test on
    the host's active tuple, only the pairs it reads) against the same
    program captured with None (all nine pairs) on the same static state.
    Device ms a tick by CUDA events over GRAPH_TICKS replays of each, in
    turns (tuple, None, None, tuple); the device operations of one traced
    replay of each by family (the cuBLAS GEMMs: the test's 33 complex and 3
    batched diagonal variance products with None, 2 products on (True,
    False, False)); the states and rows after GRAPH_TICKS replays of each,
    bit for bit.  On the CPU (a rehearsal) both run eagerly and no device
    number is taken."""
    import os
    from functools import partial

    from gple_tpu_torch import driver as TD
    from gple_tpu_torch.dynamics import evolve as EV
    from gple_tpu_torch.ops import graphs as GR

    active = tick.fn.args[-1]
    graphs = {"tuple": tick,
              "none": GR.Graph(partial(TD._tick_program, *tick.fn.args[:-1], None), S, "tick")}

    def replays(graph):
        drv._load(S)
        if device != "cuda":
            for _ in range(GRAPH_TICKS):
                graph()
            return None
        graph.capture()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(GRAPH_TICKS):
            graph()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / GRAPH_TICKS

    dev_ms = {name: [] for name in graphs}
    states = {}
    for name in ("tuple", "none", "none", "tuple"):
        dev_ms[name].append(replays(graphs[name]))
        states[name] = GR.clone((S.density, S.extra, S.gps, S.rows))
    ours, theirs = GR.leaves(states["tuple"]), GR.leaves(states["none"])
    one = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, graph in graphs.items():
            drv._load(S)
            path = os.path.join(tmp, f"{name}.json")
            _traced(graph, path, device)
            trace = trace_breakdown(path, top=8)
            one[name] = {k: trace[k] for k in ("device_busy_ms", "device_ops", "top",
                                               "families")}
    gemms = {name: t["families"].get("cuBLAS GEMM", {}).get("calls", 0)
             for name, t in one.items()}
    return dict(active=list(active), pairs={"tuple": EV.variance_pairs(active),
                                            "none": EV.variance_pairs(None)},
                dev_ms_per_tick=dev_ms, gemm_calls_per_tick=gemms,
                gemm_calls_saved=gemms["none"] - gemms["tuple"],
                bitwise=all(torch.equal(a, b) for a, b in zip(ours, theirs)),
                max_rel_err=_rel_err(states["tuple"], states["none"]),
                pool_mib_none=graphs["none"].pool_bytes / 2**20, one_replay=one)


def _chains_info(chains) -> dict:
    """A :class:`mc.Chains`'s programs, graphs and pool."""
    return dict(programs=len(chains.programs), graphs=len(chains.graphs()),
                pool_mib=chains.pool_bytes / 2**20)


def walk_phase(n: int = WALK_N, device: str = "cuda"):
    """Phase 23: from an initialized ``entry.parity_config("SAC", n)`` driver,
    (a) the tuned initial walk of element (0, 0) (the initial distribution,
    as ``initialize`` walks it) and (b) one tuned re-selection walk of the
    same element on its walk surrogate (as ``_track_clouds`` walks it), each
    on one key through the straight loop (``chains=None``) and the graphs
    (one ``mc.Chains``, so the second graphed walk replays the first's
    captures) in turns: eager, graph, graph, eager.  Prints the walls, the
    host's launch calls of one walk of each route (a traced walk), the
    capture's wall and the pool, and checks the graphed walks equal the
    eager ones bit for bit, replay graphs, and launch from the host below
    ``WALK_LAUNCH_SHARE`` of the eager walk's calls; then that a failed
    capture raises (a test in a process of its own).  The path's kernel
    launches are counted over the graphed walks alone (reset just before
    each, read just after); the eager walks' are logged apart.
    ``device="cpu"`` rehearses it (the graphs' functions run eagerly)."""
    import os

    from gple_tpu_torch import driver as TD
    from gple_tpu_torch.entry import parity_config
    from gple_tpu_torch.ops import gram_kernels as GK
    from gple_tpu_torch.sampler import mc
    from gple_tpu_torch.sampler.keys import RandomKeys

    drv = TD.GPLEDriver(parity_config("SAC", n), device=device)
    drv.initialize()
    cfg = drv.cfg

    def f64(v):
        return torch.tensor(np.asarray(v, dtype=np.float64), device=device)

    init_params = (f64(cfg.r0), f64(cfg.sigma_r0), f64(cfg.initial_population),
                   f64(cfg.initial_phase_factor))
    start = f64(cfg.r0)[None, :].expand(n, 2)
    with torch.inference_mode():
        gps = drv._relabel_gps(drv.density, drv.extra)
        surrogate = drv._walk_surrogate(gps, 0, drv.density, drv.extra)
    walks = {
        "initial": lambda key, chains: mc.element_monte_carlo(
            key, TD.INIT_DIST_ELEMS[0], init_params, start, mc.MCParameters(), tune=True,
            chains=chains),
        "reselect": lambda key, chains: mc.element_monte_carlo(
            key, drv._new_pt_dists[0], gps, drv.density.points[0], mc.MCParameters(),
            tune=True, walk=surrogate, chains=chains),
    }
    launches, by_shape, results = {}, {}, {}
    for name, walk in walks.items():
        routes = {"eager": None, "graph": mc.Chains()}

        def once(route):
            with torch.inference_mode():
                p, r, params = walk(RandomKeys(WALK_SEED, device), routes[route])
            return p, r, (params.num_steps, params.displacement)

        walls, outs, eager_launches = {}, {}, {}
        totals = spans.Totals()
        for route in ("eager", "graph", "graph", "eager"):
            _sync(device)
            GK.reset_launches()
            t0 = time.perf_counter()
            with spans.collect(totals):
                outs.setdefault(route, []).append(once(route))
            _sync(device)
            walls.setdefault(route, []).append(time.perf_counter() - t0)
            # only the graphed walks count for the path
            pairs = ((launches, GK.LAUNCHES), (by_shape, GK.LAUNCHES_BY_SHAPE))
            for total, counted in (pairs if route == "graph" else
                                   ((eager_launches, GK.LAUNCHES),)):
                for k, v in counted.items():
                    total[k] = total.get(k, 0) + v
        counts = _graphs(totals)
        bitwise = all(a[2] == b[2] and torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                      for a in outs["graph"] + outs["eager"][1:] for b in outs["eager"][:1])
        host = {}
        with tempfile.TemporaryDirectory() as tmp:
            for route in ("eager", "graph"):
                path = os.path.join(tmp, f"{route}.json")
                _traced(lambda: once(route), path, device)
                host[route] = _host_launches(path)
        share = host["graph"]["total"] / max(host["eager"]["total"], 1)
        results[name] = dict(n=n, walls=walls, bitwise=bitwise, graphs=counts,
                             params=outs["graph"][0][2], host_launches=host,
                             eager_kernel_launches=eager_launches,
                             host_launch_share=share, chains=_chains_info(routes["graph"]))
        log(f"walk {name}: " + json.dumps(results[name]))
        if not bitwise:
            raise AssertionError(f"walk {name}: the graphed walk differs from the eager walk")
        if device == "cuda" and not (counts["replays"] > 0 and share < WALK_LAUNCH_SHARE):
            raise AssertionError(f"walk {name}: graphs {counts}, host launch share {share}")
    if device == "cuda":
        _check_path_launches("walks", launches, names=("rbf_predict_mean",))
        # a capture that fails raises (in its own process: a failed capture
        # may leave the context unusable)
        probe = subprocess.run(
            [sys.executable, "-m", "pytest", "--noconftest", "-q", "-p", "no:cacheprovider",
             "-m", "gpu", "-k", "failed_chain_capture_raises", "tests/test_torch_graphs.py"],
            capture_output=True, text=True, timeout=300, cwd=Path(__file__).resolve().parent)
        tail = probe.stdout.strip().splitlines()[-1:] or ["(no output)"]
        log(f"walks: a failed capture: {tail[0]}")
        if probe.returncode != 0 or "1 passed" not in tail[0]:
            raise AssertionError(f"walks: the failed-capture test did not pass:\n"
                                 f"{probe.stdout[-2000:]}{probe.stderr[-2000:]}")
    return launches, by_shape, results


def band_phase(rows=None, device: str = "cuda"):
    """Phase 24: the reference band's whole trajectories (``entry.PARITY_ROWS``:
    SAC N = 1024, ECR, SAC and DAC at N = 256), each
    ``GPLEDriver(entry.parity_config(model, N)).run()`` to its stop condition
    (no writers, so the fused segments with their event hints, the config's
    seed) against the port's reflective DVR on the card, held to the JAX
    package's table ``gple_tpu_torch/data/parity_dvr.json`` to 1e-8; the
    ground-state population RMSE by both estimators (``entry.parity_rmse``,
    ``benchmarks/parity.py``'s rules), mci within the row's limit (1.5x the
    reference's round-5 RMSE), every record finite, at least one element
    activation.  Prints each row's wall, phase walls, RMSEs, frames compared,
    activations, re-selections and walk graphs.  ``rows`` and ``device="cpu"``
    rehearse it at a small N."""
    from gple_tpu_torch.driver import GPLEDriver
    from gple_tpu_torch.entry import PARITY_ROWS, dvr_config_for, parity_config, parity_rmse
    from gple_tpu_torch.oracles import DVRSolver
    from gple_tpu_torch.ops import gram_kernels as GK

    with open(PARITY_TABLE) as f:
        table = json.load(f)
    dvrs, launches, by_shape, results = {}, {}, {}, []
    for model, n, limit in (PARITY_ROWS if rows is None else rows):
        if model not in dvrs:
            t0 = time.perf_counter()
            dvr = DVRSolver(dvr_config_for(parity_config(model, n)), device).run(
                store_wigner=False)
            dvr_s = time.perf_counter() - t0
            err = float(np.max(np.abs(dvr.populations
                                      - np.array(table[model]["populations"]))))
            log(f"band {model}: the port's DVR in {dvr_s!r} s, {len(dvr.times)} outputs, "
                f"max |populations - table| {err!r}")
            if not (np.array_equal(dvr.times, table[model]["times"]) and err <= TOL_DVR_TABLE):
                raise AssertionError(f"band {model}: the port's DVR differs from the table: "
                                     f"{err}")
            dvrs[model] = dvr
        cfg = parity_config(model, n)
        drv = GPLEDriver(cfg, device=device)
        _sync(device)
        GK.reset_launches()
        t0 = time.perf_counter()
        hist = drv.run()
        _sync(device)
        wall = time.perf_counter() - t0
        for k, v in GK.LAUNCHES.items():
            launches[k] = launches.get(k, 0) + v
        for k, v in GK.LAUNCHES_BY_SHAPE.items():
            by_shape[k] = by_shape.get(k, 0) + v
        rmse = parity_rmse(hist, dvrs[model].times, dvrs[model].populations)
        result = dict(model=model, n=n, run_s=wall, ticks=int(round(hist[-1].time / cfg.dt)),
                      records=len(hist), limit_mci=limit, **rmse,
                      phase_times=drv.phase_times, init_phases=_init_phases(drv),
                      stats=drv.stats, mc_params=[(p.num_steps, p.displacement)
                                                  for p in drv.mc_params],
                      graphs=_graphs(drv.totals), chains=_chains_info(drv._chains),
                      launches=dict(GK.LAUNCHES),
                      final_population_mci=hist[-1].population_mci.tolist(),
                      final_x=hist[-1].x_average)
        log(f"band {model} N={n}: " + json.dumps(result))
        results.append(result)
        for rec in hist:
            values = [rec.population_prm, rec.energy_prm, rec.energy_mci, rec.purity_prm,
                      rec.purity_mci, rec.x_average, *rec.population_mci,
                      *rec.population_prm_each]
            if not np.all(np.isfinite(values)):
                raise AssertionError(f"band {model} N={n}: non-finite record at t={rec.time}")
        if not hist[-1].x_average > -cfg.x0:
            raise AssertionError(f"band {model} N={n}: stopped at t={hist[-1].time} before "
                                 f"the packet left (<x> = {hist[-1].x_average})")
        if drv.stats["element_activations"] < 1:
            raise AssertionError(f"band {model} N={n}: no element activated: {drv.stats}")
        if not rmse["rmse_mci"] <= limit:
            raise AssertionError(f"band {model} N={n}: mci RMSE {rmse['rmse_mci']} above "
                                 f"{limit}")
        if device == "cuda":
            _check_path_launches(f"band {model} N={n}", result["launches"])
            if not drv._chains.graphs() or not result["graphs"]["replays"] > 0:
                raise AssertionError(f"band {model} N={n}: the walks or ticks ran no graph")
        del drv
    log("band: " + json.dumps([{k: r[k] for k in ("model", "n", "run_s", "rmse_mci",
                                                   "rmse_prm", "limit_mci", "frames_compared")}
                               for r in results]))
    return launches, by_shape, results


def _compare_runs(phase: str, chunked, fused) -> dict:
    """Records, points, rho and the random key of a fused run against the
    chunked run (tests/test_fused_trajectory.py's tolerances)."""
    (dc, hc), (df, hf) = chunked, fused
    if len(hc) != len(hf) or any((a.time, a.opt_type) != (b.time, b.opt_type)
                                 for a, b in zip(hc, hf)):
        raise AssertionError(f"{phase}: the fused run's records differ in time or kind")
    rec = max(_rel_err(torch.as_tensor(np.atleast_1d(getattr(b, f))),
                       torch.as_tensor(np.atleast_1d(getattr(a, f))))
              for a, b in zip(hc, hf)
              for f in ("population_prm", "population_mci", "energy_mci", "purity_prm",
                        "x_average"))
    pts = (df.density.points - dc.density.points).abs().max().item()
    rho = _rel_err(df.density.rho, dc.density.rho)
    errs = dict(records=rec, points=pts, rho=rho, key_equal=df.rng.seed == dc.rng.seed,
                stats_equal=df.stats == dc.stats)
    if not (rec <= TOL_FUSED_RECORD and pts <= TOL_FUSED_POINTS and rho <= TOL_FUSED_RHO
            and errs["key_equal"] and errs["stats_equal"]):
        raise AssertionError(f"{phase}: the fused run differs from the chunked run: {errs}")
    return errs


def fused_phase(n: int = TRAJ_N, ticks: int = FUSED_TICKS,
                cross_ticks: int = FUSED_CROSS_TICKS, device: str = "cuda"):
    """Phase 22(b)-(c).  (b): ``trajectory_config(1024).run(FUSED_TICKS)``, no
    writers, ``fused_chunk = 100`` against ``0``, in turns (chunked, fused,
    fused, chunked): records, points and keys of the first pair against each
    other, s/tick of each run (its wall less its initialization).  (c):
    ``crossing_config()`` (N = 64, activations) for FUSED_CROSS_TICKS with
    ``fused_chunk = FUSED_CROSS_CHUNK`` against ``0``: a segment must roll
    back and the chunked path replay through its event, and the records
    equal the chunked run's.  ``device="cpu"`` (and fewer ticks) rehearses it."""
    import dataclasses

    from gple_tpu_torch.driver import GPLEDriver
    from gple_tpu_torch.entry import crossing_config, trajectory_config
    from gple_tpu_torch.ops import gram_kernels as GK

    def run(cfg, n_ticks):
        drv = GPLEDriver(cfg, device=device)
        GK.reset_launches()
        _sync(device)
        t0 = time.perf_counter()
        hist = drv.run(max_ticks=n_ticks)
        _sync(device)
        wall = time.perf_counter() - t0
        info = dict(run_s=wall, s_per_tick=(wall - drv.phase_times["init"]) / n_ticks,
                    phase_times=drv.phase_times, stats=drv.stats, graphs=_graphs(drv.totals),
                    launches=dict(GK.LAUNCHES))
        return (drv, hist), info, dict(GK.LAUNCHES_BY_SHAPE)

    base = trajectory_config(n)
    runs = {}
    for name, fc in (("chunked", 0), ("fused", 100), ("fused_2", 100), ("chunked_2", 0)):
        runs[name] = run(dataclasses.replace(base, fused_chunk=fc), ticks)
        log(f"fused N={n} {name}: " + json.dumps(runs[name][1]))
    errs = _compare_runs("fused", runs["chunked"][0], runs["fused"][0])
    (df, _), info, by_shape = runs["fused"]
    result = dict(ticks=ticks, errors=errs,
                  s_per_tick={k: v[1]["s_per_tick"] for k, v in runs.items()},
                  fused_s=info["phase_times"]["fused"])
    log("fused: " + json.dumps(result))
    if not info["phase_times"]["fused"] > 0.0:
        raise AssertionError("fused: the fused path was not taken")
    if device == "cuda":
        _check_path_launches("fused", info["launches"])

    cross = {}
    for name, fc in (("chunked", 0), ("fused", FUSED_CROSS_CHUNK)):
        cross[name] = run(dataclasses.replace(crossing_config(), fused_chunk=fc),
                          cross_ticks)
        log(f"fused crossing {name}: " + json.dumps(cross[name][1]))
    cerrs = _compare_runs("fused crossing", cross["chunked"][0], cross["fused"][0])
    cinfo = cross["fused"][1]
    log("fused crossing: " + json.dumps(dict(ticks=cross_ticks, errors=cerrs)))
    if not (cinfo["phase_times"]["fused"] > 0.0 and cinfo["phase_times"]["fused_abort"] > 0.0):
        raise AssertionError(f"fused crossing: no segment ran and rolled back: "
                             f"{cinfo['phase_times']}")
    if device == "cuda":
        _check_path_launches("fused crossing", cinfo["launches"])
    return info["launches"], by_shape, cinfo["launches"], cross["fused"][2], result


def kernel_summary(cases, paths, per):
    """One entry per kernel for the ``{"kernels": [...]}`` line.  ``launches``
    is the count of the kernel's main path: the trajectory phase for the
    forward kernels, the ladder phase for the length VJP kernels, the
    validation phase for the points cotangent; its top-level
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
        "rbf_gram_vjp_points": ("gple_tpu_torch/csrc/rbf_vjp.cu",
                                "gple_tpu/validation.py:98-104 (no Pallas kernel: XLA's "
                                "autodiff of gple_tpu/ops/kernels.py:gram with respect to the "
                                "points inside jax.grad)", "validation"),
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


def _keys(cases) -> set:
    """The ``LAUNCHES_BY_SHAPE`` keys of checked cases."""
    return {(c["key"][0], tuple(c["key"][1])) for c in cases}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from gple_tpu_torch.ops import _build
    from gple_tpu_torch.ops import gram_kernels as GK
    from gple_tpu_torch.ops import kernel_bench as KB

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
    cases += new_shapes_phase("trajectory / crossing", (), traj_by_shape, cross_by_shape)
    cases += vjp_phase()
    ladder_launches, ladder_by_shape, _ = ladder_phase()
    ladder_agreement_phase()
    zoom_agreement_phase()
    rp_launches, rp_by_shape, resume_by_shape, _ = parity_phase()
    cases += new_shapes_phase("ladder / reference parity", _keys(cases), ladder_by_shape,
                              rp_by_shape, resume_by_shape)
    _, se_res, shots, val_dvr = oracles_phase()
    val_launches, val_by_shape, _ = validation_phase(se_res, shots, val_dvr)
    del se_res, shots, val_dvr
    cases += new_shapes_phase("validation", _keys(cases), val_by_shape,
                              extra=KB.POINTS_VJP_CASES)
    boost_launches, boost_by_shape, boost_drv = booster_phase()
    booster_agreement(boost_drv)
    del boost_drv
    cases += new_shapes_phase("booster", _keys(cases), boost_by_shape)
    ecr_launches, ecr_by_shape, _ = ecr_phase()
    cases += new_shapes_phase("ecr", _keys(cases), ecr_by_shape)
    shard_launches, shard_by_shape, _ = sharding_phase()
    prof_launches, prof_by_shape, _ = profile_phase()
    graph_launches, graph_by_shape, _ = graph_phase()
    fused_launches, fused_by_shape, fcross_launches, fcross_by_shape, _ = fused_phase()
    cases += new_shapes_phase("sharding / profile / graphs / fused", _keys(cases),
                              shard_by_shape, prof_by_shape, graph_by_shape, fused_by_shape,
                              fcross_by_shape)
    walk_launches, walk_by_shape, _ = walk_phase()
    band_launches, band_by_shape, _ = band_phase()
    cases += new_shapes_phase("walks / band", _keys(cases), walk_by_shape, band_by_shape)
    paths = {"slice": (slice_launches, slice_by_shape),
             "trajectory": (traj_launches, traj_by_shape),
             "crossing": (cross_launches, cross_by_shape),
             "ladder": (ladder_launches, ladder_by_shape),
             "reference_parity": (rp_launches, rp_by_shape),
             "validation": (val_launches, val_by_shape),
             "booster": (boost_launches, boost_by_shape),
             "ecr": (ecr_launches, ecr_by_shape),
             "sharding": (shard_launches, shard_by_shape),
             "profile": (prof_launches, prof_by_shape),
             "graph": (graph_launches, graph_by_shape),
             "fused": (fused_launches, fused_by_shape),
             "fused_crossing": (fcross_launches, fcross_by_shape),
             "walks": (walk_launches, walk_by_shape),
             "band": (band_launches, band_by_shape)}

    print(json.dumps({"kernels": kernel_summary(cases, paths, per)}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
