"""How ``correct`` is decided: the program's trajectory held to the plain
reference (:mod:`bench_h100.reference`) at the timed sizes.

During a span the harness keeps, at each output, the state the driver holds
and its record (:class:`Snap`).  After the window, for the last completed
span:

* runs of outputs one reoptimization period apart, from one whose state is
  the driver's state at its tick (the state after the initialization, a
  chunked output, a fused segment's last) to the next such: a chunked pair
  ``t`` -> ``t + P``, or a whole clean fused segment.  The reference follows
  every tick from it (evolve, activation test, refit) and each period end
  (re-selection test, moment reoptimization, refit), and computes the
  observables of each output, compared with the program's records; at the
  run's last output the state and the moment parameters are compared too:
  points and labels where no cloud was re-selected, and the labels the
  program gave a re-selected cloud's new points against the reference's
  prediction there;
* the span's end: the moment parameters the program chose, the observables
  of the last record from the reference's own fit, the extra cloud's labels
  at the program's extra points, and with writers the last line of
  ``ave.txt`` as written;
* the program's decisions that no element appeared and no cloud was
  re-selected, as the reference's ratios to the thresholds, below 1.

The period-end step follows the configuration's optimizer
(``cfg.opt_mode``).  With ``"moment"`` the reference reoptimizes by moments
and compares its parameters with the program's.  With ``"ladder"`` (the
constrained restart ladder of ``reference_parity``) it takes the program's
new parameters and holds the ladder that chose them to
:mod:`bench_h100.reference.ladder` on the state the ladder saw, the extra
cloud the reference followed with the points included: the reported error
and averages of the accepted stage (``ladder_gap``), the magnitudes
(``param_gap``), the stationarity of loss + lam . c with the program's
multipliers (``kkt``: the median over the diagonal passes the run compares;
``kkt_full``: over the full passes) and each stage's 5% acceptance
(``decisions``); with the coherence active the ladder's result is its full
pass's (the coherence's parameters with the lengths, the coupled fit's
errors and purity, the full pass's multipliers, the coherence's magnitude
too); then it refits with those parameters, checks the regenerated extra
cloud's labels (``state_gap``) and follows on.  The initialization's ladder is held to the
same at tick 0.

A chunked pair is skipped where the program recorded an event inside the
period (an element appearing, a conservation-drift reoptimization), whose
draws the reference cannot follow; a fused segment that met an event was
rolled back and reported nothing."""

from __future__ import annotations

import math
import os
import statistics
from typing import NamedTuple, Optional

import numpy as np
import torch

from bench_h100.reference import coupled as CP
from bench_h100.reference import follow as F
from bench_h100.reference import ladder as L

#: floor of the scale a gap is taken against
FLOOR = 1e-3
#: fields of a record the check compares
RECORD_FIELDS = ("population_prm", "population_prm_each", "population_mci", "energy_prm",
                 "energy_mci", "purity_prm", "x_average")
#: most runs of outputs a check compares (drawn from the seed; the last one always)
MAX_RUNS = 4


class Snap(NamedTuple):
    """The driver's state at an output (:meth:`Recorder.__call__`)."""

    tick: int
    fused: bool            # reported by a fused segment
    density: tuple         # the driver's Density (points, rho, active)
    extra: tuple
    params: tuple          # host copies of the optimizer's parameters
    div: float             # the coherence length divisor in force
    record: object
    stages: tuple = ()     # the ladder's stages that chose ``params`` (host dicts)


def _tensor(v, dtype, device):
    """A host value of the program's as a tensor of ``dtype`` on ``device``."""
    return torch.as_tensor(np.asarray(v, dtype=np.float64)).to(device=device, dtype=dtype)


def params_of(snap: Snap, dtype, device) -> F.Params:
    return F.Params(*(_tensor(v, dtype, device) for v in snap.params))


def valid_states(snaps):
    """Which snaps hold the driver's state at their own tick: every chunked one,
    and a fused segment's last (its records are reported after the segment)."""
    out = []
    for i, s in enumerate(snaps):
        nxt = snaps[i + 1] if i + 1 < len(snaps) else None
        out.append(not s.fused or nxt is None or not nxt.fused
                   or nxt.density.points is not s.density.points)
    return out


def runs_of(snaps, events, period: int):
    """(i, j, kind) for each run of outputs one period apart from a snap ``i``
    that holds its state to the next one ``j`` that does: "segment" where
    ``i + 1 .. j`` are the records of one clean fused segment (the reference
    follows all its ticks), "chunked" where ``j = i + 1`` is a chunked
    output with no event recorded before its tick."""
    valid = valid_states(snaps)
    out = []
    for i in range(len(snaps) - 1):
        if not valid[i]:
            continue
        j = next((j for j in range(i + 1, len(snaps)) if valid[j]), None)
        if j is None:
            continue
        chain = snaps[i:j + 1]
        if any(b.tick - a.tick != period or b.div != chain[0].div
               for a, b in zip(chain, chain[1:])):
            continue
        a, b = snaps[i], snaps[j]
        if all(s.fused for s in chain[1:]):
            out.append((i, j, "segment"))
        elif (j == i + 1 and not b.fused and not any(a.tick < e < b.tick for e in events)
              and bool(torch.equal(a.density.active, b.density.active))):
            out.append((i, j, "chunked"))
    return out


def record_values(rec) -> np.ndarray:
    return np.concatenate([np.atleast_1d(np.asarray(getattr(rec, f), dtype=np.float64))
                           for f in RECORD_FIELDS])


def obs_values(obs: dict) -> np.ndarray:
    return np.concatenate([np.atleast_1d(obs[f].detach().double().cpu().numpy())
                           for f in RECORD_FIELDS])


def gap(prog, ref, floor: float = FLOOR) -> float:
    """max |program - reference| / max(|reference|, floor), elementwise."""
    prog, ref = np.asarray(prog, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    if prog.shape != ref.shape or not np.all(np.isfinite(prog)):
        return math.inf
    return float(np.max(np.abs(prog - ref) / np.maximum(np.abs(ref), floor)))


def array_gap(prog, ref) -> float:
    """max |program - reference| over max |reference|."""
    prog = prog.detach().double().cpu()
    ref = ref.detach().double().cpu()
    if prog.shape != ref.shape or not bool(torch.isfinite(prog).all()):
        return math.inf
    return float(torch.max(torch.abs(prog - ref)) / max(float(torch.max(torch.abs(ref))), 1e-300))


class Outcome:
    """The numbers compared, each the worst over what was compared."""

    def __init__(self):
        self.values = dict(obs_gap=0.0, state_gap=0.0, param_gap=0.0, decisions=0.0, pairs=0)
        self.notes = []
        #: each compared ladder's stationarity (:func:`check_ladder`): the
        #: diagonal passes', and the full passes' (the coherence active)
        self.stationarity = []
        self.stationarity_full = []

    def worst(self, name: str, value: float):
        v = float(value)
        self.values[name] = v if math.isnan(v) else max(self.values.get(name, 0.0), v)


def _cast(t, dtype, device):
    return t.to(device=device, dtype=dtype)


def _cutoff(cfg) -> bool:
    """Whether the evolve (and the labels it gives) uses the cutoff means."""
    if cfg.evolve_cutoff not in (False, True):
        raise ValueError(f"the reference has no evolve_cutoff={cfg.evolve_cutoff!r}")
    return cfg.evolve_cutoff


def _ladder_reading(rel: float, accepted: bool) -> float:
    """A stage's 5% rule as a ratio below 1 where the reference agrees: its
    largest violation over the tolerance for a stage the program accepted,
    the tolerance over it for one the program rejected."""
    return rel / L.TOLERANCE if accepted else L.TOLERANCE / max(rel, 1e-300)


def check_ladder(cfg, s: Snap, pts, rho, act, extra, goal, out: Outcome, dtype, device,
                 program=None):
    """The ladder whose result ``s`` holds, on the state (``pts``, ``rho``, the
    extra cloud ``extra``) it optimized over, against the targets ``goal``
    (or, for the control, against ``program``: the same readings in float64).
    With the coherence active the ladder's result is its full pass's: the
    lengths and the coherence's parameters, the joint error, the averages
    with the coherence's purity, the magnitudes with the coherence's, and the
    full pass's multipliers (row 1 of a stage's).  Returns the readings the
    control is held to."""
    prob = L.problem(cfg.model, cfg.mass, pts, rho, act, extra[0], extra[1], goal)
    rows = list(prob.surfaces)
    full = prob.xo is not None
    t = lambda v: _tensor(v, dtype, device)
    off_of = lambda v: t(v) if full else None
    stages = [torch.cat([loss[None], avgs]) for loss, avgs in
              (L.evaluate(t(st["diag_lengths"])[rows], prob, off_of(st["off_params"]))
               for st in s.stages)]
    acc = [i for i, st in enumerate(s.stages) if st["accepted"]][-1]
    lengths, off = t(s.params[0])[rows], off_of(s.params[2])
    rel = [float(torch.max(L.violations(v[1:], prob))) for v in stages]
    stages = [v.detach().double().cpu().numpy() for v in stages]
    mags = [L.magnitudes(lengths, prob.x, prob.y)]
    if full:
        mags.append(CP.magnitude(L.coherence_fit(off, prob))[None])
    res = dict(stages=stages, mags=mags, rel=rel)
    kkt = L.kkt(lengths, t(s.stages[acc]["lam"][1 if full else 0][:3]), prob, off)
    (out.stationarity_full if full else out.stationarity).append(kkt)
    out.notes.append(f"ladder at tick {s.tick}: stages "
                     f"{'/'.join(st['tag'] for st in s.stages)}, took {s.stages[acc]['tag']}"
                     f"{' (full pass)' if full else ''}: stationarity {kkt:.3g}, largest "
                     f"violation {rel[acc]:.3g}")
    if program is None:
        st = s.stages[acc]
        out.worst("ladder_gap", gap([st["error"], *st["averages"]], stages[acc]))
        prog = [t(s.params[1])[rows], t(s.params[3])[None]]
        for p, m in zip(prog, mags):
            out.worst("param_gap", array_gap(p, m))
        for st, r in zip(s.stages, rel):
            out.worst("decisions", _ladder_reading(r, not np.any(st["check"])))
    else:
        out.worst("ladder_gap", gap(stages[acc], program["stages"][acc]))
        for m, p in zip(mags, program["mags"]):
            out.worst("param_gap", array_gap(m, p))
        for r_ctl, r_ref in zip(rel, program["rel"]):
            out.worst("decisions", _ladder_reading(r_ref, r_ctl < L.TOLERANCE))
    return res


def check_run(cfg, a: Snap, bs, kind: str, out: Outcome, dtype, device, program=None,
              goal=None):
    """The reference from ``a`` over the periods up to each of ``bs`` against
    its record, and at the last the state and parameters (or, for the
    control, against ``program``: the same outputs computed another way).
    A ladder cell's period ends are held to the ladder's targets ``goal``."""
    ladder = cfg.opt_mode == "ladder"
    pts = _cast(a.density.points, dtype, device)
    rho = _cast(a.density.rho, dtype, device)
    act = tuple(bool(v) for v in a.density.active.cpu())
    params = params_of(a, dtype, device)
    extra = ((_cast(a.extra.points, dtype, device), _cast(a.extra.rho, dtype, device))
             if ladder else None)
    res = dict(obs=[], ladder=[], labels=[])
    for b in bs:
        pts, rho, before, ratios, extra = F.follow(cfg.model, cfg.mass, cfg.dt, pts, rho,
                                                   act, params, cfg.reopt_freq,
                                                   _cutoff(cfg), extra)
        if bool((ratios >= 1.0).any()) and kind == "chunked":
            out.notes.append(f"pair {a.tick}->{b.tick}: an element appears; skipped")
            return None
        out.worst("decisions", float(ratios.max()))
        drift = F.drift_ratios(pts, rho, act) if cfg.track_clouds else torch.zeros(3)
        reselected = False
        if kind == "chunked":
            bp = _cast(b.density.points, dtype, device)
            br = _cast(b.density.rho, dtype, device)
            post_pts, post_rho = pts.clone(), rho.clone()
            for k in range(3):
                moved = float(torch.max(torch.abs(bp[k] - pts[k])))
                if act[k] and moved > 1e-6 * (1.0 + float(torch.max(torch.abs(pts[k])))):
                    # the program re-selected this cloud: its labels at its points
                    out.worst("decisions", 1.0 / max(float(drift[k]), 1e-300))
                    reselected = True
                    ref_lab = F.relabel(cfg.model, cfg.mass, cfg.dt, bp[k], k, before,
                                        _cutoff(cfg))
                    out.worst("state_gap", array_gap(br[k], ref_lab) if program is None
                              else 0.0)
                    res[f"relabel{k}"] = ref_lab
                    post_pts[k], post_rho[k] = bp[k], br[k]
                else:
                    out.worst("decisions", float(drift[k]))
            if program is None:
                # every cloud not re-selected: the program's points and labels
                out.worst("state_gap", array_gap(bp, post_pts))
                out.worst("state_gap", array_gap(br, post_rho))
            pts, rho = post_pts, post_rho
        else:
            out.worst("decisions", float(drift.max()))
        if not ladder:
            params = F.moment(pts, rho, act, params, b.div)
        elif reselected:
            # the re-selection walked the extra cloud too, which the reference
            # does not follow
            out.notes.append(f"pair {a.tick}->{b.tick}: a cloud was re-selected; "
                             "its ladder is not compared")
            params = params_of(b, dtype, device)
        else:
            prog = None if program is None else program["ladder"][len(res["ladder"])]
            lad = check_ladder(cfg, b, pts, rho, act, extra, goal, out, dtype, device, prog)
            res["ladder"].append(lad)
            params = params_of(b, dtype, device)
        fits = F.fit(params, pts, rho, act)
        res["obs"].append(obs_values(F.observe(cfg.model, cfg.mass, pts, rho, act, fits)))
        if ladder:
            # the extra cloud the period end regenerated: the program's
            # points, labeled by the new fit
            e_pts = _cast(b.extra.points, dtype, device)
            labels = F.dist(fits, _cutoff(cfg))(e_pts)
            prog_labels = (_cast(b.extra.rho, dtype, device) if program is None
                           else program["labels"][len(res["labels"])])
            for k in range(3):
                if act[k]:
                    out.worst("state_gap", array_gap(prog_labels[k], labels[k]))
            res["labels"].append(labels)
            extra = (e_pts, labels)
    res.update(pts=pts, rho=rho, params=torch.cat([p.reshape(-1) for p in params]))
    last = bs[-1]
    if program is None:
        for b, obs in zip(bs, res["obs"]):
            out.worst("obs_gap", gap(record_values(b.record), obs))
        if not ladder:
            prog = torch.cat([p.reshape(-1) for p in params_of(last, torch.float64, device)])
            out.worst("param_gap", array_gap(prog, res["params"]))
        if kind == "segment":
            # the segment's end state, with no cloud re-selected inside it
            out.worst("state_gap", array_gap(last.density.points, pts))
            out.worst("state_gap", array_gap(last.density.rho, rho))
    else:
        for obs, prog in zip(res["obs"], program["obs"]):
            out.worst("obs_gap", gap(obs, prog))
        for k in range(3):
            if f"relabel{k}" in res:
                out.worst("state_gap", array_gap(res[f"relabel{k}"], program[f"relabel{k}"]))
        out.worst("state_gap", array_gap(res["pts"], program["pts"]))
        out.worst("state_gap", array_gap(res["rho"], program["rho"]))
        if not ladder:
            out.worst("param_gap", array_gap(res["params"], program["params"]))
    out.values["pairs"] += 1
    return res


def check_end(cfg, s: Snap, out: Outcome, dtype, device, program=None, outdir=None):
    """The span's last state: its moment parameters (a ladder cell's: its
    magnitudes at its lengths, the coherence's at its parameters), its
    record's observables from the reference's fit, the extra cloud's labels,
    the written averages."""
    ladder = cfg.opt_mode == "ladder"
    pts = _cast(s.density.points, dtype, device)
    rho = _cast(s.density.rho, dtype, device)
    act = tuple(bool(v) for v in s.density.active.cpu())
    new = (params_of(s, dtype, device) if ladder
           else F.moment(pts, rho, act, params_of(s, dtype, device), s.div))
    fits = F.fit(new, pts, rho, act)
    obs = F.observe(cfg.model, cfg.mass, pts, rho, act, fits)
    e_pts = _cast(s.extra.points, dtype, device)
    labels = F.dist(fits, _cutoff(cfg))(e_pts)
    res = dict(params=torch.cat([p.reshape(-1) for p in new]), obs=obs_values(obs),
               labels=labels, written=F.written_row(cfg.model, cfg.mass, pts, rho, act, fits))
    if ladder:
        rows = [d for d, k in enumerate(F.DIAG) if act[k]]
        res["params"] = L.magnitudes(new.diag_lengths[rows], [pts[F.DIAG[d]] for d in rows],
                                     [rho[F.DIAG[d], :, 0] for d in rows])
        if act[1]:
            one = torch.ones((), dtype=dtype, device=device)
            res["off_mag"] = CP.magnitude(CP.fit(one, new.off, pts[1], rho[1]))[None]
    if program is None:
        prog = params_of(s, torch.float64, device)
        if "off_mag" in res:
            out.worst("param_gap", array_gap(prog.off_mag[None], res["off_mag"]))
        prog = prog.diag_mags[rows] if ladder else torch.cat([p.reshape(-1) for p in prog])
        out.worst("param_gap", array_gap(prog, res["params"]))
        out.worst("obs_gap", gap(record_values(s.record), res["obs"]))
        for k in range(3):
            if act[k]:
                out.worst("state_gap", array_gap(s.extra.rho[k], labels[k]))
        if outdir is not None:
            out.worst("written_gap", written_gap(outdir, res["written"]))
    else:
        out.worst("param_gap", array_gap(res["params"], program["params"]))
        if "off_mag" in res:
            out.worst("param_gap", array_gap(res["off_mag"], program["off_mag"]))
        out.worst("obs_gap", gap(res["obs"], program["obs"]))
        for k in range(3):
            if act[k]:
                out.worst("state_gap", array_gap(res["labels"][k], program["labels"][k]))
        if outdir is not None:
            idx = sorted(program["written"])
            out.worst("written_gap", gap([res["written"][i] for i in idx],
                                         [program["written"][i] for i in idx]))
    return res


def written_gap(outdir: str, ref: dict) -> float:
    """The last line of ``ave.txt`` against the reference's values of its fields."""
    with open(os.path.join(outdir, "ave.txt")) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    row = np.array([float(v) for v in lines[-1].split()])
    idx = sorted(ref)
    return gap(row[idx], [ref[i] for i in idx])


def choose_runs(runs, seed: int):
    """At most :data:`MAX_RUNS`: the last, and others drawn from the seed."""
    if len(runs) <= MAX_RUNS:
        return runs
    rng = np.random.default_rng(seed)
    rest = sorted(rng.choice(len(runs) - 1, MAX_RUNS - 1, replace=False).tolist())
    return [runs[i] for i in rest] + [runs[-1]]


def goal_of(cfg, first: Snap, dtype, device):
    """The ladder's targets (1, E0, P0) from the state at tick 0."""
    if first.tick != 0:
        raise ValueError("the ladder's targets are taken from the record of tick 0")
    return L.targets(cfg.model, cfg.mass, cfg.initial_population,
                     _cast(first.density.points, dtype, device),
                     _cast(first.density.rho, dtype, device))


def check_init(cfg, s: Snap, out: Outcome, dtype, device, program=None):
    """The initialization's ladder, on the state at tick 0 that it optimized
    over: the points and the extra cloud drawn from the initial distribution."""
    act = tuple(bool(v) for v in s.density.active.cpu())
    pts, rho = _cast(s.density.points, dtype, device), _cast(s.density.rho, dtype, device)
    extra = (_cast(s.extra.points, dtype, device), _cast(s.extra.rho, dtype, device))
    return check_ladder(cfg, s, pts, rho, act, extra, goal_of(cfg, s, dtype, device), out,
                        dtype, device, program)


def evaluate(cfg, snaps, events, seed: int, device, outdir: Optional[str] = None,
             control_dtype=None) -> Outcome:
    """The outcome of one span's snaps; with ``control_dtype`` the control:
    the reference computed in that precision in the program's place, held to
    the reference in float64."""
    out = Outcome()
    if outdir is not None:
        out.values["written_gap"] = 0.0
    if cfg.output_freq != cfg.reopt_freq:
        raise ValueError("the check pairs outputs one reoptimization period apart")
    ladder = cfg.opt_mode == "ladder"
    if ladder:
        out.values.update(ladder_gap=0.0)
        if control_dtype is None:
            check_init(cfg, snaps[0], out, torch.float64, device)
        else:
            ref = check_init(cfg, snaps[0], Outcome(), torch.float64, device)
            check_init(cfg, snaps[0], out, control_dtype, device, program=ref)
    goal = goal_of(cfg, snaps[0], torch.float64, device) if ladder else None
    for i, j, kind in choose_runs(runs_of(snaps, events, cfg.reopt_freq), seed):
        a, bs = snaps[i], snaps[i + 1:j + 1]
        if control_dtype is None:
            check_run(cfg, a, bs, kind, out, torch.float64, device, goal=goal)
        else:
            ref = check_run(cfg, a, bs, kind, Outcome(), torch.float64, device, goal=goal)
            if ref is not None:
                check_run(cfg, a, bs, kind, out, control_dtype, device, program=ref,
                          goal=goal_of(cfg, snaps[0], control_dtype, device) if ladder
                          else None)
    if ladder:
        # the zoom L-BFGS may stop short of stationarity on one ladder of a
        # span (its line search fails): the run's median ladder is compared;
        # the full passes' apart (``kkt_full``), which stop short as a rule
        out.values["kkt"] = statistics.median(out.stationarity)
        if out.stationarity_full:
            out.values["kkt_full"] = statistics.median(out.stationarity_full)
    last = [s for s, ok in zip(snaps, valid_states(snaps)) if ok][-1]
    if control_dtype is None:
        check_end(cfg, last, out, torch.float64, device, outdir=outdir)
    else:
        ref = check_end(cfg, last, Outcome(), torch.float64, device,
                        outdir=outdir)
        check_end(cfg, last, out, control_dtype, device, program=ref, outdir=outdir)
    return out


def verdict(out: Outcome, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: [value, limit]}); ``pairs`` has a least value."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = out.values.get(name)
        if value is None:
            continue
        if name == "pairs":
            good = value >= limit
        else:
            good = math.isfinite(value) and value <= limit
        ok &= good
        checks[name] = [value, limit]
    return ok, checks
