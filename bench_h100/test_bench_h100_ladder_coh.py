"""The ladder reference with the coherence active against the program's
full pass on the CPU at N = 64: the joint loss, the averages and the
gradient through autograd, at the state of Tully's dual avoided crossing at
tick 10.  :func:`tiny_root` makes the tiny cell (``tiny.coh``) the
whole-run tests share."""

import json
import shutil

import pytest
import torch

from bench_h100 import harness as H
from bench_h100.reference import ladder as L
from gple_tpu_torch import observables as OBS
from gple_tpu_torch.config import GPLEConfig
from gple_tpu_torch.driver import GPLEDriver
from gple_tpu_torch.gp import opt as O

TINY = "tiny.coh"
#: the tiny cell's trajectory: the coherence and the excited state appear at
#: ticks 1 and 2, and no cloud is re-selected, so the tick-20 ladder is
#: compared
TRAJECTORY = 2 ** 31 + 26
#: the tiny cell's limits, each between the program's largest reading and
#: the float32 control's smallest over trajectories 2**31 + 22, 26, 37-46 on
#: the CPU: obs_gap 7.8e-6 | 2.1e-4, state_gap 1.1e-5 | 1.4e-3, ladder_gap
#: 4.0e-5 | 1.5e-3, kkt 3.2e-6 | 2.0e-2; param_gap 4.3e-5 | 1.6e-5 (the
#: control's smallest where its tick-20 ladder was not compared) separates
#: nothing and is held above the program's.  The program's gaps reach 1e-5
#: where the coherence's joint prior is near singular (corr = 1, its parts'
#: lengths close); the full passes' stationarity (``kkt_full``: 2.8e-4-1.6
#: against the control's 0.31-1) is not compared
LIMITS = dict(obs_gap=1e-4, state_gap=2e-4, param_gap=1e-4, ladder_gap=3e-4, kkt=2e-3,
              decisions=1.0, pairs=1)


def _gple(n: int) -> dict:
    """The band row's packet on Tully's dual avoided crossing
    (``tully_dac_n256``) with the reference program's own algorithm."""
    return dict(H.read_json(H.BENCH / "configs" / "tully_dac_n256.json")["gple"],
                num_points=n, reference_parity=True)


def tiny_root(root):
    """A checkout at ``root`` with one cell, ``tiny.coh``: a 20-tick span of
    the reference-parity trajectory on the dual avoided crossing at N = 64,
    the coherence active from tick 2 and the ladders at ticks 10 and 20
    running the full pass; the ladder cell's per-layer readers."""
    torch.set_num_threads(2)
    bench = root / "bench_h100"
    for sub in ("configs", "traffic", "limits"):
        (bench / sub).mkdir(parents=True)
    shutil.copytree(H.BENCH / "metrics", bench / "metrics")
    manifest = H.read_json(H.ROOT / "BENCHMARK.json")
    manifest["configs"] = [dict(name="tiny", source="-", file="bench_h100/configs/tiny.json",
                                reduced=["num_points"], why="-")]
    manifest["workloads"] = [dict(name=TINY, config="tiny", traffic="coh", chips=1, why="-")]
    for m in manifest["per_layer"]:
        m["workloads"] = [TINY] if "sac1024.ladder" in m["workloads"] else []
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    (bench / "configs" / "tiny.json").write_text(json.dumps(dict(name="tiny", gple=_gple(64))))
    traffic = dict(span_ticks=20, writers=False, overrides={}, warm_ticks=1,
                   trajectory_seed=TRAJECTORY)
    (bench / "traffic" / "coh.json").write_text(json.dumps(traffic))
    (bench / "limits" / f"{TINY}.json").write_text(json.dumps(LIMITS))
    return root


# -- the full pass's reference against the program ---------------------------------

@pytest.fixture(scope="module")
def at10():
    """The program's state at tick 10 of the tiny cell's trajectory, the
    coherence active."""
    torch.set_num_threads(2)
    drv = GPLEDriver(GPLEConfig(**dict(_gple(64), seed=TRAJECTORY)), device="cpu")
    drv.run(max_ticks=10)
    assert bool(drv.density.active.all())
    return drv


def _program(drv):
    d, e = drv.density, drv.extra
    act = tuple(bool(a) for a in d.active)
    energies = OBS.total_energy_each_surface(drv.cfg.model, d, drv.cfg.mass)
    data, _ = drv.optimizer._pack_data(d, e, energies)
    data = {k: v.clone() for k, v in data.items()}
    goal = data["targets"].clone()
    prob = L.problem(drv.cfg.model, drv.cfg.mass, d.points, d.rho, act, e.points, e.rho, goal)
    return data, prob


def _full_lc(z, nd, data):
    """The program's full pass at the sigmoid coordinates ``z``: its loss and
    relative constraint violations (``gp/opt.py:_run_stage``'s ``full_lc``)."""
    lengths = O._sigmoid_to_bounds(z[:nd].reshape(2, -1), data["dlb"], data["dub"])
    off = O._sigmoid_to_bounds(z[nd:], data["olb"], data["oub"])
    dstates = O._diag_states(lengths, data)
    ostate = O._off_state(off, data)
    avgs = O._averages_from_states(dstates, ostate, data)
    loss = O._diag_loss_from_states(dstates, data) + O._off_loss_from_state(ostate, data)
    scale = torch.clamp(torch.abs(data["targets"]), min=1e-3)
    return loss, (avgs - data["targets"]) / scale


def test_full_pass_bounds(at10):
    data, prob = _program(at10)
    assert torch.allclose(prob.olb, data["olb"][:-1], rtol=1e-12)
    assert torch.allclose(prob.oub, data["oub"][:-1], rtol=1e-12)
    assert float(data["olb"][-1]) == float(data["oub"][-1]) == L.CORR


@pytest.mark.parametrize("scale", [1.0, 0.8])
def test_full_pass_loss_averages_and_gradient(at10, scale):
    data, prob = _program(at10)
    o = at10.optimizer
    lengths = torch.as_tensor(o.diag_lengths) * scale
    off = torch.as_tensor(o.off_params).clone()
    off[:-1] = off[:-1] * scale ** 0.5
    lam = torch.tensor([3.0, -2.0, 5.0], dtype=torch.float64)
    zd = O._bounds_to_sigmoid(lengths, data["dlb"], data["dub"])
    zo = O._bounds_to_sigmoid(off, data["olb"], data["oub"])
    z = torch.cat([zd.reshape(-1), zo]).requires_grad_(True)
    loss, cons = _full_lc(z, zd.numel(), data)
    (grad,) = torch.autograd.grad(loss + torch.sum(lam * cons), z)
    # the reference at the parameters the program's coordinates give
    lengths = O._sigmoid_to_bounds(zd, data["dlb"], data["dub"])
    off = O._sigmoid_to_bounds(zo, data["olb"], data["oub"])
    ref_loss, ref_avgs = L.evaluate(lengths, prob, off)
    assert torch.allclose(ref_loss, loss.detach(), rtol=1e-10)
    avgs = cons.detach() * torch.clamp(torch.abs(data["targets"]), min=1e-3) + data["targets"]
    assert torch.allclose(ref_avgs[:2], avgs[:2], rtol=1e-10)
    # at corr = 1 the coherence's joint prior is near singular where its
    # parts' lengths agree (cond(M) ~ 1e7 here): its purity integral, a small
    # difference of large terms, carries the program's solve residual (a
    # hundred times the reference's) at ~1e-5 of itself
    coh = 2.0 * L.CP.purity(L.coherence_fit(off, prob))
    assert abs(float(ref_avgs[2] - avgs[2])) <= 1e-10 * float(avgs[2]) + 1e-4 * float(coh)
    g_f, g_c = L.gradients(lengths, lam, prob, off)
    # corr's zero-width box is no coordinate of the reference's
    want = grad[:-1]
    assert float(grad[-1]) == 0.0
    assert torch.allclose(g_f + g_c, want, rtol=1e-9, atol=1e-10 * float(want.abs().max()))
