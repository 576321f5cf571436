"""The ladder's plain reference against the program on the CPU: the loss,
averages, magnitudes and augmented-Lagrangian gradient at N = 64, and the
cutoff evolve followed against the program's chunked ticks."""

import dataclasses

import numpy as np
import pytest
import torch

from bench_h100 import harness as H
from bench_h100.reference import follow as F
from bench_h100.reference import ladder as L
from gple_tpu_torch import observables as OBS
from gple_tpu_torch.config import GPLEConfig
from gple_tpu_torch.driver import GPLEDriver
from gple_tpu_torch.storage import predict_all
from gple_tpu_torch.gp import opt as O

def _config(n: int, seed: int = 2 ** 31 + 3) -> GPLEConfig:
    gple = H.read_json(H.BENCH / "configs" / "tully_sac_n1024_parity.json")["gple"]
    return GPLEConfig(**dict(gple, num_points=n, seed=seed))


@pytest.fixture(scope="module")
def init64():
    torch.set_num_threads(2)
    drv = GPLEDriver(_config(64), device="cpu")
    drv.run(max_ticks=0)
    return drv


def _program(drv):
    """The program's ladder data at its state, and the reference's problem."""
    d, e = drv.density, drv.extra
    act = tuple(bool(a) for a in d.active)
    energies = OBS.total_energy_each_surface(drv.cfg.model, d, drv.cfg.mass)
    data, _ = drv.optimizer._pack_data(d, e, energies)
    data = {k: v.clone() for k, v in data.items()}
    goal = L.targets(drv.cfg.model, drv.cfg.mass, drv.cfg.initial_population,
                     d.points.clone(), d.rho.clone())
    prob = L.problem(drv.cfg.model, drv.cfg.mass, d.points, d.rho, act, e.points, e.rho, goal)
    return data, prob


def test_targets_and_bounds(init64):
    data, prob = _program(init64)
    assert torch.allclose(prob.targets, data["targets"], rtol=1e-12)
    assert torch.allclose(prob.lb, data["dlb"][list(prob.surfaces)], rtol=1e-12)
    assert torch.allclose(prob.ub, data["dub"][list(prob.surfaces)], rtol=1e-12)


@pytest.mark.parametrize("scale", [1.0, 0.7, 1.3])
def test_loss_averages_and_magnitudes(init64, scale):
    data, prob = _program(init64)
    rows = list(prob.surfaces)
    lengths = torch.as_tensor(init64.optimizer.diag_lengths) * scale
    with torch.no_grad():
        states = O._diag_states(lengths, data)
        loss = O._diag_loss_from_states(states, data)
        avgs = O._averages_from_states(states, None, data)
        mags = O.RK.optimal_magnitude(states)
    ref_loss, ref_avgs = L.evaluate(lengths[rows], prob)
    assert torch.allclose(ref_loss, loss, rtol=1e-10)
    assert torch.allclose(ref_avgs, avgs, rtol=1e-10)
    assert torch.allclose(L.magnitudes(lengths[rows], prob.x, prob.y), mags[rows], rtol=1e-10)


def test_augmented_lagrangian_gradient(init64):
    data, prob = _program(init64)
    rows = list(prob.surfaces)
    lengths = torch.as_tensor(init64.optimizer.diag_lengths)
    lam = torch.tensor([3.0, -2.0, 5.0], dtype=torch.float64)
    scale = torch.clamp(torch.abs(data["targets"]), min=1e-3)
    z = O._bounds_to_sigmoid(lengths, data["dlb"], data["dub"]).requires_grad_(True)
    states = O._diag_states(O._sigmoid_to_bounds(z, data["dlb"], data["dub"]), data)
    cons = (O._averages_from_states(states, None, data) - data["targets"]) / scale
    objective = O._diag_loss_from_states(states, data) + torch.sum(lam * cons)
    (grad,) = torch.autograd.grad(objective, z)
    # the reference at the lengths the program's coordinates give
    g_f, g_c = L.gradients(O._sigmoid_to_bounds(z.detach(), data["dlb"], data["dub"])[rows],
                           lam, prob)
    # each component to 1e-10 of itself or of the gradient's largest
    assert torch.allclose(g_f + g_c, grad[rows], rtol=1e-10,
                          atol=1e-10 * float(grad.abs().max()))


def test_cutoff_follow_against_the_chunked_ticks():
    torch.set_num_threads(2)
    cfg = dataclasses.replace(_config(24), fused_chunk=0)
    drv = GPLEDriver(cfg, device="cpu")
    drv.run(max_ticks=0)
    d, e, o = drv.density, drv.extra, drv.optimizer
    act = tuple(bool(a) for a in d.active)
    t = lambda v: torch.as_tensor(np.asarray(v, dtype=np.float64))
    params = F.Params(t(o.diag_lengths), t(o.diag_magnitudes), t(o.off_params),
                      t(o.off_magnitude))
    # the reference keeps the coherence inactive: its fit is never made
    assert not act[1] and cfg.evolve_cutoff is True
    drv_gps = drv.gps
    pts, rho, _, ratios, extra = F.follow(cfg.model, cfg.mass, cfg.dt, d.points, d.rho, act,
                                          params, 9, cutoff=True, extra=(e.points, e.rho))
    assert drv._advance_chunk(9)
    assert bool((ratios < 1.0).all())
    scale = lambda r: 1e-11 * float(r.abs().max())
    assert torch.allclose(pts, drv.density.points, rtol=1e-12, atol=1e-12)
    assert torch.allclose(rho, drv.density.rho, rtol=1e-9, atol=scale(rho))
    assert torch.allclose(extra[0], drv.extra.points, rtol=1e-12, atol=1e-12)
    assert torch.allclose(extra[1], drv.extra.rho, rtol=1e-9, atol=scale(extra[1]))
    # here the cutoff bites only where the mean is below its standard
    # deviation, values far below the tolerance; where it bites hard, off
    # the cloud, the reference's cutoff means are the program's
    fits = F.fit(params, d.points, d.rho, act)
    far = d.points + torch.linspace(-4.0, 4.0, d.points.shape[1])[None, :, None] * torch.tensor(
        [1.0, 3.0], dtype=torch.float64)
    cut, raw = F.dist(fits, True)(far), F.dist(fits, False)(far)
    want = predict_all(drv_gps, far, with_variance=True)
    assert torch.allclose(cut, want, rtol=1e-9, atol=scale(want))
    assert float((cut - raw).abs().max()) > 1e-3 * float(raw.abs().max())
