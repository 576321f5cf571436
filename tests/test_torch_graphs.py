"""PyTorch port: the CUDA graph helper (``gple_tpu_torch/ops/graphs.py``).

On the CPU a ``Graph`` runs its function eagerly, and ``copy_`` (the copy
of a function's results into its static state) reads every source before
it writes.  On the card (``gpu``): ten replays of the captured tick graph
against ten eager ``_tick_core`` ticks from the same state, bit for bit,
with the hand-written kernels' launches counted at every replay; and a
tuned Metropolis walk as graph replays against the same walk as the
straight loop, bit for bit; the ladder's zoom evaluations as graph
replays against the eager closures.  On the CPU besides: a graph that
differentiates, the tick's activation
test on the host's active tuple against the full test, the GP states'
active mask against the density's at every load of the tick graph's state,
and the ``small.pairs`` counter.  This file
imports no JAX, so it also runs where only the port is installed:
``python -m pytest --noconftest tests/test_torch_graphs.py``.
"""

import pytest
import torch

from gple_tpu_torch import driver as TD
from gple_tpu_torch.ops import graphs as GR
from gple_tpu_torch.utils import spans
from test_torch_kernels import _warm_torch_exp, cuda_device  # noqa: F401 (fixtures)
from test_torch_kernels import one_torch_thread  # noqa: F401 (fixture)


def test_copy_reads_sources_before_writing():
    a, b = torch.tensor([1.0]), torch.tensor([2.0])
    GR.copy_((a, b), (b, a))      # a swap: both copies read the old values
    assert (a.item(), b.item()) == (2.0, 1.0)
    with pytest.raises(ValueError):
        GR.copy_(torch.zeros(3), torch.zeros(1))


def test_clone_keeps_the_tree():
    density = TD.Density(points=torch.ones(3, 2, 2), rho=torch.zeros(3, 2, 2),
                         active=torch.tensor([True, False, True]))
    twin = GR.clone(density)
    assert isinstance(twin, TD.Density) and twin.points is not density.points
    assert all(torch.equal(a, b) for a, b in zip(GR.leaves(twin), GR.leaves(density)))
    assert len(GR.leaves({"x": (density, [torch.zeros(1)])})) == 4


def test_cpu_graph_runs_eagerly():
    state = torch.zeros(2)
    graph = GR.Graph(lambda: state.add_(1.0), state, "tick")
    graph()
    graph()
    assert state.tolist() == [2.0, 2.0] and graph.graph is None


def test_cpu_autograd_graph_differentiates():
    """A graph made with ``autograd=True`` runs its function in grad mode,
    inside the caller's inference mode too."""
    x, out = torch.tensor([1.0, -2.0]), torch.zeros(2)

    def grad_of_square():
        z = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(z**2), z)
        out.copy_(g)

    graph = GR.Graph(grad_of_square, (x, out), "zoom", autograd=True)
    with torch.inference_mode():
        graph()
    assert out.tolist() == [2.0, -4.0] and graph.graph is None


@pytest.mark.gpu
def test_graph_replays_match_eager_ticks(cuda_device):
    """Ten graphed ticks of ``trajectory_config(64)`` against ten eager
    :func:`_tick_core` calls from the same state, bit for bit, and the
    kernel launches counted at every replay."""
    from gple_tpu_torch.entry import trajectory_config
    from gple_tpu_torch.ops import gram_kernels as GK

    drv = TD.GPLEDriver(trajectory_config(64), device=cuda_device)
    drv.initialize()
    dp, op = drv.optimizer.fitted_params()
    density, extra, gps = drv.density, drv.extra, drv.gps
    for _ in range(10):
        density, extra, _, gps = TD._tick_core(
            drv.cfg.model, drv.cfg.mass, drv.cfg.dt, density, extra, gps, dp, op,
            drv._evolve_dist, "none", 0, 2.0, True)
    S, tick, _ = drv._programs(drv._host_active())
    drv._load(S)
    tick()                       # captures, then replays once
    drv._load(S)
    GK.reset_launches()
    for _ in range(10):
        tick()
    per_replay = sum(n for (name, _), n in tick.launches.items() if name == "rbf_gram")
    assert tick.graph is not None and per_replay > 0
    assert GK.LAUNCHES["rbf_gram"] == 10 * per_replay
    for ours, theirs in zip(GR.leaves((S.density, S.extra, S.gps)),
                            GR.leaves((density, extra, gps))):
        assert torch.equal(ours, theirs)


@pytest.mark.gpu
def test_graphed_walk_equals_the_eager_walk_on_the_card(cuda_device):
    """A tuned walk (sweep, recorded chain, chain) on a walk surrogate at
    M = 256, through graphs and through the straight loop, on one key."""
    import numpy as np

    from gple_tpu_torch.sampler import mc
    from gple_tpu_torch.sampler.keys import RandomKeys

    f64 = dict(dtype=torch.float64, device=cuda_device)
    xs = torch.linspace(-1.0, 1.0, TD._SURR_RES, **f64)
    grid = torch.exp(-4.0 * (xs[:, None] ** 2 + xs[None, :] ** 2))
    params = (grid, torch.tensor([-12.0, 22.0], **f64), torch.tensor([-8.0, 38.0], **f64))
    rng = np.random.default_rng(7)
    pts = torch.tensor(np.array([-10.0, 30.0]) + rng.normal(size=(256, 2)) * [0.5, 2.0], **f64)
    out = {}
    for name, chains in (("eager", None), ("graph", mc.Chains())):
        with torch.inference_mode(), spans.collect() as totals:
            p, r, tuned = mc.element_monte_carlo(RandomKeys(3, cuda_device),
                                                 TD._surrogate_dist, params, pts,
                                                 mc.MCParameters(), chains=chains)
        out[name] = (p, r, (tuned.num_steps, tuned.displacement), totals)
    assert out["graph"][3].calls("launch") > 0 and out["eager"][3].calls("launch") == 0
    assert out["graph"][3].calls("capture") > 0 and out["eager"][3].calls("capture") == 0
    assert out["graph"][2] == out["eager"][2]
    assert torch.equal(out["graph"][0], out["eager"][0])
    assert torch.equal(out["graph"][1], out["eager"][1])


@pytest.mark.gpu
def test_failed_chain_capture_raises(cuda_device):
    """A chain whose distribution pulls a value to the host runs eagerly
    (the capture's warm-up) but cannot be captured: the chain raises, and
    no eager loop takes over."""
    from gple_tpu_torch.sampler import mc
    from gple_tpu_torch.sampler.keys import RandomKeys

    def pulls(params, pts):
        (scale,) = params
        value = torch.ones_like(pts[:, 0]) * float(scale.sum())     # a host pull
        return torch.stack([value, torch.zeros_like(value)], dim=-1)

    pts = torch.zeros((8, 2), dtype=torch.float64, device=cuda_device)
    with pytest.raises(RuntimeError):
        with torch.inference_mode():
            mc.markov_chain(RandomKeys(1, cuda_device), pulls,
                            (torch.ones(4, dtype=torch.float64, device=cuda_device),), 3,
                            pts, False, 0.1, mc.Chains())


def _ladder_cloud(n: int, device, seed: int):
    """A density of ``n`` points an element and its ``5 n`` extra points,
    all three elements active: the packet of ``tests/test_opt.py`` (x0 =
    -10, p0 = 30) as the (0, 0) labels, a quadrature coherence at 5% of it
    and a 1% upper population."""
    import numpy as np

    rng = np.random.default_rng(seed)
    r0, sigma = np.array([-10.0, 30.0]), np.array([1.0 / 3.0, 1.5])

    def cloud(m):
        pts = r0 + rng.normal(size=(3, m, 2)) * sigma
        g = np.exp(-np.sum((pts - r0) ** 2 / (2 * sigma**2), axis=-1)) / (2 * np.pi * sigma.prod())
        rho = np.zeros((3, m, 2))
        rho[0, :, 0] = g[0]
        rho[1] = 0.05 * g[1][:, None] * np.stack([np.cos(pts[1, :, 0]),
                                                  np.sin(pts[1, :, 0])], axis=-1)
        rho[2, :, 0] = 0.01 * g[2]
        f64 = dict(dtype=torch.float64, device=device)
        return TD.Density(points=torch.tensor(pts, **f64), rho=torch.tensor(rho, **f64),
                          active=torch.ones(3, dtype=torch.bool, device=device))

    return cloud(n), cloud(5 * n)


@pytest.mark.gpu
def test_zoom_graphs_match_the_eager_ladder(cuda_device):
    """The ladder's zoom evaluations as graph replays against the eager
    closures at N = 256 with the coherence active: one ``_run_stage`` each
    way, its lengths, coherence parameters, error and averages to 1e-12
    relative, the same solves, iterations, evaluations and pulls, and every
    evaluation a replay.  Then one optimizer's two ladders on two clouds:
    each loss kind captured once (``capture`` spans of kind ``zoom``), every
    evaluation a replay, and each replay launching the hand-written kernels
    of one eager evaluation."""
    import numpy as np

    from gple_tpu_torch import observables as OBS
    from gple_tpu_torch.gp import opt as O
    from gple_tpu_torch.ops import gram_kernels as GK

    sigma_r0 = np.array([1.0 / 3.0, 1.5])
    density, extra = _ladder_cloud(256, cuda_device, 11)
    energies = OBS.total_energy_each_surface("DAC", density, 2000.0)
    kw = dict(model="DAC", mass=2000.0, total_energy=float(energies[0]), purity=1.0,
              sigma_r0=sigma_r0, opt_mode="ladder", lbfgs_steps=10)
    f64 = dict(dtype=torch.float64, device=cuda_device)
    with torch.inference_mode(False), torch.enable_grad():
        data, active = O.Optimizer(**kw)._pack_data(density, extra, energies)
        data = {k: v.clone() for k, v in data.items()}
        host = {k: data[k].cpu().numpy() for k in ("dlb", "dub", "olb", "oub")}
        start = (torch.tensor(np.clip(np.tile(sigma_r0, (2, 1)), host["dlb"], host["dub"]), **f64),
                 torch.tensor(np.clip(O.Optimizer(**kw)._initial_off(), host["olb"], host["oub"]),
                              **f64))
        outs, counts = {}, {}
        for name, graphs in (("eager", None), ("graph", O.ZoomGraphs())):
            with spans.collect() as totals:
                outs[name] = O._run_stage(*start, torch.zeros((2, 3), **f64), data,
                                          bool(active[O.OFFDIAG_INDEX]), 10, O.AL_OUTER,
                                          "zoom", graphs)
            counts[name] = {k: totals.count("zoom." + k) for k in O.ZOOM_COUNTERS + ("replays",)}
    assert bool(active.all())
    eager, graph = counts["eager"], counts["graph"]
    assert graph.pop("replays") == graph["evaluations"] > 0 and eager.pop("replays") == 0
    assert graph == eager
    for ours, theirs, name in zip(outs["graph"][:4], outs["eager"][:4],
                                  ("diag lengths", "off params", "error", "averages")):
        torch.testing.assert_close(ours, theirs, rtol=1e-12, atol=0, msg=name)

    optimizer = O.Optimizer(**kw)
    with spans.timeline() as tl, spans.collect() as totals:
        for seed in (11, 12):
            density, extra = _ladder_cloud(256, cuda_device, seed)
            optimizer.optimize(density, extra, energies)
    captured = [s.attrs["kind"] for s in tl.records if s.name == "capture"]
    graphs = optimizer._zoom_graphs.graphs
    assert {key[0] for key in graphs} == set(O.ZOOM_KINDS)
    assert captured == ["zoom"] * len(graphs)
    assert totals.count("zoom.replays") == totals.count("zoom.evaluations") > 0
    for g in graphs.values():
        per_replay = {}
        for (name, _), n in g.graph.launches.items():
            per_replay[name] = per_replay.get(name, 0) + n
        GK.reset_launches()
        with torch.inference_mode(False), torch.enable_grad():
            z = g.z.clone().requires_grad_(True)
            torch.autograd.grad(g.loss(z.reshape((1,) + g.shape))[0], z)
        torch.cuda.synchronize()
        assert per_replay == {k: n for k, n in GK.LAUNCHES.items() if n}
        assert {"rbf_gram", "rbf_gram_vjp"} <= set(per_replay)


# -- the activation test on the host's tuple -------------------------------------------

def _before_the_crossing(n: int = 64):
    """The example state and a 5N extra cloud moved to x about -1, before the
    avoided crossing, with only the (0,0) element populated (active
    (True, False, False), zero labels elsewhere) and the GP states refitted:
    the coherence is fed above epsilon at once and the (1,1) element a few
    ticks later."""
    from gple_tpu_torch.entry import example_extra, example_params, example_state
    from gple_tpu_torch.storage import fit_gp_states

    density, _ = example_state(n, "cpu", generator=torch.Generator().manual_seed(3))
    extra = example_extra(5 * n, "cpu", generator=torch.Generator().manual_seed(4))
    active = torch.tensor([True, False, False])
    shift = torch.tensor([9.0, 0.0], dtype=torch.float64)
    density, extra = (c._replace(points=c.points + shift, active=active,
                                 rho=torch.where(active[:, None, None], c.rho, 0.0))
                      for c in (density, extra))
    dp, op = example_params("cpu")
    with torch.inference_mode():
        gps = fit_gp_states(dp, op, density, block_diag=True)
    return density, extra, gps, dp, op


def test_tick_core_on_the_host_tuple_equals_the_full_test():
    """Four ``_tick_core`` ticks with the host's tuple against four with
    None (all nine pairs), at N = 64 before the crossing: the density, the
    extra cloud and the GP states equal bit for bit (the test feeds none of
    them) and the flags are equal; an inactive element is not small."""
    density, extra, gps, dp, op = _before_the_crossing()
    runs = {}
    for active in (None, (True, False, False)):
        state, flags = (density, extra, gps), []
        for _ in range(4):
            d, e, small, g = TD._tick_core("SAC", 2000.0, 1.0, *state, dp, op,
                                           TD.gp_dist_all_nocut, "none", 0, 2.0, True, active)
            state = (d, e, g)
            flags.append(small.tolist())
        runs[active] = (state, flags)
    (full, full_flags), (read, read_flags) = runs.values()
    assert read_flags == full_flags
    assert not any(f[1] for f in full_flags)
    for ours, theirs in zip(GR.leaves(read), GR.leaves(full)):
        assert torch.equal(ours, theirs)


@pytest.fixture(scope="module")
def crossing_run():
    """A crossing run at N = 24, 12 ticks, reopts every 5, whose first cloud
    drift test re-selects the (0,0) cloud; every ``_load`` records
    the density's and the GP states' active masks, and every tick program
    its host tuple."""
    import dataclasses

    from gple_tpu_torch.entry import crossing_config

    loads, programs, asked = [], [], []
    load, program = TD.GPLEDriver._load, TD._tick_program

    def recorded_load(self, S):
        loads.append((self.density.active.tolist(), self.gps.active.tolist()))
        return load(self, S)

    def recorded_program(S, *args):
        programs.append(args[-1])
        return program(S, *args)

    def drift_once(density):
        first = not asked
        asked.append(True)
        return density.active & torch.tensor([first, False, False])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TD.GPLEDriver, "_load", recorded_load)
        mp.setattr(TD, "_tick_program", recorded_program)
        mp.setattr(TD, "_cloud_drift_flags", drift_once)
        cfg = dataclasses.replace(crossing_config(), num_points=24, reopt_time=5.0)
        drv = TD.GPLEDriver(cfg, device="cpu")
        drv.run(max_ticks=12)
    return drv, loads, programs


def test_gp_states_carry_the_density_active_at_every_load(crossing_run):
    """The tick graph is keyed by the host's copy of ``density.active``, and
    the activation test masks its targets with ``gps.active``: at every
    ``_load`` the two are equal, through activations and re-selections."""
    drv, loads, _ = crossing_run
    assert drv.stats["element_activations"] >= 1 and drv.stats["cloud_reselections"] >= 1
    assert len({tuple(d) for d, _ in loads}) >= 2
    assert all(d == g for d, g in loads), loads


def test_small_pairs_counts_the_replays(crossing_run):
    """``small.pairs`` in the run's totals: 2 a tick with (0,0) alone active
    (10 ticks, no event, 20), 0 once all three are active, and over a run
    through the activations the sum over its tick replays (a rolled-back
    chunk's too: the device ran them)."""
    from gple_tpu_torch.entry import trajectory_config

    drv = TD.GPLEDriver(trajectory_config(16), device="cpu")
    drv.run(max_ticks=10)
    assert drv.totals.count("small.pairs") == 10 * 2
    drv, _, programs = crossing_run
    assert (True, False, False) in programs and (True, True, True) in programs
    assert drv.totals.count("small.pairs") == sum(
        {(True, False, False): 2, (True, True, False): 2, (True, True, True): 0}[a]
        for a in programs)
