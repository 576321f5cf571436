"""PyTorch port: point sharding over ``torch.distributed`` against ``gple_tpu``.

The sharded step runs at gloo world sizes 2 and 4 on the CPU, each rank in a
process of its own (``sharding.spawn_ranks``), on the
``__graft_entry__._example_state`` construction at N = 64.  Its gathered
outputs must equal the port's single-device step at the limits
``tests/test_sharding.py`` holds the JAX package's sharded step to (points
and rho 1e-12, alpha and v 1e-8), and the JAX package's single-device step
at ``tests/test_torch_step.py``'s (points 1e-12, rho 1e-8, alpha 1e-8).  The
JAX package's own 8-device sharded step is not compiled here:
``tests/test_sharding.py`` already holds it to its single-device step.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from gple_tpu.parallel import sharding as JSH
from gple_tpu_torch.entry import dryrun_multichip, example_state
from gple_tpu_torch.parallel import sharding as SH
from test_torch_kernels import _warm_torch_exp, one_torch_thread  # noqa: F401 (fixtures)

MODEL, MASS, DT = "SAC", 2000.0, 1.0
N = 64
STEPS = 2
TOL_POINTS, TOL_RHO, TOL_ALPHA = 1e-12, 1e-12, 1e-8          # against the port's step
TOL_JAX_POINTS, TOL_JAX_RHO, TOL_JAX_ALPHA = 1e-12, 1e-8, 1e-8  # against JAX's step


def _rank_steps(mesh, pts0):
    """On every rank: STEPS sharded steps from the whole example state, with
    and without ``shard_refit`` (the second step takes the first's state as
    it comes out, row blocks or whole), gathered; and the shard / gather
    round trips of the start state."""
    density, gps = example_state(N, "cpu", pts0=pts0)
    out = {}
    for shard_refit in (True, False):
        step = SH.sharded_step_fn(MODEL, MASS, DT, mesh, shard_refit=shard_refit)
        local, state = SH.shard_density(density, mesh), gps
        for _ in range(STEPS):
            local, state = step(local, state)
        rows = state.offdiag.p_re.shape[0]
        whole = SH.gather_gps(state, mesh) if shard_refit else state
        out[shard_refit] = dict(density=SH.gather_density(local, mesh), gps=whole,
                                local_points=local.points.shape[1], p_re_rows=rows)
    blocks = SH.shard_gps(gps, mesh)
    back = SH.gather_gps(blocks, mesh)
    out["round_trip"] = dict(
        gps=all(torch.equal(a, b) for (a, _), (b, _) in
                zip(SH._leaf_pairs(gps, SH.gps_sharding(mesh)),
                    SH._leaf_pairs(back, SH.gps_sharding(mesh)))
                if isinstance(a, torch.Tensor)),
        density=all(torch.equal(a, b) for a, b in
                    zip(density, SH.gather_density(SH.shard_density(density, mesh), mesh))),
        kinv_rows=blocks.diag.kinv.shape[1])
    return out


@pytest.fixture(scope="module")
def start():
    jd, jg = graft._example_state(N)
    return jd, jg, np.asarray(jd.points[0])


@pytest.fixture(scope="module")
def single(start):
    """The port's and the JAX package's single-device steps."""
    jd, jg, pts0 = start
    td, tg = example_state(N, "cpu", pts0=pts0)
    tstep = SH.make_step_fn(MODEL, MASS, DT)
    jstep = jax.jit(JSH.make_step_fn(MODEL, MASS, DT))
    for _ in range(STEPS):
        td, tg = tstep(td, tg)
        jd, jg = jstep(jd, jg)
    return (td, tg), (jd, jg)


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"W{w}")
def sharded(request, start):
    world = request.param
    return world, SH.spawn_ranks(_rank_steps, world, "cpu", (start[2],))


def _close(ours, theirs, atol, what):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs), rtol=0, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("shard_refit", [True, False])
def test_sharded_step_matches_the_single_device_step(sharded, single, shard_refit):
    world, ranks = sharded
    (td, tg), _ = single
    for rank, res in enumerate(ranks):
        out = res[shard_refit]
        where = f"W={world} rank {rank} shard_refit={shard_refit}"
        _close(out["density"].points, td.points, TOL_POINTS, f"{where}: points")
        _close(out["density"].rho, td.rho, TOL_RHO, f"{where}: rho")
        _close(out["gps"].diag.alpha, tg.diag.alpha, TOL_ALPHA, f"{where}: alpha")
        _close(out["gps"].offdiag.v, tg.offdiag.v, TOL_ALPHA, f"{where}: v")
        assert out["local_points"] == N // world
        assert out["p_re_rows"] == (N // world if shard_refit else N)


@pytest.mark.parametrize("shard_refit", [True, False])
def test_sharded_step_matches_the_jax_step(sharded, single, shard_refit):
    world, ranks = sharded
    _, (jd, jg) = single
    out = ranks[0][shard_refit]
    where = f"W={world} shard_refit={shard_refit}"
    _close(out["density"].points, jd.points, TOL_JAX_POINTS, f"{where}: points")
    _close(out["density"].rho, jd.rho, TOL_JAX_RHO, f"{where}: rho")
    _close(out["gps"].diag.alpha, jg.diag.alpha, TOL_JAX_ALPHA, f"{where}: alpha")
    _close(out["gps"].offdiag.v, jg.offdiag.v, TOL_JAX_ALPHA, f"{where}: v")


def test_shard_then_gather_round_trips_bit_for_bit(sharded):
    world, ranks = sharded
    for res in ranks:
        assert res["round_trip"]["gps"] and res["round_trip"]["density"]
        assert res["round_trip"]["kinv_rows"] == N // world


def _split_dim(spec):
    """The split dimension a ``PartitionSpec`` gives the points axis."""
    return spec.index(JSH.POINTS_AXIS) if JSH.POINTS_AXIS in spec else None


def _pair_specs(ours, theirs, where):
    if isinstance(ours, tuple):
        assert ours._fields == theirs._fields, where
        for name, a, b in zip(ours._fields, ours, theirs):
            yield from _pair_specs(a, b, f"{where}.{name}")
    else:
        yield where, ours, _split_dim(tuple(theirs.spec))


def test_split_dims_match_the_partition_specs():
    """Leaf by leaf, on the conftest's 8-device CPU mesh (builds shardings,
    compiles nothing)."""
    assert len(jax.devices()) == 8
    jmesh = JSH.make_mesh(8)
    mesh = SH.PointMesh(group=None, rank=0, size=8, device=torch.device("cpu"))
    pairs = list(_pair_specs(SH.gps_sharding(mesh), JSH.gps_sharding(jmesh), "gps"))
    pairs += list(_pair_specs(SH.density_sharding(mesh), JSH.density_sharding(jmesh),
                              "density"))
    assert len(pairs) == 28
    for where, ours, theirs in pairs:
        assert ours == theirs, where


def test_points_that_do_not_split_raise():
    density, gps = example_state(N, "cpu", generator=torch.Generator().manual_seed(0))
    mesh = SH.PointMesh(group=None, rank=0, size=3, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="do not split over 3 ranks"):
        SH.shard_density(density, mesh)
    with pytest.raises(ValueError, match="do not split over 3 ranks"):
        SH.shard_gps(gps, mesh)


def test_a_mesh_must_match_its_group(tmp_path):
    """A mesh of another size than the world, a device type of another
    backend, and a tensor on another device than the mesh's all raise."""
    with pytest.raises(RuntimeError, match="no process group"):
        SH.make_mesh(1, "cpu")
    SH.init_group(0, 1, str(tmp_path / "store"), "cpu")
    try:
        with pytest.raises(ValueError, match="a mesh of 2 devices on a group of world size 1"):
            SH.make_mesh(2, "cpu")
        with pytest.raises(ValueError, match="'cuda' on a 'gloo' group"):
            SH.make_mesh(1, "cuda")
        mesh = SH.make_mesh(None, "cpu")
        assert (mesh.rank, mesh.size, mesh.device) == (0, 1, torch.device("cpu"))
        density, _ = example_state(16, "cpu", generator=torch.Generator().manual_seed(0))
        with pytest.raises(ValueError, match="a tensor on meta"):
            SH.gather_density(density._replace(points=density.points.to("meta")), mesh)
    finally:
        torch.distributed.destroy_process_group()


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    dryrun_multichip(4, device="cpu")
    assert "dryrun_multichip OK on 4 ranks (gloo" in capsys.readouterr().out


def test_dryrun_multichip_refuses_more_ranks_than_cards():
    more = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match=f"need {more} CUDA devices"):
        dryrun_multichip(more)
