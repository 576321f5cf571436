"""Point sharding over ``torch.distributed`` (counterpart of
:mod:`gple_tpu.parallel.sharding`).

The reference's scaling dimension is the number of sampled points N per
element; here that axis is split over the ranks of a process group, one
process per rank:

* the evolution step is embarrassingly parallel over points -- each rank
  evolves its contiguous block of N/W points against the FULL GP state, which
  it all-gathers first (the collective GSPMD inserts in the JAX package);
* the refit all-gathers the moved points and their labels and factorizes the
  (N, N) systems replicated on every rank, with one batched Cholesky, as
  :func:`make_step_fn` does;
* the state that comes out is row-sharded (:func:`gps_sharding`) or kept
  whole (``shard_refit=False``).

Where the port differs: the JAX package's ``shard_refit`` row-shards the
refit's OUTPUT so that GSPMD distributes its Newton-Schulz matmul chain.  The
port has no Newton-Schulz chain (a Cholesky factorizes; that chain is TPU
machinery and not ported), so here ``shard_refit`` decides only which rows
of the new state each rank keeps.

A :class:`PointMesh` is the counterpart of a one-axis ``jax.sharding.Mesh``:
the group, this process's rank, the world size and its device.  The NCCL
backend serves ``cuda`` (one rank per card) and gloo the ``cpu``; no other
pairing is accepted, and nothing falls back to another backend or device.
A "sharding" is the dimension of a leaf that is split over the ranks, or
``None`` where the leaf is replicated: :func:`density_sharding` and
:func:`gps_sharding` mirror the JAX package's ``PartitionSpec`` trees leaf by
leaf.  :func:`shard_density` / :func:`shard_gps` take this rank's block (the
counterparts of ``jax.device_put`` with a sharding); :func:`gather_density` /
:func:`gather_gps` all-gather the whole (of ``np.asarray`` on a sharded array).
"""

from __future__ import annotations

import datetime
import os
import tempfile
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from gple_tpu_torch.driver import gp_dist_all
from gple_tpu_torch.dynamics.evolve import evolve_step
from gple_tpu_torch.ops import complex_kernels as CK
from gple_tpu_torch.ops import kernels as RK
from gple_tpu_torch.storage import Density, GPStates, fit_gp_states

POINTS_AXIS = "points"
#: the backend of each device type
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
#: how long a rank waits for the others in a collective or at the store
TIMEOUT = datetime.timedelta(seconds=300)


class PointMesh(NamedTuple):
    """A one-axis mesh over the ranks of ``group``: this process is rank
    ``rank`` of ``size`` and holds its block on ``device``."""

    group: object
    rank: int
    size: int
    device: torch.device


def init_group(rank: int, world_size: int, store_path: str, device: str = "cuda") -> None:
    """Initialise the default process group of ``world_size`` ranks through
    the file store at ``store_path`` (no TCP port to pick, so concurrent
    groups on one host cannot race for one), with the backend of ``device``."""
    backend = BACKENDS[torch.device(device).type]
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            timeout=TIMEOUT)


def make_mesh(n_devices: Optional[int] = None, device: str = "cuda", group=None) -> PointMesh:
    """The mesh of the initialised process ``group`` (default: the default
    group) on ``device``'s type: on ``cuda`` rank r holds card r, so the world
    may not outnumber the cards.  ``n_devices`` is checked against the world
    size: a mesh never silently covers fewer ranks than the group."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call init_group first")
    group = dist.group.WORLD if group is None else group
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh: a mesh of {n_devices} devices on a group of "
                         f"world size {size}")
    kind = torch.device(device).type
    backend = dist.get_backend(group)
    if BACKENDS.get(kind) != backend:
        raise ValueError(f"make_mesh: device type {kind!r} on a {backend!r} group "
                         f"(cuda takes nccl, cpu takes gloo)")
    if kind == "cuda":
        if size > torch.cuda.device_count():
            raise RuntimeError(f"make_mesh: {size} ranks, {torch.cuda.device_count()} cards")
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    return PointMesh(group=group, rank=rank, size=size, device=dev)


def density_sharding(mesh: PointMesh) -> Density:
    """The point axis of every Density leaf is split; ``active`` is
    replicated (``P(None, POINTS_AXIS, None)`` and ``P()``)."""
    return Density(points=1, rho=1, active=None)


def gps_sharding(mesh: PointMesh) -> GPStates:
    """Row-split every O(N^2) / O(N) leaf of the fitted GP states; the
    parameters, rescales, the chirp wavevector and ``active`` are replicated.
    The diagonal states are batched over 2, so their N axis is dim 1."""
    diag = RK.RealTrainState(
        params=RK.KernelParams(magnitude=None, lengths=None, noise=None),
        features=1, labels=1, rescale=None, kinv=1, alpha=1,
    )
    off = CK.ComplexTrainState(
        params=CK.ComplexKernelParams(
            magnitude=None, real_magnitude=None, real_lengths=None,
            imag_magnitude=None, imag_lengths=None, noise=None, corr=None,
        ),
        features=0, labels=0, rescale=None, p_re=0, p_im=0, q_re=0, q_im=0, v=0,
        chirp_k=None,
    )
    return GPStates(diag=diag, offdiag=off, active=None)


def _leaf_pairs(tree, spec):
    """(leaf, split dim) pairs of ``tree`` in field order; ``spec`` has the
    same NamedTuple structure with a dim or ``None`` at each leaf."""
    if isinstance(spec, tuple):
        for sub_tree, sub_spec in zip(tree, spec):
            yield from _leaf_pairs(sub_tree, sub_spec)
    else:
        yield tree, spec


def _rebuild(tree, spec, leaves):
    """``tree`` with its leaves replaced, in field order, from ``leaves``."""
    if isinstance(spec, tuple):
        return type(tree)(*(_rebuild(t, s, leaves) for t, s in zip(tree, spec)))
    return next(leaves)


def _block(t: torch.Tensor, dim: int, mesh: PointMesh) -> torch.Tensor:
    n = t.shape[dim]
    if n % mesh.size:
        raise ValueError(f"{n} points do not split over {mesh.size} ranks")
    k = n // mesh.size
    return t.narrow(dim, mesh.rank * k, k).contiguous()


def _shard(tree, spec, mesh: PointMesh):
    leaves = (_block(leaf.to(mesh.device), dim, mesh) if dim is not None
              else (leaf.to(mesh.device) if isinstance(leaf, torch.Tensor) else leaf)
              for leaf, dim in _leaf_pairs(tree, spec))
    return _rebuild(tree, spec, leaves)


def _all_gather_leaves(tensors, dims, mesh: PointMesh):
    """Each local block all-gathered and joined along its split dim, in rank
    order, through one collective for all of them (each block flattened with
    its split dim first into one buffer a rank)."""
    for t in tensors:
        if t.device != mesh.device:
            raise ValueError(f"a tensor on {t.device} in a collective of a mesh on "
                             f"{mesh.device}")
    moved = [t.movedim(d, 0).contiguous() for t, d in zip(tensors, dims)]
    flat = torch.cat([t.reshape(-1) for t in moved])
    parts = [torch.empty_like(flat) for _ in range(mesh.size)]
    dist.all_gather(parts, flat, group=mesh.group)
    out, at = [], 0
    for t, d in zip(moved, dims):
        n = t.numel()
        blocks = [p[at: at + n].view(t.shape) for p in parts]
        out.append(torch.cat(blocks).movedim(0, d))
        at += n
    return out


def _gather(tree, spec, mesh: PointMesh):
    pairs = list(_leaf_pairs(tree, spec))
    split = [(leaf, dim) for leaf, dim in pairs if dim is not None]
    whole = iter(_all_gather_leaves([leaf for leaf, _ in split], [dim for _, dim in split],
                                    mesh))
    return _rebuild(tree, spec, (next(whole) if dim is not None else leaf
                                 for leaf, dim in pairs))


def shard_density(density: Density, mesh: PointMesh) -> Density:
    """This rank's contiguous block of N/W points of every element (the point
    axis laid out over the ranks in rank order), on the mesh's device."""
    return _shard(density, density_sharding(mesh), mesh)


def gather_density(density: Density, mesh: PointMesh) -> Density:
    """The whole density from every rank's block, on every rank."""
    return _gather(density, density_sharding(mesh), mesh)


def shard_gps(gps: GPStates, mesh: PointMesh) -> GPStates:
    """This rank's row blocks of ``gps`` under :func:`gps_sharding`."""
    return _shard(gps, gps_sharding(mesh), mesh)


def gather_gps(gps: GPStates, mesh: PointMesh) -> GPStates:
    """The whole GP states from every rank's row blocks, on every rank."""
    return _gather(gps, gps_sharding(mesh), mesh)


def make_step_fn(model: str, mass: float, dt: float, block_diag: bool = True):
    """The fit+evolve step: evolve all points one tick with the current GP
    surrogate (cutoff distribution), then refactorize the GPs from the moved
    points.  ``block_diag=True`` is the production structure (corr = 0).
    Returns a plain function ``step(density, gps) -> (density, gps)`` that
    runs under ``torch.inference_mode``."""

    @torch.inference_mode()
    def step(density: Density, gps: GPStates):
        new_density = evolve_step(model, mass, dt, density, gp_dist_all, gps)
        new_gps = fit_gp_states(gps.diag.params, gps.offdiag.params, new_density,
                                prev=gps, block_diag=block_diag)
        return new_density, new_gps

    return step


def sharded_step_fn(model: str, mass: float, dt: float, mesh: PointMesh,
                    shard_refit: bool = True):
    """:func:`make_step_fn`'s step with the points split over ``mesh``:
    ``step(local_density, gps) -> (local_density, gps)``, where
    ``local_density`` is this rank's block (:func:`shard_density`) and ``gps``
    is the whole state or this rank's row blocks (:func:`shard_gps`), as the
    JAX package's ``in_shardings`` accept either.  The new state comes back
    in row blocks with ``shard_refit`` and whole without it.  Every rank calls
    the step together."""
    gsh = gps_sharding(mesh)

    @torch.inference_mode()
    def step(local_density: Density, gps: GPStates):
        n_local = local_density.points.shape[1]
        if gps.diag.alpha.shape[-1] == n_local * mesh.size:
            full_gps = gps
        elif gps.diag.alpha.shape[-1] == n_local:
            full_gps = _gather(gps, gsh, mesh)
        else:
            raise ValueError(f"GP state of {gps.diag.alpha.shape[-1]} points against "
                             f"{n_local} local points on {mesh.size} ranks")
        new_local = evolve_step(model, mass, dt, local_density, gp_dist_all, full_gps)
        new_density = gather_density(new_local, mesh)
        new_gps = fit_gp_states(full_gps.diag.params, full_gps.offdiag.params,
                                new_density, prev=full_gps, block_diag=True)
        return new_local, (_shard(new_gps, gsh, mesh) if shard_refit else new_gps)

    return step


def _rank_main(rank: int, world_size: int, device: str, store_path: str, out_dir: str,
               fn: Callable, args: tuple) -> None:
    if device == "cpu":
        # one intra-op thread a rank: W ranks share the host's cores
        torch.set_num_threads(1)
    init_group(rank, world_size, store_path, device)
    try:
        mesh = make_mesh(world_size, device)
        result = fn(mesh, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world_size: int, device: str = "cuda", args: tuple = ()):
    """Run ``fn(mesh, *args)`` in ``world_size`` fresh processes, one rank
    each, on a group joined through a file store in a temporary directory;
    returns the ranks' results (saved with ``torch.save``), in rank order.
    ``fn`` must be importable by name (a module-level function).  A rank that
    raises stops the others, and the error is raised here."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="gple_ranks_") as tmp:
        mp.spawn(_rank_main, nprocs=world_size, join=True,
                 args=(world_size, device, os.path.join(tmp, "store"), tmp, fn, args))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]
