"""Carry state between ``gple_tpu`` and the port.

:func:`to_torch` turns a ``gple_tpu`` container -- ``Density``, ``GPStates``,
``KernelParams``, ``ComplexKernelParams``, ``RealTrainState`` or
``ComplexTrainState``, with leaves given as numpy arrays or anything
``numpy.asarray`` accepts -- into the port's container of the same name on a
given device.  It walks the NamedTuples by field name and raises when the
field names differ.  :func:`to_numpy` goes back: the port's containers with
numpy leaves.  No JAX import is needed: containers are matched by class name.

:func:`config_to_torch` maps a ``GPLEConfig`` field for field, and
:func:`driver_to_torch` carries a ``gple_tpu`` driver's whole trajectory state
(clouds, fit, optimizer, Metropolis parameters, conserved targets and drift
references) into the port's driver, so both can advance from one state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gple_tpu_torch.config import GPLEConfig
from gple_tpu_torch.driver import GPLEDriver
from gple_tpu_torch.gp.opt import Optimizer, OptResult
from gple_tpu_torch.ops.complex_kernels import ComplexKernelParams, ComplexTrainState
from gple_tpu_torch.ops.kernels import KernelParams, RealTrainState
from gple_tpu_torch.sampler.mc import MCParameters
from gple_tpu_torch.storage import Density, GPStates

CONTAINERS = {cls.__name__: cls for cls in (
    Density, GPStates, KernelParams, ComplexKernelParams, RealTrainState,
    ComplexTrainState)}


def _container(obj):
    cls = CONTAINERS.get(type(obj).__name__)
    if cls is None or not hasattr(obj, "_fields"):
        return None
    if tuple(obj._fields) != cls._fields:
        raise ValueError(f"{type(obj).__name__}: fields {obj._fields} do not match "
                         f"the port's {cls._fields}")
    return cls


def to_torch(obj, device):
    """A ``gple_tpu`` container (or array) as the port's container on ``device``."""
    cls = _container(obj)
    if cls is not None:
        return cls(*(to_torch(getattr(obj, f), device) for f in cls._fields))
    return torch.from_numpy(np.array(obj, copy=True)).to(device)


def to_numpy(obj):
    """A port container (or tensor) with every leaf as a numpy array."""
    cls = _container(obj)
    if cls is not None:
        return cls(*(to_numpy(getattr(obj, f)) for f in cls._fields))
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return np.asarray(obj)


def config_to_torch(cfg) -> GPLEConfig:
    """A ``gple_tpu`` ``GPLEConfig`` as the port's; raises when the fields differ."""
    ours = [f.name for f in dataclasses.fields(GPLEConfig)]
    theirs = [f.name for f in dataclasses.fields(cfg)]
    if ours != theirs:
        raise ValueError(f"GPLEConfig fields differ: {sorted(set(ours) ^ set(theirs))}")
    return GPLEConfig(**{name: getattr(cfg, name) for name in ours})


def driver_to_torch(jax_driver, device, rng=None, outdir=None, verbose=False) -> GPLEDriver:
    """The port's driver in the state of an initialized ``gple_tpu`` driver:
    density, extra cloud and fitted states; the optimizer's lengths, off
    parameters, magnitudes, correlation bounds and warm multipliers;
    ``mc_params``; the conserved targets
    (``total_energy``, ``purity``, ``purity_ratio``, ``_pop_sum0``) and the
    drift reference ``_fit_ref``.  ``rng`` is the port driver's root key (a
    stand-in replaying ``jax_driver.key`` makes both draw the same numbers)."""
    cfg = config_to_torch(jax_driver.cfg)
    drv = GPLEDriver(cfg, outdir=outdir, verbose=verbose, device=device, rng=rng)
    drv.density = to_torch(jax_driver.density, device)
    drv.extra = to_torch(jax_driver.extra, device)
    drv.gps = to_torch(jax_driver.gps, device)
    jopt = jax_driver.optimizer
    drv.optimizer = Optimizer(
        model=jopt.model, mass=float(jopt.mass), total_energy=float(jopt.total_energy),
        purity=float(jopt.purity), sigma_r0=np.array(jopt.sigma_r0),
        diag_lengths=np.array(jopt.diag_lengths), off_params=np.array(jopt.off_params),
        diag_magnitudes=np.array(jopt.diag_magnitudes),
        off_magnitude=float(jopt.off_magnitude), lbfgs_steps=jopt.lbfgs_steps,
        corr_bounds=tuple(float(b) for b in jopt.corr_bounds), opt_mode=jopt.opt_mode,
        off_len_div=float(jopt.off_len_div), device=device)
    if jopt._al_lam is not None:
        drv.optimizer._al_lam = np.array(jopt._al_lam)
    res = jax_driver.opt_result
    drv.opt_result = OptResult(error=float(res.error), steps=list(res.steps),
                               opt_type=res.opt_type)
    drv.mc_params = [MCParameters(num_steps=int(p.num_steps),
                                  displacement=float(p.displacement))
                     for p in jax_driver.mc_params]
    for name in ("total_energy", "purity", "purity_ratio", "_pop_sum0"):
        setattr(drv, name, float(getattr(jax_driver, name)))
    drv._fit_ref = {k: float(v) for k, v in jax_driver._fit_ref.items()}
    drv._coh_div_eff = float(jax_driver._coh_div_eff)
    return drv
