"""Carry state between ``gple_tpu`` and the port.

:func:`to_torch` turns a ``gple_tpu`` container -- ``Density``, ``GPStates``,
``KernelParams``, ``ComplexKernelParams``, ``RealTrainState`` or
``ComplexTrainState`` (vector or full-ARD matrix lengths alike), with
leaves given as numpy arrays or anything ``numpy.asarray`` accepts -- into
the port's container of the same name on a given device.  It walks the
NamedTuples by field name and raises when the field names differ.
:func:`to_numpy` goes back: the port's containers with numpy leaves.  The
oracles' configurations ``DVRConfig`` and ``LiouvilleConfig`` carry across
either way field for field (they hold no arrays).  No JAX import is needed:
containers are matched by class name.

:func:`config_to_torch` maps a ``GPLEConfig`` field for field, and
:func:`driver_to_torch` carries a ``gple_tpu`` driver's whole trajectory state
(clouds, fit, optimizer, Metropolis parameters, conserved targets, drift
references and the booster's state) into the port's driver, so both can
advance from one state.
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
from gple_tpu_torch.oracles import DVRConfig, LiouvilleConfig
from gple_tpu_torch.sampler.mc import MCParameters
from gple_tpu_torch.storage import Density, GPStates

CONTAINERS = {cls.__name__: cls for cls in (
    Density, GPStates, KernelParams, ComplexKernelParams, RealTrainState,
    ComplexTrainState)}
CONFIGS = {cls.__name__: cls for cls in (DVRConfig, LiouvilleConfig)}


def _container(obj):
    cls = CONTAINERS.get(type(obj).__name__)
    if cls is None or not hasattr(obj, "_fields"):
        return None
    if tuple(obj._fields) != cls._fields:
        raise ValueError(f"{type(obj).__name__}: fields {obj._fields} do not match "
                         f"the port's {cls._fields}")
    return cls


def _config(obj):
    """The port's oracle configuration equal to ``obj`` (either package's),
    or None when ``obj`` is not one."""
    cls = CONFIGS.get(type(obj).__name__)
    if cls is None or not dataclasses.is_dataclass(obj):
        return None
    names = [f.name for f in dataclasses.fields(cls)]
    if [f.name for f in dataclasses.fields(obj)] != names:
        raise ValueError(f"{type(obj).__name__}: fields differ from the port's {names}")
    return cls(**{name: getattr(obj, name) for name in names})


def to_torch(obj, device):
    """A ``gple_tpu`` container (or array, or oracle configuration) as the
    port's on ``device``."""
    config = _config(obj)
    if config is not None:
        return config
    cls = _container(obj)
    if cls is not None:
        return cls(*(to_torch(getattr(obj, f), device) for f in cls._fields))
    return torch.from_numpy(np.array(obj, copy=True)).to(device)


def to_numpy(obj):
    """A port container (or tensor) with every leaf as a numpy array; an
    oracle configuration as itself."""
    config = _config(obj)
    if config is not None:
        return config
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
    (``total_energy``, ``purity``, ``purity_ratio``, ``_pop_sum0``), the
    drift reference ``_fit_ref``, the live booster size ``_coh_k``, the
    backoff's ``_coh_div_eff``, the tracking mode and the stats.  ``rng`` is the port driver's root key (a
    stand-in replaying ``jax_driver.key`` makes both draw the same numbers)."""
    cfg = config_to_torch(jax_driver.cfg)
    drv = GPLEDriver(cfg, outdir=outdir, verbose=verbose, device=device, rng=rng)
    drv.density = to_torch(jax_driver.density, device)
    drv.extra = to_torch(jax_driver.extra, device)
    drv.gps = to_torch(jax_driver.gps, device)
    drv.optimizer = Optimizer.like(jax_driver.optimizer, device)
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
    drv._coh_k = int(jax_driver._coh_k)
    drv._track_moments = str(jax_driver._track_moments)
    drv.stats = dict(jax_driver.stats)
    return drv
