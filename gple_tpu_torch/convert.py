"""Carry state between ``gple_tpu`` and the port.

:func:`to_torch` turns a ``gple_tpu`` container -- ``Density``, ``GPStates``,
``KernelParams``, ``ComplexKernelParams``, ``RealTrainState`` or
``ComplexTrainState``, with leaves given as numpy arrays or anything
``numpy.asarray`` accepts -- into the port's container of the same name on a
given device.  It walks the NamedTuples by field name and raises when the
field names differ.  :func:`to_numpy` goes back: the port's containers with
numpy leaves.  No JAX import is needed: containers are matched by class name.
"""

from __future__ import annotations

import numpy as np
import torch

from gple_tpu_torch.ops.complex_kernels import ComplexKernelParams, ComplexTrainState
from gple_tpu_torch.ops.kernels import KernelParams, RealTrainState
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
