"""Physical constants and model-size defaults.

Mirrors the compile-time constants of the reference
(``gaussian_process_liouville_equation/stdafx.h:107-125``) but promoted to runtime
values where reasonable.  Atomic units throughout.

Re-homed verbatim from :mod:`gple_tpu.utils.constants`: that module is pure
Python, but importing it runs ``gple_tpu/__init__.py``, which imports jax.
"""

import math

#: Reduced Planck constant in atomic units (reference ``stdafx.h:107``).
HBAR: float = 1.0

#: Planck constant h = 2*pi*hbar (reference ``schrodinger_equation/general.h:36``).
PLANCK_H: float = 2.0 * math.pi * HBAR


def num_elements(num_pes: int) -> int:
    """Number of density-matrix elements (reference ``stdafx.h:113``)."""
    return num_pes * num_pes


def num_offdiagonal(num_pes: int) -> int:
    """Number of strictly-lower-triangular elements (reference ``stdafx.h:115``)."""
    return (num_pes * num_pes - num_pes) // 2


def num_triangular(num_pes: int) -> int:
    """Number of lower-triangular (incl. diagonal) elements (``stdafx.h:117``)."""
    return (num_pes * num_pes + num_pes) // 2


def purity_factor(dim: int) -> float:
    """Purity global factor (2*pi*hbar)^dim (reference ``stdafx.h:125``)."""
    return (2.0 * math.pi * HBAR) ** dim


def power_of_two_cutoff(value: float) -> float:
    """Round down to the nearest power of two, e.g. 0.2493 -> 0.125.

    Reference ``schrodinger_equation/general.cpp:33-36``.
    """
    return 2.0 ** math.floor(math.log2(value))
