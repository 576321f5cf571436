"""The exact oracles (counterpart of ``gple_tpu.oracles``): the DVR
Schroedinger solver and the grid-MQCLE (Liouville) solver."""

from gple_tpu_torch.oracles.schrodinger import DVRConfig, DVRSolver
from gple_tpu_torch.oracles.liouville import LiouvilleConfig, LiouvilleSolver

__all__ = ["DVRConfig", "DVRSolver", "LiouvilleConfig", "LiouvilleSolver"]
