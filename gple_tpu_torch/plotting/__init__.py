"""Plots of the run outputs (counterpart of ``gple_tpu.plotting``; needs matplotlib)."""

from gple_tpu_torch.plotting.plots import (
    animate_phase_space,
    animate_point_cloud,
    animate_psi,
    plot_averages,
    plot_gple_log,
    plot_oracle_averages,
    plot_parameters,
    plot_phase_space_frames,
    plot_point_cloud,
)

__all__ = [
    "animate_phase_space",
    "animate_point_cloud",
    "animate_psi",
    "plot_averages",
    "plot_gple_log",
    "plot_oracle_averages",
    "plot_parameters",
    "plot_phase_space_frames",
    "plot_point_cloud",
]
