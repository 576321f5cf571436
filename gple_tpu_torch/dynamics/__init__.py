"""Trajectory dynamics (counterpart of ``gple_tpu.dynamics``)."""
