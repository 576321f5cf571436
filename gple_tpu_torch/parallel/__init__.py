"""The fit+evolve step (counterpart of ``gple_tpu.parallel``)."""
