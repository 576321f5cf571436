"""Phase-space sampling (counterpart of ``gple_tpu.sampler``)."""
