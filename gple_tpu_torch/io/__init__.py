"""Output files (counterpart of ``gple_tpu.io``)."""
