"""Model physics (counterpart of ``gple_tpu.models``)."""
