"""Constants and real-imaginary helpers (counterpart of ``gple_tpu.utils``)."""
