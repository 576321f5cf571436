"""GP hyperparameter optimization (counterpart of ``gple_tpu.gp``)."""
