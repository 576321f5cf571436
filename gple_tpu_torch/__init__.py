"""PyTorch + CUDA port of ``gple_tpu`` for NVIDIA Hopper GPUs.

The package mirrors ``gple_tpu``'s layout module for module (``ops/kernels.py``
here is the counterpart of ``gple_tpu/ops/kernels.py``, and so on) and keeps
its containers as NamedTuples of tensors with the same field names, so a JAX
state maps onto the port field for field (see :mod:`gple_tpu_torch.convert`).

What is ported so far is the system's hot path: the fit+evolve step
(:func:`gple_tpu_torch.parallel.sharding.make_step_fn`) and the default
trajectory tick (:func:`gple_tpu_torch.driver._tick_core`).  Both Pallas TPU
kernels of ``gple_tpu`` have hand-written CUDA counterparts under ``csrc/``
(see :mod:`gple_tpu_torch.ops.gram_kernels`); tensors on the CPU take their
plain PyTorch versions.

Precision policy: float64 throughout, as ``gple_tpu`` on the CPU.  The package
imports neither ``jax`` nor ``gple_tpu``.
"""
