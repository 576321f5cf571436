"""PyTorch + CUDA port of ``gple_tpu`` for NVIDIA Hopper GPUs.

The package mirrors ``gple_tpu``'s layout module for module (``ops/kernels.py``
here is the counterpart of ``gple_tpu/ops/kernels.py``, and so on) and keeps
its containers as NamedTuples of tensors with the same field names, so a JAX
state maps onto the port field for field (see :mod:`gple_tpu_torch.convert`).

What is ported so far: the fit+evolve step
(:func:`gple_tpu_torch.parallel.sharding.make_step_fn`) and the production
trajectory -- :class:`gple_tpu_torch.driver.GPLEDriver` with the Metropolis
sampler, the moment optimizer, the observables, the output files and the
``gple`` CLI (``python -m gple_tpu_torch.cli gple``).  Both Pallas TPU
kernels of ``gple_tpu`` have hand-written CUDA counterparts under ``csrc/``
(see :mod:`gple_tpu_torch.ops.gram_kernels`); tensors on the CPU take their
plain PyTorch versions.

Precision policy: float64 throughout, as ``gple_tpu`` on the CPU.  The package
imports neither ``jax`` nor ``gple_tpu``.
"""
