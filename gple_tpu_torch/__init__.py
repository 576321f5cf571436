"""PyTorch + CUDA port of ``gple_tpu`` for NVIDIA Hopper GPUs.

The package mirrors ``gple_tpu``'s layout module for module (``ops/kernels.py``
here is the counterpart of ``gple_tpu/ops/kernels.py``, and so on) and keeps
its containers as NamedTuples of tensors with the same field names, so a JAX
state maps onto the port field for field (see :mod:`gple_tpu_torch.convert`).

What is ported: all of ``gple_tpu`` but its TPU machinery -- the fit+evolve
step on one device and sharded over ``torch.distributed`` ranks
(:mod:`gple_tpu_torch.parallel.sharding`), the trajectory driver
(:class:`gple_tpu_torch.driver.GPLEDriver`: the Metropolis sampler, the
moment optimizer and the constrained ladder, every ``GPLEConfig`` flag with
the init cache, checkpoints, the output files, a ``torch.profiler`` trace),
the exact oracles, the validation harness, the plotting suite
(:mod:`gple_tpu_torch.plotting`, which alone needs matplotlib and which no
other module imports) and the CLI (``python -m gple_tpu_torch.cli gple|se|le``).
Both Pallas TPU kernels of ``gple_tpu`` have hand-written CUDA counterparts
under ``csrc/`` (see :mod:`gple_tpu_torch.ops.gram_kernels`); tensors on the
CPU take their plain PyTorch versions.

Precision policy: float64 throughout, as ``gple_tpu`` on the CPU.  The package
imports neither ``jax`` nor ``gple_tpu``.
"""
