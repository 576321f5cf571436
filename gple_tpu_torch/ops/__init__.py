"""GP kernels, linear algebra and the CUDA kernels (counterpart of ``gple_tpu.ops``)."""
