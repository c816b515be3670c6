"""Hand-written CUDA kernels (sources in ``csrc/``), their plain versions and
dispatchers (``ops``)."""
