"""Hand-written CUDA kernels (sources in ``csrc/``), their ctypes wrappers,
the build that compiles them at first use, and the dispatch between each
kernel and its plain PyTorch version. Importing builds nothing."""
