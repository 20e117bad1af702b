"""Seconds of set-up the program spent building (``nvcc``, only in a
checkout's first run) and loading its CUDA libraries (``kernels.build``
and ``kernels.load``)."""

from bench_gpu.harness.stages import setup_kernels_s


def read(run):
    return setup_kernels_s(run)
