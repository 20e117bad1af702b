"""Seconds of set-up in the program's eager warm-up frame and its CUDA
graph capture (``frame.warmup`` and ``frame.capture`` of the signature
with the most replays; the kernels' build and load left out)."""

from bench_gpu.harness.stages import setup_graph_s


def read(run):
    return setup_graph_s(run)
