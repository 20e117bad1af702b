"""Device ms a frame in the replayed graph's nodes that the program's
``median`` spans enqueued: the median filter of the updated field (labels
from the capture, ``harness/stages.py``)."""

from bench_gpu.harness.stages import stage_ms


def read(run):
    return stage_ms(run, "median")
