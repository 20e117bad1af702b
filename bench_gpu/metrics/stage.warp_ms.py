"""Device ms a frame in the replayed graph's nodes that the program's ``warp``
spans enqueued: the warp and the data-term tensors formed once a warp
(labels from the capture, ``harness/stages.py``)."""

from bench_gpu.harness.stages import stage_ms


def read(run):
    return stage_ms(run, "warp")
