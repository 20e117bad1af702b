"""Device ms a frame in the replayed graph's nodes that the program's
``robust`` spans enqueued: the robust weights and their channel sums
(labels from the capture, ``harness/stages.py``)."""

from bench_gpu.harness.stages import stage_ms


def read(run):
    return stage_ms(run, "robust")
