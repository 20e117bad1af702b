"""Device ms a frame in the replayed graph's nodes that the program's
``solve`` spans enqueued: the SOR solve (the port's kernel and the ops
around it) (labels from the capture, ``harness/stages.py``)."""

from bench_gpu.harness.stages import stage_ms


def read(run):
    return stage_ms(run, "solve")
