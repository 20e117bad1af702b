"""Device ms a frame in the replayed graph's nodes that the program's
``pyramid`` spans enqueued: the input scaled to [0, 1], the pyramids, each
level's gradient images, the field's upscale between levels (labels from
the capture, ``harness/stages.py``)."""

from bench_gpu.harness.stages import stage_ms


def read(run):
    return stage_ms(run, "pyramid")
