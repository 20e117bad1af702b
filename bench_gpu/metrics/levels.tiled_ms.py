"""Device ms a traced frame in the replayed graph's nodes labelled with a
pyramid level whose shape has a tiled SOR call, every stage of it: the
levels the tile kernel solves (``harness/routes.py``, labels from the
capture, ``harness/stages.py``)."""

from bench_gpu.harness.routes import levels_ms


def read(run):
    return levels_ms(run)
