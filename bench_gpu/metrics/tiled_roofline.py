"""The least time of the frame's tiled SOR calls (each counted call's
planes read and written once, over the card's HBM bandwidth) over
``tiled.kernel_ms``, % (``harness/routes.py``)."""

from bench_gpu.harness.routes import roofline_pct


def read(run):
    return roofline_pct(run)
