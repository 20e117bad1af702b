"""Device ms a traced frame in the tile kernel (``tiled_sweep_kernel``,
``tiled_family_kernel``), matched by name; None unless a frame holds the
launches of the tiled calls its capture counted (``harness/routes.py``)."""

from bench_gpu.harness.routes import kernel_ms


def read(run):
    return kernel_ms(run)
