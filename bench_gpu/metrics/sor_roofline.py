"""The least time the frame's SOR calls could take (their planes read and
written once, over the card's HBM bandwidth) over ``sor.kernel_ms``, %."""

from bench_gpu.harness.peaks import sor_least_ms


def read(run):
    tr = run.trace
    if tr is None or not tr.device_ops:
        return None
    ms = tr.layer_ms("sor")
    return 100.0 * sor_least_ms(run.cell.config, run.frame) / ms if ms > 0 else None
