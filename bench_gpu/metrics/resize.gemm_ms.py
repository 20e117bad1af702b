"""Device ms a frame in the matrix-product kernels (the resize's)."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device_ops:
        return None
    return tr.layer_ms("gemm") or None
