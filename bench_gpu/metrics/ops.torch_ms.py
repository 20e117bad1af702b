"""Device ms a frame in PyTorch's own kernels other than the matrix
products and copies (data terms, warp, weights, filters, median)."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device_ops:
        return None
    return tr.layer_ms("torch") or None
