"""Device ms a frame in the port's own SOR kernels, matched by name."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device_ops:
        return None
    return tr.layer_ms("sor") or None
