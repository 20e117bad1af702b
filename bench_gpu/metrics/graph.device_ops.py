"""Kernels, copies and memsets a frame on the card."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device_ops:
        return None
    return tr.ops_per_frame()
