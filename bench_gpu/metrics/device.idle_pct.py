"""The card's idle share of the window, %: 100 x (1 - B / P), with B the
device's busy time a request in the traced requests (the union of their
kernels, copies and memsets) and P the mean time from one of the window's
requests' start to the next's. The traced requests run after the window,
since the profiler slows the replays that follow it; their busy time is
the program's, their idle time is not."""


def read(run):
    tr = run.trace
    reqs = run.requests
    periods = [b.start - a.start for a, b in zip(reqs, reqs[1:])]
    if tr is None or not tr.device_ops or not periods:
        return None
    busy = tr.busy_ns() / 1e9 / tr.n_frames
    return 100.0 * (1.0 - busy / (sum(periods) / len(periods)))
