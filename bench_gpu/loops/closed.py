"""A closed loop of one client: each request is issued when the one before
it has completed, over the ring's clips in turn.

The window runs for ``seconds`` and closes when the last request issued
before then completes. Its
latency is the request's own time, from the call until its fields are
ready. Parameters (the traffic file): none beyond the harness's.
"""

from bench_gpu.harness.session import Outcome


def run(window) -> Outcome:
    requests = []
    start = window.clock()
    i = 0
    while window.clock() - start < window.seconds:
        requests.append(window.request(i, i % len(window.ring)))
        i += 1
    return Outcome(requests, start, requests[-1].end)
