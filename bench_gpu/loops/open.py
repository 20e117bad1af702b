"""An open loop of one server: requests fall due at a fixed rate,
whatever the server is doing, and wait their turn in order.

Parameters (the traffic file):

- ``rate_per_s``: requests due a second;
- ``arrivals``: ``periodic`` (a camera: one every 1/rate s) or ``poisson``
  (gaps drawn from the seed, exponential with mean 1/rate);
- ``drain_s`` (default 60): how long past the close requests that fell due
  in the window are still served; those left are counted as dropped.

Requests due in the first ``seconds`` are the window's; the window closes
at ``seconds``, and a request's latency runs from when it was due.
"""

import time

from bench_gpu.harness.session import Outcome


def run(window) -> Outcome:
    traffic = window.traffic
    mean_gap = 1.0 / float(traffic["rate_per_s"])
    poisson = traffic.get("arrivals", "periodic") == "poisson"
    drain_s = float(traffic.get("drain_s", 60.0))
    rng = window.rng(0)
    requests, dropped = [], 0
    start = window.clock()
    due, i = 0.0, 0
    while due < window.seconds:
        now = window.clock() - start
        if now > window.seconds + drain_s:
            dropped += 1
        else:
            if due > now:
                time.sleep(due - now)
            requests.append(window.request(i, i % len(window.ring), start + due))
        i += 1
        due += rng.exponential(mean_gap) if poisson else mean_gap
    return Outcome(requests, start, start + window.seconds, dropped)
