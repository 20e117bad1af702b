"""Device ms a frame between the replayed graph's consecutive nodes that no
node covers: the cost between nodes, the profiler's own holes (over
``harness/stages.HOLE_NS`` each) left out (``harness/stages.py``). The
card's slow state, which the profiler may start, shows here: the reader
prints the median gap between nodes beside the reading (about 0.1 us
fast, 0.4 us slow on an H100), and two readings compare only within one
state."""

from bench_gpu.harness.stages import gap_ms


def read(run):
    return gap_ms(run)
