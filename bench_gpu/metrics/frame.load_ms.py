"""Host ms a request in the program's ``frame.load`` span, on the program's
own clock: the input frames cast to float32 and copied into the graph's
static inputs. The mean over every request of the run but the traced ones,
whose cast the profiler slows (``harness/stages.py``). In a closed loop
the card has nothing to run meanwhile."""

from bench_gpu.harness.stages import load_ms


def read(run):
    return load_ms(run)
