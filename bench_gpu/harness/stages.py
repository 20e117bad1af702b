"""The program's own record beside a traced run: each device operation of a
traced replay named by the stage that enqueued it.

The program (``pde_tpu_torch/utils/observe.py``) notes, while it captures
a frame into a CUDA graph, how many nodes the graph holds at each stage's
start and end: a label table of segments [stage, level, first node, end
node]. The capture is one stream, so the graph is a chain and a replay
runs its nodes in capture order. Here:

- the record is ``observe.record()`` of the checkout's program
  (``session.load``); a program that keeps none (no ``record``) gives
  None, and so does every reader of it;
- the signature read is the one with the most replays, N its node count;
- a traced frame's device operations, in start order, are the load's
  copies into the graph's inputs (one an input), the graph's N nodes,
  then the clones' copies out (one an output): the record gives the
  inputs and outputs. Only a frame that holds exactly these, with copies
  (``trace.layer``) at both ends, is read, and its nodes are labelled in
  order. The profiler now and then loses a few of a frame's 40,000-odd
  device records, which would shift every later label, and the copies,
  not the launch span's start, set where the nodes begin: the profiler
  puts host and device events on one clock only to some µs. The readers
  return None where no frame holds its nodes so;
- ``frame.load_ms`` is read from the program's own host clock, the
  ``frame.load`` spans of every request but the traced ones, whose load
  the profiler slows;
- ``graph.gap_ms`` depends on the card's speed state: the profiler puts
  the card into a slow state, which shows as between-node time (PERF.md),
  and may or may not have done so in a given run. Its reader prints the
  median gap between nodes beside the reading, on standard error: compare
  two readings only where their medians agree.
"""

from __future__ import annotations

import statistics
import sys
from collections import defaultdict

from bench_gpu.harness import session
from bench_gpu.harness.trace import layer

RECORD = "pde_tpu_torch.utils.observe:record"
LOAD = "frame.load"
# the longest gap between two nodes that counts as the cost between them
HOLE_NS = 10_000


def program_record(run) -> dict | None:
    """``observe.record()`` of the run's checkout, or None where its
    program keeps no record."""
    try:
        return session.load(RECORD, run.cell.root)()
    except (ImportError, AttributeError):
        return None


def main_graph(run) -> dict | None:
    """The record of the signature with the most replays, or None."""
    record = program_record(run)
    graphs = [g for g in (record or {}).get("graphs", ()) if g["replays"]]
    return max(graphs, key=lambda g: g["replays"]) if graphs else None


def frame_nodes(run, graph: dict) -> list | None:
    """The N device operations of the replay of ``graph`` in each traced
    frame that holds them as the module docstring says, in start order, or
    None."""
    tr = run.trace
    n = graph.get("nodes")
    n_in, n_out = graph.get("inputs", 0), graph.get("outputs", 0)
    if tr is None or not n or not n_in or not n_out:
        return None
    out = []
    for ops in tr.frame_ops():
        if len(ops) != n_in + n + n_out:
            continue
        if all(layer(op.name) == "copy" for op in ops[:n_in] + ops[n_in + n:]):
            out.append(ops[n_in:n_in + n])
    return out or None


def node_labels(graph: dict) -> list:
    """(stage, level) of each node of ``graph``, from its label table."""
    out = [None] * graph["nodes"]
    for stage, level, start, end in graph["labels"]:
        out[start:end] = [(stage, level)] * (end - start)
    return out


def split(run) -> dict | None:
    """Device ms a frame of the traced replays by (stage, level), or None."""
    graph = main_graph(run)
    if graph is None or not graph.get("labels"):
        return None
    frames = frame_nodes(run, graph)
    if frames is None:
        return None
    labels = node_labels(graph)
    ns = defaultdict(int)
    for nodes in frames:
        for label, op in zip(labels, nodes):
            ns[label] += op.end - op.start
    return {label: t / 1e6 / len(frames) for label, t in ns.items()}


def stage_ms(run, stage: str) -> float | None:
    """Device ms a frame of the nodes labelled ``stage``, or None."""
    by = split(run)
    if by is None:
        return None
    return sum(ms for (name, _), ms in by.items() if name == stage)


def gap_ms(run) -> float | None:
    """Device ms a frame between the graph's consecutive nodes that no node
    covers: the cost between nodes. A hole over ``HOLE_NS`` is left out:
    under the profiler the replay's submission and the tracer's buffer
    flushes leave a few holes of ms a frame, where a node follows the one
    before it within a fraction of a µs. Prints the median gap on standard
    error (module docstring)."""
    graph = main_graph(run)
    frames = frame_nodes(run, graph) if graph is not None else None
    if not frames:
        return None
    total, gaps = 0, []
    for nodes in frames:
        reach = nodes[0].end
        for op in nodes[1:]:
            gap = op.start - reach
            gaps.append(max(gap, 0))
            if 0 < gap <= HOLE_NS:
                total += gap
            reach = max(reach, op.end)
    ms = total / 1e6 / len(frames)
    print(f"graph.gap_ms {ms} over {len(frames)} traced frames; median gap between nodes "
          f"{statistics.median(gaps) / 1e3} us", file=sys.stderr)
    return ms


def load_ms(run) -> float | None:
    """The host's ms a request in the program's ``frame.load`` spans
    (``observe.record()``'s seconds and calls), the traced requests' left
    out, or None where the program times no load."""
    tr = run.trace
    record = program_record(run) if tr is not None else None
    if record is None or "calls" not in record:
        return None
    traced = [e for e in tr.host_events if e.name == LOAD]
    calls = record["calls"].get(LOAD, 0) - len(traced)
    if calls <= 0:
        return None
    seconds = record["seconds"][LOAD] - sum(e.end - e.start for e in traced) / 1e9
    return 1e3 * seconds / calls


def setup_graph_s(run) -> float | None:
    """The warm-up and capture seconds of the signature with the most
    replays, or None."""
    graph = main_graph(run) if run.trace is not None else None
    if graph is None or not graph["captures"]:
        return None
    return graph["warmup_s"] + graph["capture_s"]


def setup_kernels_s(run) -> float | None:
    """The seconds the program spent building and loading its kernels, or
    None where it built and loaded none."""
    record = program_record(run) if run.trace is not None else None
    seconds = (record or {}).get("seconds", {})
    parts = [seconds[k] for k in ("kernels.build", "kernels.load") if k in seconds]
    return sum(parts) if parts else None
