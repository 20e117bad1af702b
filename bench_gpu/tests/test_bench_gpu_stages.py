"""The readers of the program's record (``harness/stages.py``) on a
recorded window: a traced frame's device operations named by the
capture's label table, the time between the graph's nodes, the load span
and the set-up seconds."""

import pytest

from bench_gpu.harness import cells, session, stages
from bench_gpu.harness.trace import Interval, Trace
from helpers import CELLS

NEW = ("stage.pyramid_ms", "stage.warp_ms", "stage.robust_ms", "stage.weights_ms",
       "stage.solve_ms", "stage.median_ms", "graph.gap_ms", "frame.load_ms", "setup.graph_s",
       "setup.kernels_s")
US = 1_000

# a graph of 6 nodes: a pyramid node before the levels, then level 1's warp
# and solve, then level 0's warp, robust and median
GRAPH = {"signature": "flow_nd", "captures": 1, "replays": 9, "nodes": 6, "inputs": 1,
         "outputs": 1, "warmup_s": 0.75, "capture_s": 0.5,
         "labels": [["pyramid", None, 0, 1], ["warp", 1, 1, 2], ["solve", 1, 2, 3],
                    ["warp", 0, 3, 4], ["robust", 0, 4, 5], ["median", 0, 5, 6]]}
RECORD = {"counters": {"kernels.built": 0, "kernels.loaded": 6},
          "seconds": {"kernels.build": 0.25, "kernels.load": 0.125, "frame.warmup": 0.75,
                      "frame.capture": 0.5, "frame.load": 0.020036},
          # 12 loads: 10 untraced ones of 2 ms, the two traced ones' 18 us
          "calls": {"kernels.build": 6, "kernels.load": 6, "frame.warmup": 1,
                    "frame.capture": 1, "frame.load": 12},
          "graphs": [{**GRAPH, "signature": "another", "replays": 2, "nodes": 3}, GRAPH]}


def _trace(n_nodes=6, launches=1, hole=0, first="kernel0"):
    """Two frames 1 ms apart: the load (copy in) before the launch, the
    graph's nodes 10 us long with a 1 us gap after each (and a ``hole``
    more before the fourth), the first named ``first``, one clone copy;
    ``launches`` replays a frame, each with its load and clone."""
    ops, spans, host = [], [], []
    for t in (0, 1000 * US):
        spans += [Interval("bench.input", t, t + US), Interval("bench.call", t + US, t + 100 * US),
                  Interval("bench.sync", t + 100 * US, t + 900 * US)]
        for r in range(launches):
            t1 = t + 300 * US * r
            host.append(Interval("frame.load", t1 + 2 * US, t1 + 20 * US))
            ops.append(Interval("Memcpy HtoD (Pageable -> Device)", t1 + 10 * US, t1 + 19 * US))
            host.append(Interval("frame.launch", t1 + 20 * US, t1 + 30 * US))
            start = t1 + 40 * US
            for k in range(n_nodes):
                t0 = start + 11 * US * k + (hole if k >= 3 else 0)
                ops.append(Interval(first if k == 0 else f"kernel{k}", t0, t0 + 10 * US))
            end = start + 11 * US * n_nodes + hole
            ops.append(Interval("Memcpy DtoD (Device -> Device)", end, end + 2 * US))
    return Trace(ops, host, spans)


def _run(trace, record=RECORD, monkeypatch=None):
    cell = cells.resolve(cells.load_benchmark(), CELLS[0])
    reqs = [session.Request(i, 0, i, i, i + 0.5, i + 0.9, True, 1) for i in range(3)]
    run = session.Run(cell, tuple(cell.config["frame"]), 1.0, session.Outcome(reqs, 0, 3), trace)
    if monkeypatch is not None:
        monkeypatch.setattr(stages, "program_record", lambda run: record)
    return run


def test_each_node_takes_its_stage(monkeypatch, capsys):
    run = _run(_trace(), monkeypatch=monkeypatch)
    assert stages.main_graph(run) is GRAPH
    assert stages.split(run) == {("pyramid", None): 0.01, ("warp", 1): 0.01, ("solve", 1): 0.01,
                                 ("warp", 0): 0.01, ("robust", 0): 0.01, ("median", 0): 0.01}
    read = {m: cells.metric_reader(m)(run) for m in NEW}
    assert read["stage.warp_ms"] == pytest.approx(0.02)
    for stage in ("pyramid", "robust", "solve", "median"):
        assert read[f"stage.{stage}_ms"] == pytest.approx(0.01)
    assert read["stage.weights_ms"] == 0
    # 6 nodes over 65 us, 60 of them busy; the clone after them is no node
    assert read["graph.gap_ms"] == pytest.approx(0.005)
    assert "median gap between nodes 1.0 us" in capsys.readouterr().err
    # the untraced loads' mean, on the program's clock
    assert read["frame.load_ms"] == pytest.approx(2.0)
    assert read["setup.graph_s"] == 1.25 and read["setup.kernels_s"] == 0.375


def test_a_hole_between_nodes_is_left_out_of_the_gap(monkeypatch):
    """A node that follows the one before it after more than HOLE_NS (the
    profiler's submission or buffer flush) adds nothing; a shorter wait
    counts whole."""
    assert stages.gap_ms(_run(_trace(hole=20 * US), monkeypatch=monkeypatch)) == pytest.approx(
        0.004)
    assert stages.gap_ms(_run(_trace(hole=5 * US), monkeypatch=monkeypatch)) == pytest.approx(
        0.010)


def test_nodes_that_start_before_the_launch_span_keep_their_labels(monkeypatch):
    """The profiler's host and device clocks agree to some µs: a replay's
    first nodes may read as starting before its ``frame.launch`` span. The
    load's copies, not the span's start, set where the nodes begin."""
    trace = _trace()
    early = Trace([Interval(op.name, op.start - 25 * US, op.end - 25 * US)
                   if op.name.startswith("kernel") else op for op in trace.device_ops],
                  trace.host_events, trace.spans)
    run = _run(early, monkeypatch=monkeypatch)
    assert stages.split(run) == {("pyramid", None): 0.01, ("warp", 1): 0.01, ("solve", 1): 0.01,
                                 ("warp", 0): 0.01, ("robust", 0): 0.01, ("median", 0): 0.01}
    assert stages.gap_ms(run) == pytest.approx(0.005)


def test_a_frame_the_profiler_lost_records_of_is_left_out(monkeypatch):
    """A frame with fewer device operations than the others (records the
    profiler lost) would shift every label after the loss: it is left
    out, and the readers read the frames that hold all their nodes."""
    trace = _trace()
    lost = trace.frame_ops()[1][3]
    run = _run(Trace([op for op in trace.device_ops if op is not lost], trace.host_events,
                     trace.spans), monkeypatch=monkeypatch)
    assert len(stages.frame_nodes(run, GRAPH)) == 1
    assert stages.split(run) == {("pyramid", None): 0.01, ("warp", 1): 0.01, ("solve", 1): 0.01,
                                 ("warp", 0): 0.01, ("robust", 0): 0.01, ("median", 0): 0.01}


def test_a_short_frame_reads_none(monkeypatch):
    """Fewer device operations in a frame than the graph has nodes, or a
    frame of two replays: no labels, no gap."""
    for trace in (_trace(n_nodes=4), _trace(launches=2)):
        run = _run(trace, monkeypatch=monkeypatch)
        assert stages.split(run) is None and stages.gap_ms(run) is None
        assert all(cells.metric_reader(f"stage.{s}_ms")(run) is None
                   for s in ("pyramid", "solve"))


def test_a_program_without_a_record_reads_none(monkeypatch):
    """A checkout whose program keeps no record (its ``observe`` has no
    ``record``) reads None in every reader of it, ``frame.load_ms`` too:
    its trace's load spans are the profiler's, not the program's."""
    run = _run(_trace(), record=None, monkeypatch=monkeypatch)
    for name in NEW:
        assert cells.metric_reader(name)(run) is None, name


def test_every_frame_short_of_its_copies_reads_none(monkeypatch):
    """Where every traced frame lost a record, none holds the load's copy,
    the graph's nodes and the clone's copy exactly: no frame is read. So
    is a frame whose operations after the nodes are no copies."""
    trace = _trace()
    lost = {id(ops[3]) for ops in trace.frame_ops()}
    run = _run(Trace([op for op in trace.device_ops if id(op) not in lost], trace.host_events,
                     trace.spans), monkeypatch=monkeypatch)
    assert stages.frame_nodes(run, GRAPH) is None and stages.split(run) is None
    swapped = Trace([Interval("kernel9", op.start, op.end) if op.name.startswith("Memcpy DtoD")
                     else op for op in trace.device_ops], trace.host_events, trace.spans)
    assert stages.frame_nodes(_run(swapped, monkeypatch=monkeypatch), GRAPH) is None


def test_a_graph_whose_first_node_is_a_copy_keeps_its_first_label(monkeypatch):
    """Only as many leading copies as the graph has inputs precede its
    nodes: a first node that is a copy is still the first node."""
    run = _run(_trace(first="Memcpy DtoD (Device -> Device)"), monkeypatch=monkeypatch)
    assert stages.split(run)[("pyramid", None)] == pytest.approx(0.01)
    assert [op.name for op in stages.frame_nodes(run, GRAPH)[0]][:2] == [
        "Memcpy DtoD (Device -> Device)", "kernel1"]


def test_the_load_of_a_program_that_has_timed_none_reads_none(monkeypatch):
    """Without untraced loads on the program's clock there is nothing to read."""
    record = {**RECORD, "calls": {**RECORD["calls"], "frame.load": 2}}
    assert stages.load_ms(_run(_trace(), record=record, monkeypatch=monkeypatch)) is None


def test_a_checkout_whose_observe_has_no_record_gives_none(monkeypatch):
    monkeypatch.setattr(stages, "RECORD", "pde_tpu_torch.utils.observe:no_such_record")
    assert stages.program_record(_run(_trace())) is None


@pytest.mark.parametrize("name", CELLS)
def test_every_new_metric_resolves_and_reads_none_without_a_trace(name):
    cell = cells.resolve(cells.load_benchmark(), name)
    assert set(NEW) <= {m["name"] for m in cell.per_layer}
    reqs = [session.Request(i, 0, i, i, i + 0.5, i + 0.9, True, 1) for i in range(3)]
    run = session.Run(cell, tuple(cell.config["frame"]), 1.0, session.Outcome(reqs, 0, 3), None)
    for m in NEW:
        assert cells.metric_reader(m)(run) is None, m


def test_the_record_is_the_checkouts():
    """Read from the program of the checkout: a snapshot of plain data."""
    run = _run(_trace())
    record = stages.program_record(run)
    assert set(record) == {"counters", "seconds", "calls", "graphs"}
