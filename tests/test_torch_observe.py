"""The port's tracing (``pde_tpu_torch/utils/observe.py``): spans, the
capture's label table, the counters and the set-up record.

Here (no card) a span is held as a no-op, as a ``record_function`` under a
CPU ``torch.profiler`` around eager ``flow_nd`` and ``disparity_nd``
frames, and as a node range with a stand-in node counter (every torch op
dispatched is a node), which stands for the capturing graph's node count;
``models/_graph.py``'s counters with a stand-in capture. The tests marked
``card`` hold the capture's node count against the device operations of a
profiled replay, and the graph with its labels against the graph without;
they skip where torch sees no card. On the card::

    python -m pytest tests/test_torch_observe.py -q -m card
"""

import ctypes
import importlib
import json
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pde_tpu_torch.core.pyramid import build_pyramid
from pde_tpu_torch.kernels import build
from pde_tpu_torch.models import _graph
from pde_tpu_torch.utils import observe

tflow = importlib.import_module("pde_tpu_torch.models.flow_nd")
tdisp = importlib.import_module("pde_tpu_torch.models.disparity")

torch.set_num_threads(1)

SHAPE = (3, 40, 56)
LOOPS = dict(firstLoop=2, secondLoop=2)
MODELS = [
    ("flow_nd", tflow.flow_nd, tflow.flow_nd_fused, tflow.FlowNDParams(**LOOPS)),
    ("disparity_nd", tdisp.disparity_nd, tdisp.disparity_nd_fused,
     tdisp.DisparityParams(**LOOPS)),
]
MODEL_IDS = [m[0] for m in MODELS]
# the stages of a captured frame, each under a ``level`` span
STAGES = ("pyramid", "warp", "robust", "weights", "solve", "median")


def _pair(shape=SHAPE, seed=3):
    rng = np.random.default_rng(seed)
    a = (rng.random(shape) * 255).astype(np.float32)
    return a, np.roll(a, 1, axis=-1)


def _fields(out):
    return out if isinstance(out, tuple) else (out,)


class _Nodes(TorchDispatchMode):
    """A stand-in for the capturing graph's node count: every torch op
    dispatched inside the mode is a node."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture
def clean():
    """An empty record before and after the test."""
    observe.reset()
    yield
    observe.reset()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _graph.release_graphs()
    observe.reset()
    yield torch.device("cuda", 0)
    _graph.release_graphs()
    observe.reset()


# --- spans -------------------------------------------------------------


def test_a_span_is_one_shared_no_op_without_profiler_or_capture(clean):
    a = observe.span("warp")
    b = observe.span("level", index=3, shape=(10, 12))
    assert a is b
    with a, b:
        pass
    assert observe.record() == {"counters": {}, "seconds": {}, "calls": {}, "graphs": []}


def _profiled(fn, a, b, p):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn(torch.from_numpy(a), torch.from_numpy(b), params=p)
    return out, prof.events()


@pytest.mark.parametrize("name,eager,fused,params", MODELS, ids=MODEL_IDS)
def test_the_profiler_sees_each_level_and_stage(name, eager, fused, params):
    """Under a profiler an eager frame records a ``level`` span a pyramid
    level and every stage inside one (the pyramid's build before the
    levels aside), no ``frame.*`` span, and the fields are those of a run
    without the profiler, bit for bit."""
    a, b = _pair()
    out, events = _profiled(eager, a, b, params)
    ours = [e for e in events if e.name in STAGES or e.name == "level"
            or e.name.startswith("frame.")]
    assert not [e for e in ours if e.name.startswith("frame.")]
    levels = [e for e in ours if e.name == "level"]
    n = len(build_pyramid([torch.from_numpy(a)] * 2, params.scl_factor,
                          20 if name == "flow_nd" else 10, 5, 1.25, params.scales))
    assert len(levels) == n
    assert {e.name for e in ours} == {"level", *STAGES}

    def parent_level(e):
        p = e.cpu_parent
        while p is not None and p.name != "level":
            p = p.cpu_parent
        return p

    outside = [e for e in ours if e.name in STAGES and parent_level(e) is None]
    assert [e.name for e in outside] == ["pyramid"]
    per_level = {id(lv): [] for lv in levels}
    for e in ours:
        if e.name in STAGES and parent_level(e) is not None:
            per_level[id(parent_level(e))].append(e.name)
    assert all(set(names) == set(STAGES) for names in per_level.values())
    plain = eager(torch.from_numpy(a), torch.from_numpy(b), params=params)
    assert all(torch.equal(x, y) for x, y in zip(_fields(out), _fields(plain)))


def _labelled(eager, a, b, params):
    rec = observe.GraphRecord("stand-in")
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    with _Nodes() as nodes, observe.capture(rec, lambda: nodes.n, lambda m: m):
        out = eager(a, b, params=params)
    return rec, out


def _assert_tiles(labels, n):
    assert labels[0][2] == 0 and labels[-1][3] == n
    for (_, _, s0, e0), (_, _, s1, e1) in zip(labels, labels[1:]):
        assert s0 < e0 == s1 < e1


@pytest.mark.parametrize("name,eager,fused,params", MODELS, ids=MODEL_IDS)
def test_the_label_table_tiles_the_frame(name, eager, fused, params):
    """With the capture branch on (a stand-in node count), every node of
    an eager frame lands in one stage, in order, with no gap or overlap
    and none in ``other``; each level holds every stage; the fields are
    the unlabelled run's bit for bit."""
    a, b = _pair()
    rec, out = _labelled(eager, a, b, params)
    _assert_tiles(rec.labels, rec.nodes)
    assert rec.nodes > 1000
    assert not [seg for seg in rec.labels if seg[0] == observe.OTHER]
    assert rec.labels[0][:2] == ["pyramid", None]
    by_level = {}
    for stage, level, s, e in rec.labels[1:]:
        by_level.setdefault(level, set()).add(stage)
    assert None not in by_level and sorted(by_level) == list(range(len(by_level)))
    assert all(stages == set(STAGES) for stages in by_level.values())
    plain = eager(torch.from_numpy(a), torch.from_numpy(b), params=params)
    assert all(torch.equal(x, y) for x, y in zip(_fields(out), _fields(plain)))


def test_the_label_table_shows_nodes_outside_the_stages():
    """Nodes outside every stage are ``other``, a stage that overlaps
    another shows as an overlap, and a segment takes the level around its
    first node."""
    spans = [("pyramid", {}, 0, 4), ("warp", {}, 6, 9), ("solve", {}, 9, 9),
             ("level", {"index": 1}, 5, 12), ("median", {}, 10, 12)]
    assert observe.label_table(spans, 15) == [
        ["pyramid", None, 0, 4], ["other", None, 4, 6], ["warp", 1, 6, 9], ["other", 1, 9, 10],
        ["median", 1, 10, 12], ["other", None, 12, 15]]
    table = observe.label_table([("warp", {}, 0, 5), ("robust", {}, 3, 8)], 8)
    assert table[1][2] < table[0][3]
    with pytest.raises(AssertionError):
        _assert_tiles(table, 8)


def test_marks_are_resolved_to_node_counts_at_the_end():
    """Spans note opaque marks (the capture's last node on the card), which
    the end of the capture turns into node counts in one call."""
    log = []

    class Tail:
        n = 0

        def mark(self):
            return f"node{self.n}"

        def resolve(self, marks):
            log.append(list(marks))
            return [int(m[4:]) for m in marks]

    tail, rec = Tail(), observe.GraphRecord("x")
    with observe.capture(rec, tail.mark, tail.resolve):
        with observe.span("level", index=0, shape=(4, 4)):
            with observe.span("warp"):
                tail.n = 3
            with observe.span("solve"):
                tail.n = 5
        tail.n = 6
    assert len(log) == 1 and log[0][-1] == "node6"
    assert rec.nodes == 6
    assert rec.labels == [["warp", 0, 0, 3], ["solve", 0, 3, 5], ["other", None, 5, 6]]
    # a graph that is no chain resolves every mark to -1: no count, no table
    tail.resolve = lambda marks: [-1] * len(marks)
    with observe.capture(rec, tail.mark, tail.resolve):
        with observe.span("warp"):
            tail.n = 8
    assert rec.nodes is None and rec.labels is None


def test_one_capture_is_labelled_at_a_time(clean):
    rec = observe.GraphRecord("x")
    with observe.capture(rec, lambda: 0, lambda m: m):
        with pytest.raises(RuntimeError, match="labelled already"):
            with observe.capture(observe.GraphRecord("y"), lambda: 0, lambda m: m):
                pass
    assert rec.nodes == 0 and rec.labels == []
    assert observe.span("x") is observe.span("y")


# --- counters and the record --------------------------------------------


@pytest.fixture
def stand_in(monkeypatch, clean):
    """``_graph`` on the CPU with every capture an eager run labelled with
    the stand-in node count, as if the CPU were a card."""

    class Graph:
        def __init__(self, fn, static, bufs, outputs):
            self.fn, self.static, self.bufs, self.outputs = fn, static, bufs, outputs

        def replay(self):
            for o, n in zip(_fields(self.outputs), _fields(self.fn(*self.bufs, *self.static))):
                o.copy_(n)

        def reset(self):
            pass

    def capture(fn, static, inputs, device, rec):
        bufs = tuple(torch.empty(_graph._shape(x), dtype=torch.float32) for x in inputs)
        new = _graph.Frame(None, bufs, None)
        new.load(inputs)
        with observe.timed("frame.warmup") as warm:
            fn(*bufs, *static)
        with observe.timed("frame.capture") as cap:
            with _Nodes() as nodes, observe.capture(rec, lambda: nodes.n, lambda m: m):
                new.outputs = fn(*bufs, *static)
        rec.warmup_s += warm.seconds
        rec.capture_s += cap.seconds
        new.graph = Graph(fn, static, bufs, new.outputs)
        return new

    monkeypatch.setattr(_graph, "_capture", capture)
    monkeypatch.setattr(_graph, "input_device", lambda x, device=None: torch.device("cuda", 0))
    monkeypatch.setattr(_graph, "_FRAMES", {})


@pytest.mark.parametrize("name,eager,fused,params", MODELS, ids=MODEL_IDS)
def test_a_signature_counts_its_replays_and_captures(stand_in, name, eager, fused, params):
    """``record()`` holds each signature's replays, captures, node count,
    seconds and label table as plain data; ``release_graphs()`` drops the
    tables and keeps the counters, and a second capture counts as one;
    ``reset()`` clears the record."""
    a, b = _pair()
    for _ in range(3):
        fused(a, b, "grad", "gradmag", params)
    fused(a[:, :32], b[:, :32], "grad", "gradmag", params)
    rec = observe.record()
    json.dumps(rec)
    first, second = rec["graphs"]
    assert (first["captures"], first["replays"], second["captures"], second["replays"]) == (
        1, 3, 1, 1)
    assert f".{name}[(3, 40, 56), (3, 40, 56)] cuda:0" in first["signature"]
    assert first["nodes"] > 1000 and first["labels"][-1][3] == first["nodes"]
    assert not [seg for seg in first["labels"] if seg[0] == observe.OTHER]
    assert first["warmup_s"] > 0 and first["capture_s"] > 0
    assert rec["seconds"]["frame.warmup"] == pytest.approx(
        first["warmup_s"] + second["warmup_s"])
    # every request's host steps are timed, the first call's too
    assert {k: rec["calls"][k] for k in ("frame.load", "frame.launch", "frame.clone")} == {
        "frame.load": 4, "frame.launch": 4, "frame.clone": 4}
    assert all(rec["seconds"][k] > 0 for k in ("frame.load", "frame.launch", "frame.clone"))
    _graph.release_graphs()
    kept = observe.record()["graphs"][0]
    assert kept["labels"] is None and (kept["captures"], kept["replays"]) == (1, 3)
    fused(a, b, "grad", "gradmag", params)
    again = observe.record()["graphs"][0]
    assert (again["captures"], again["replays"]) == (2, 4) and again["labels"] is not None
    observe.reset()
    assert observe.record() == {"counters": {}, "seconds": {}, "calls": {}, "graphs": []}


def test_a_snapshot_is_a_copy(stand_in):
    a, b = _pair()
    tflow.flow_nd_fused(a, b, "grad", "gradmag", MODELS[0][3])
    snap = observe.record()
    snap["graphs"][0]["labels"].clear()
    snap["counters"]["x"] = 1
    again = observe.record()
    assert again["graphs"][0]["labels"] and "x" not in again["counters"]


def test_timed_counts_its_own_seconds(clean, monkeypatch):
    clock = iter([0.0, 1.0, 3.0, 10.0])
    monkeypatch.setattr(observe.time, "perf_counter", lambda: next(clock))
    with observe.timed("frame.warmup") as outer:
        with observe.timed("kernels.build") as inner:
            pass
    assert (inner.seconds, outer.seconds) == (2.0, 8.0)
    assert observe.record()["seconds"] == {"frame.warmup": 8.0, "kernels.build": 2.0}
    assert observe.record()["calls"] == {"frame.warmup": 1, "kernels.build": 1}
    observe.count("kernels.built")
    observe.count("kernels.built", 2)
    assert observe.record()["counters"] == {"kernels.built": 3}


def test_the_loader_counts_builds_and_loads(clean, monkeypatch, tmp_path):
    """``kernels.built`` counts the ``nvcc`` runs, not the libraries found
    built; ``kernels.loaded`` each library loaded; both are timed."""
    built = []
    monkeypatch.setattr(build, "library_path", lambda name: tmp_path / f"lib{name}.so")
    monkeypatch.setattr(build, "_compile", lambda name, out, verbose: (built.append(name),
                                                                       out.touch()))
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: ("loaded", path))
    build.load.cache_clear()
    try:
        build.build("one")
        build.build("one")
        assert build.load("two") == ("loaded", str(tmp_path / "libtwo.so"))
        build.load("two")
    finally:
        build.load.cache_clear()
    assert built == ["one", "two"]
    rec = observe.record()
    assert rec["counters"] == {"kernels.built": 2, "kernels.loaded": 1}
    assert set(rec["seconds"]) == {"kernels.build", "kernels.load"}
    assert rec["calls"] == {"kernels.build": 3, "kernels.load": 1}


# --- on the card --------------------------------------------------------


def _device_ops_after_launch(fn):
    """The device operations of ``fn()`` that start at or after its
    ``frame.launch`` span, under the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    launch = [e for e in events if e.name() == "frame.launch"
              and e.device_type() == torch.autograd.DeviceType.CPU]
    assert len(launch) == 1
    start = launch[0].start_ns()
    ops = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA
           and not e.is_user_annotation() and e.start_ns() >= start]
    clones = len(_fields(out))
    return out, len(ops) - clones


CARD_SHAPE = (3, 96, 128)


@pytest.mark.card
@pytest.mark.parametrize("name,eager,fused,params", MODELS, ids=MODEL_IDS)
def test_the_node_count_is_a_replays_device_ops(card, name, eager, fused, params):
    """The capture's node count equals the device operations of one
    profiled replay (the clones' copies after it left out); no node is
    ``other``; replays are counted and the signature captured once."""
    a, b = _pair(CARD_SHAPE)
    fused(a, b, "grad", "gradmag", params)
    fused(a, b, "grad", "gradmag", params)
    out, ops = _device_ops_after_launch(lambda: fused(a, b, "grad", "gradmag", params))
    (rec,) = observe.record()["graphs"]
    assert (rec["captures"], rec["replays"]) == (1, 3)
    assert (rec["inputs"], rec["outputs"]) == (2, len(_fields(out)))
    assert rec["nodes"] == ops
    assert not [seg for seg in rec["labels"] if seg[0] == observe.OTHER]
    assert {seg[0] for seg in rec["labels"]} == set(STAGES)


@pytest.mark.card
@pytest.mark.parametrize("name,eager,fused,params", MODELS, ids=MODEL_IDS)
def test_the_labels_leave_the_graph_as_it_was(card, monkeypatch, name, eager, fused, params):
    """A graph captured with its label table and one captured without it
    replay the same number of device operations and give the same fields,
    bit for bit."""
    a, b = _pair(CARD_SHAPE)
    got = []
    for labelled in (True, False):
        if not labelled:
            monkeypatch.setattr(observe, "GraphTail",
                                lambda stream: types.SimpleNamespace(mark=None, resolve=None))
            monkeypatch.setattr(observe, "capture",
                                lambda rec, mark, resolve: observe.contextlib.nullcontext())
        fused(a, b, "grad", "gradmag", params)
        got.append(_device_ops_after_launch(lambda: fused(a, b, "grad", "gradmag", params)))
        _graph.release_graphs()
    (out1, ops1), (out0, ops0) = got
    assert ops1 == ops0
    assert all(torch.equal(x, y) for x, y in zip(_fields(out1), _fields(out0)))


@pytest.mark.card
def test_the_node_reader_reads_zero_outside_a_capture(card):
    stream = torch.cuda.Stream()
    assert observe.GraphTail(stream).mark() == 0
    assert isinstance(observe._capture_lib(), ctypes.CDLL)
