"""The port's tracing: spans, counters and an in-memory record; and the
opt-in ``probe`` hooks ported from ``pde_tpu/utils/observe.py``.

**Spans.** ``span(name, **attrs)`` is one context manager with three
behaviours:

- while ``models/_graph.py`` captures a frame into a CUDA graph
  (``capture``), it notes where the capture stands at its enter and exit:
  the capture's last node (``csrc/capture.cu``), which the end of the
  capture turns into the count of nodes captured up to it. A replay runs
  no Python, so no host span can appear on a replayed frame; but the
  capture is one stream, so the graph is a chain and a replay runs its
  nodes in capture order. The capture's label table (``label_table``) says
  which span enqueued node k, and so names the k-th device operation of a
  profiled replay. The graph is the same, node for node, with or without
  the table;
- else, while a ``torch.profiler`` is active, a
  ``torch.profiler.record_function(name)``: its events share the
  profiler's clock with the device trace;
- else it is one shared null context, a fraction of a µs.

The program's spans: ``level`` (``index``, ``shape``), the parent of the
stages ``pyramid``, ``warp``, ``robust``, ``weights``, ``solve``, ``median``
(``models/flow_nd.py``, ``models/disparity.py``); ``frame.load`` (with
``frame.cast`` and ``frame.copy_in``), ``frame.launch``, ``frame.clone``,
``frame.warmup`` and ``frame.capture`` (``models/_graph.py``);
``kernels.build`` and ``kernels.load`` (``kernels/build.py``).

**Counters and the record**, always on: a captured signature's replays,
captures, node count, inputs and outputs, warm-up and capture seconds,
label table and the counters its capture added; ``kernels.built``
(``nvcc`` runs) and ``kernels.loaded`` (libraries loaded);
``reweight.kernel`` and ``reweight.plain`` (``kernels/dispatch.py``: a
reweighting's robust terms or diffusion weights run by ``csrc/reweight.cu``
or by the plain version); the host-clock seconds and the calls of each
``timed`` span: ``kernels.build``, ``kernels.load``, ``frame.warmup`` and
``frame.capture``, once a library or a signature, and ``frame.load``,
``frame.launch`` and ``frame.clone``, once a request. ``record()``
returns a snapshot of all of it as plain data, ``reset()`` clears it;
``models/_graph.release_graphs()`` drops the label tables with the graphs
and keeps the counters.

**Probes.** The models' ``collect=`` hooks append fields between steps;
``probe(tag, value)`` hands a scalar to the registered sinks at once with
``float(value)``: on a CUDA tensor that is a host sync, which waits for
every queued kernel. Use it sparingly::

    from pde_tpu_torch.utils.observe import probe

    for i in range(iters):
        ...
        probe("residual", torch.linalg.norm(r))
"""

from __future__ import annotations

import bisect
import contextlib
import ctypes
import dataclasses
import functools
import time
from typing import Callable

import torch

# spans that label no node themselves, only carry attributes to the nodes
# of the spans inside them
PARENTS = frozenset({"level"})
# the label of a node no span but a parent enqueued
OTHER = "other"

_NULL = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled

_COUNTS: dict[str, int] = {}
_SECONDS: dict[str, float] = {}
_CALLS: dict[str, int] = {}
_GRAPHS: dict = {}
_TIMED: list = []  # the open ``timed`` spans, innermost last
_capturing: LabelTable | None = None


class LabelTable:
    """The spans noted while a graph was captured: (name, attrs, mark at
    the enter, mark at the exit), in the order they closed; ``mark()``
    says where the capture stands."""

    def __init__(self, mark: Callable[[], object]):
        self.mark = mark
        self.spans: list = []


class _CaptureSpan:
    __slots__ = ("table", "name", "attrs", "start")

    def __init__(self, table: LabelTable, name: str, attrs: dict):
        self.table, self.name, self.attrs = table, name, attrs

    def __enter__(self):
        self.start = self.table.mark()
        return self

    def __exit__(self, *exc):
        self.table.spans.append((self.name, self.attrs, self.start, self.table.mark()))
        return False


def span(name: str, **attrs):
    """A span ``name`` (module docstring): a node range while a frame is
    captured, a ``record_function`` under a profiler, else a no-op."""
    if _capturing is not None:
        return _CaptureSpan(_capturing, name, attrs)
    if _profiling():
        return torch.profiler.record_function(name, repr(attrs) if attrs else None)
    return _NULL


class timed:
    """``span(name)`` whose host-clock seconds add to ``record()``'s
    ``seconds[name]`` and whose exit adds 1 to its ``calls[name]``: its own
    seconds, those of the ``timed`` spans inside it left out (a warm-up
    that builds a kernel counts the build under ``kernels.build`` alone).
    ``seconds`` holds them after the exit."""

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0
        self._inner = 0.0

    def __enter__(self):
        self._span = span(self.name)
        self._span.__enter__()
        _TIMED.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        total = time.perf_counter() - self._t0
        _TIMED.pop()
        if _TIMED:
            _TIMED[-1]._inner += total
        self.seconds = total - self._inner
        _SECONDS[self.name] = _SECONDS.get(self.name, 0.0) + self.seconds
        _CALLS[self.name] = _CALLS.get(self.name, 0) + 1
        return self._span.__exit__(*exc)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


@dataclasses.dataclass
class GraphRecord:
    """What is known of one captured signature."""

    signature: str
    captures: int = 0
    replays: int = 0
    nodes: int | None = None  # the graph's node count
    inputs: int = 0  # static inputs, each copied in before a replay
    outputs: int = 0  # outputs, each cloned after a replay
    warmup_s: float = 0.0  # the eager warm-up runs before each capture
    capture_s: float = 0.0  # the captures, instantiation included
    labels: list | None = None  # label_table of the last capture
    counters: dict = dataclasses.field(default_factory=dict)  # what the last capture counted


def graph(key, describe: Callable[[object], str]) -> GraphRecord:
    """The record of signature ``key``, made (``describe(key)`` its
    ``signature``) where there is none."""
    found = _GRAPHS.get(key)
    if found is None:
        found = _GRAPHS[key] = GraphRecord(describe(key))
    return found


def drop_labels() -> None:
    """Drop every signature's label table; keep its counters."""
    for rec in _GRAPHS.values():
        rec.labels = None


def label_table(spans, n: int) -> list:
    """[label, level, first node, end node] over nodes [0, n), in order: a
    segment for each span but a parent (``PARENTS``) that enqueued a
    node, labelled with its name, and ``OTHER`` between them; ``level`` is
    the ``index`` of the ``level`` span around the segment's first node,
    or None. Spans that overlap give segments that overlap."""
    levels = sorted((s, e, a.get("index")) for name, a, s, e in spans if name in PARENTS and e > s)
    starts = [s for s, _, _ in levels]

    def level_at(k):
        i = bisect.bisect_right(starts, k) - 1
        return levels[i][2] if i >= 0 and k < levels[i][1] else None

    out, t = [], 0
    for s, e, name in sorted((s, e, name) for name, _, s, e in spans
                             if name not in PARENTS and e > s):
        if s > t:
            out.append([OTHER, level_at(t), t, s])
        out.append([name, level_at(s), s, e])
        t = max(t, e)
    if n > t:
        out.append([OTHER, level_at(t), t, n])
    return out


@contextlib.contextmanager
def capture(rec: GraphRecord, mark: Callable[[], object],
            resolve: Callable[[list], list]):
    """Label the nodes the body enqueues: inside, every span notes
    ``mark()``, where the capture stands; at the end ``resolve(marks)``
    turns the marks into node counts (the last, at the end, the graph's
    node count) and ``rec`` takes the count and the label table, and the
    counters the body added (``count``: what the captured frame runs). A
    mark that resolves to -1 (a graph that is no chain) leaves ``rec``
    without the count and the table."""
    global _capturing
    if _capturing is not None:
        raise RuntimeError("a capture is labelled already")
    table = _capturing = LabelTable(mark)
    before = dict(_COUNTS)
    try:
        yield
    finally:
        _capturing = None
    rec.counters = {k: n - before.get(k, 0) for k, n in _COUNTS.items()
                    if n != before.get(k, 0)}
    marks = [m for _, _, s, e in table.spans for m in (s, e)] + [mark()]
    counts = resolve(marks)
    if min(counts) < 0:
        # not a chain: its replay runs nodes in no order a count can name
        rec.nodes, rec.labels = None, None
        return
    spans = [(name, attrs, counts[2 * i], counts[2 * i + 1])
             for i, (name, attrs, _, _) in enumerate(table.spans)]
    rec.nodes = counts[-1]
    rec.labels = label_table(spans, rec.nodes)


@functools.cache
def _capture_lib() -> ctypes.CDLL:
    from pde_tpu_torch.kernels import build

    lib = build.load("capture")
    p = ctypes.c_void_p
    lib.capture_tail.argtypes = [p, ctypes.POINTER(p)]
    lib.capture_tail.restype = ctypes.c_int
    lib.capture_positions.argtypes = [p, ctypes.POINTER(p), ctypes.c_longlong,
                                      ctypes.POINTER(ctypes.c_longlong),
                                      ctypes.POINTER(ctypes.c_ulonglong)]
    lib.capture_positions.restype = ctypes.c_int
    lib.capture_error_string.argtypes = [ctypes.c_int]
    lib.capture_error_string.restype = ctypes.c_char_p
    return lib


class GraphTail:
    """Where the capture on a stream stands (``csrc/capture.cu``): ``mark``
    the capture's last node, in constant time; ``resolve`` the node counts
    of marks (-1 each where the graph is no chain), with one walk back
    along the chain, before the capture ends."""

    def __init__(self, stream: torch.cuda.Stream):
        self._lib = _capture_lib()
        self._stream = ctypes.c_void_p(stream.cuda_stream)
        self._node = ctypes.c_void_p()
        self.mark()

    def _check(self, err: int, what: str) -> None:
        if err:
            raise RuntimeError(f"{what}: {self._lib.capture_error_string(err).decode()}")

    def mark(self) -> int:
        self._check(self._lib.capture_tail(self._stream, ctypes.byref(self._node)),
                    "capture_tail")
        return self._node.value or 0

    def resolve(self, marks: list) -> list:
        n = len(marks)
        out = (ctypes.c_longlong * n)()
        total = ctypes.c_ulonglong()
        self._check(self._lib.capture_positions(self._stream, (ctypes.c_void_p * n)(*marks), n,
                                                out, ctypes.byref(total)), "capture_positions")
        return list(out)


def record() -> dict:
    """A snapshot of the counters, the ``timed`` spans' seconds and calls,
    and each captured signature's record, as plain data."""
    return {"counters": dict(_COUNTS), "seconds": dict(_SECONDS), "calls": dict(_CALLS),
            "graphs": [dataclasses.asdict(rec) for rec in _GRAPHS.values()]}


def reset() -> None:
    """Clear the counters, the seconds, the calls and the signatures'
    records."""
    _COUNTS.clear()
    _SECONDS.clear()
    _CALLS.clear()
    _GRAPHS.clear()


_sinks: list[Callable[[str, float], None]] = []


def add_sink(fn: Callable[[str, float], None]) -> None:
    """Register a host-side consumer for probe values (default: print)."""
    _sinks.append(fn)


def clear_sinks() -> None:
    _sinks.clear()


def probe(tag: str, value) -> None:
    """Report a scalar to the sinks now (``float(value)``: a host sync for a
    CUDA tensor)."""
    v = float(value)
    if _sinks:
        for fn in _sinks:
            fn(tag, v)
    else:
        print(f"[probe] {tag} = {v:.6g}", flush=True)
