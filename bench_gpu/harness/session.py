"""One run of a cell: set-up, the measured window, the judgement.

- **Set-up** (``setup_s``, from the process's start): the imports, the
  program's kernels (built by ``nvcc`` into the checkout on its first run,
  loaded from there after), the ring of input clips made from the seed,
  and the traffic's warm-up requests, the first of which captures the
  frame's CUDA graph.
- **The window**: the loop that the traffic names
  (``bench_gpu/loops/<loop>.py``) issues requests for ``seconds`` through
  ``Window.request``. A request hands one clip of the ring, as numpy uint8
  arrays, to the entry point and synchronizes the card: a clip of two
  frames is a pair for ``entry``, a longer one goes to ``clip_entry``.
  Its latency runs from when it was due (a closed loop: when it was
  issued) until its fields are ready.
- **The traced requests** (``trace``): once the window has closed, a few
  more requests run under ``torch.profiler``, with the harness's spans
  around their steps. They come last because the profiler, once it has
  run, slows every later replay of the process (its launch by tens of
  ms, the card's part by a sixth): the window's requests run before it.
- **The judgement**, once the window has closed and the device's peak
  memory has been read: the program's state is freed, the configuration's
  plain reference (``bench_gpu/reference/<reference>.py``) runs on the
  judged clips (drawn from the seed), and the fields the window returned
  for them, the first and the last few of each, are compared with it
  (``judge.py``).

The system under test is the configuration's ``entry`` (``module:name``),
called as ``entry(first, second, **terms, params=params_class(**params))``
(``clip_entry`` as ``clip_entry(frames, ...)``); they and ``release`` are
taken from the checkout the harness lies in.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import importlib
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from bench_gpu.harness import cells, judge, scene
from bench_gpu.harness import trace as tracing
from bench_gpu.harness.stats import percentile


def load(spec: str, root: Path = cells.ROOT):
    """``module:name`` imported from ``root``; a module that lies elsewhere
    (an installed copy of the program) raises."""
    module_name, _, attr = spec.partition(":")
    module = importlib.import_module(module_name)
    path = Path(module.__file__).resolve()
    if root.resolve() not in path.parents:
        raise ImportError(f"{module_name} comes from {path}, not from the checkout {root}")
    return getattr(module, attr)


class Program:
    """The configuration's entry points with their arguments. A call takes
    a clip's frames and returns one tuple of fields a consecutive pair."""

    def __init__(self, config: dict, device=None):
        self.entry = load(config["entry"])
        self.clip_entry = load(config["clip_entry"]) if "clip_entry" in config else None
        params = load(config["params_class"])(**config["params"])
        self.kwargs = {**config["terms"], "params": params}
        if device is not None:
            self.kwargs["device"] = device
        self._release = load(config["release"]) if "release" in config else None

    def __call__(self, frames) -> list:
        if len(frames) == 2:
            out = self.entry(*frames, **self.kwargs)
            return [out if isinstance(out, tuple) else (out,)]
        if self.clip_entry is None:
            raise ValueError("a clip of more than two frames needs the configuration's "
                             "clip_entry")
        out = self.clip_entry(np.stack(frames), **self.kwargs)
        out = out if isinstance(out, tuple) else (out,)
        return [tuple(o[k] for o in out) for k in range(len(frames) - 1)]

    def release(self) -> None:
        if self._release is not None:
            self._release()


class Keeper:
    """The fields kept for judging: of each judged clip, the first and the
    last ``k`` that the window returned, so that the store stays a few
    fields however long the window runs."""

    def __init__(self, slots, k: int):
        self.first = {s: [] for s in slots}
        self.last = {s: collections.deque(maxlen=k) for s in slots}
        self.k = k

    def add(self, slot: int, fields: list) -> None:
        if slot not in self.first:
            return
        (self.first[slot] if len(self.first[slot]) < self.k else self.last[slot]).append(fields)

    def items(self) -> list:
        """[(slot, fields a pair)] of everything kept."""
        return [(s, f) for s in sorted(self.first) for f in self.first[s] + list(self.last[s])]


@dataclasses.dataclass(frozen=True)
class Request:
    """One request of the window: host-clock seconds (``perf_counter``)."""

    index: int
    slot: int
    due: float
    start: float
    call_end: float
    end: float
    ok: bool
    fields: int  # the fields (frame pairs) it returns


@dataclasses.dataclass(frozen=True)
class Outcome:
    """What a loop returns: its requests, the window's start and close."""

    requests: list
    start: float
    close: float
    dropped: int = 0  # due in the window, never served

    @property
    def window_s(self) -> float:
        return self.close - self.start


def _span(name: str, on: bool):
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


class Window:
    """What a loop drives: ``request(i, slot, due)`` serves one request now."""

    def __init__(self, program, ring, traffic: dict, seconds: float, seed: int, sync, keeper):
        self.program, self.ring, self.traffic = program, ring, traffic
        self.seconds, self.seed, self.sync, self.keeper = seconds, seed, sync, keeper
        self.clock = time.perf_counter
        self.failed = 0

    def rng(self, stream: int) -> np.random.Generator:
        """A generator of the seed for the loop's own draws."""
        return scene.seed_rng(self.seed, 3, stream)

    def request(self, i: int, slot: int, due: float | None = None, on: bool = False) -> Request:
        """Serve request ``i`` (clip ``slot`` of the ring) now, with the
        harness's spans where ``on``."""
        with _span("bench.input", on):
            frames = self.ring[slot].frames
        t0 = self.clock()
        t1 = t0
        try:
            with _span("bench.call", on):
                out = self.program(frames)
            t1 = self.clock()
            with _span("bench.sync", on):
                self.sync()
        except RuntimeError:
            self.failed += 1
            if self.failed == 1:
                traceback.print_exc()
            out = None
        t2 = self.clock()
        if out is not None:
            self.keeper.add(slot, out)
        return Request(i, slot, t0 if due is None else due, t0, t1, t2, out is not None,
                       len(frames) - 1)

    def traced(self, first: int, count: int, activities) -> tracing.Trace:
        """Requests ``first`` to ``first + count - 1`` one after another
        under ``torch.profiler``, and the trace's reading."""
        with torch.profiler.profile(activities=list(activities)) as prof:
            for i in range(first, first + count):
                self.request(i, i % len(self.ring), on=True)
        return tracing.from_profiler(prof)


@dataclasses.dataclass
class Run:
    """What the metrics' readers read."""

    cell: cells.Cell
    frame: tuple
    setup_s: float
    outcome: Outcome
    trace: tracing.Trace | None

    @property
    def requests(self) -> list:
        return self.outcome.requests

    @property
    def window_s(self) -> float:
        return self.outcome.window_s


def reference_fields(config: dict, clip, device, precision: str = "float32",
                     root: Path = cells.ROOT) -> list:
    """The plain reference's fields for each consecutive pair of ``clip``."""
    fields = cells.find("reference", config["reference"], root).fields
    f = clip.frames
    return [fields(f[k], f[k + 1], config, device=device, precision=precision)
            for k in range(len(f) - 1)]


def judge_fields(config: dict, ring, kept, device, precision: str = "float32",
                 root: Path = cells.ROOT, log=sys.stderr) -> list:
    """The gaps (every statistic of ``judge.STATISTICS``) of each kept
    field [(slot, fields a pair)] against the reference of its clip, run
    at ``precision``."""
    readings = []
    names = list(judge.STATISTICS)
    with torch.no_grad():
        for slot in sorted({s for s, _ in kept}):
            ref = reference_fields(config, ring[slot], device, precision, root)
            got = [f for s, f in kept if s == slot]
            for out in got:
                if len(out) != len(ref):
                    readings.append(judge.gaps((), ref[0], names))
                    continue
                readings += [judge.gaps(o, r, names) for o, r in zip(out, ref)]
            print(f"clip {slot}: {len(got)} requests' fields judged; reference EPE against "
                  f"the known field {judge.epe(ref[0], ring[slot].truth):.4f} px", file=log)
    if not readings:
        print("no field of the judged clips came back from the window", file=log)
    return readings


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool, device=None, frame=None,
        start: float | None = None, log=sys.stderr) -> dict:
    """One run of ``cell``; returns the result's entries. ``device`` None
    is the card (the caller has checked it); a test passes "cpu" and a
    small ``frame``."""
    start = time.perf_counter() if start is None else start
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    on_card = dev.type == "cuda"
    # the configurations' precision: float32 products, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config, traffic = cell.config, cell.traffic
    loop = cells.find("loops", traffic["loop"], cell.root)
    program = Program(config, device)
    shape = tuple(frame or config["frame"])
    ring = scene.make_ring(config["scene"], shape, int(traffic["ring"]), seed, dev,
                           int(traffic.get("frames", 2)))
    rng = scene.seed_rng(seed, 2)
    judged = [int(k) for k in rng.choice(len(ring), int(traffic["judged_clips"]), replace=False)]
    keeper = Keeper(judged, int(traffic.get("kept_per_clip", 2)))
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    for k in range(int(traffic["warmup_requests"])):
        program(ring[k % len(ring)].frames)
        sync()
    setup_s = time.perf_counter() - start

    window = Window(program, ring, traffic, seconds, seed, sync, keeper)
    outcome = loop.run(window)
    tr = None
    if trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        tr = window.traced(len(outcome.requests) + outcome.dropped,
                           int(traffic["trace_frames"]), activities)
    memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    run_ = Run(cell, shape, setup_s, outcome, tr)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cells.metric_reader(m["name"], cell.root)(run_)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    program.release()
    t_ref = time.perf_counter()
    readings = judge_fields(config, ring, keeper.items(), dev, root=cell.root, log=log)
    names = list(judge.STATISTICS)
    numbers = judge.worst(readings, names)
    correct, checks = judge.verdict(numbers, config["checks"])
    lat = [r.end - r.due for r in outcome.requests]
    quantiles = [round(1e3 * percentile(lat, q), 3) for q in (0, 25, 50, 75, 95, 100)]
    failed = window.failed + outcome.dropped
    print(f"window {outcome.window_s:.3f} s, {len(lat)} requests, {failed} failed, latency ms "
          f"at 0, 25, 50, 75, 95, 100%: {quantiles}; setup {setup_s:.3f} s; reference and "
          f"comparison {time.perf_counter() - t_ref:.3f} s; gaps {numbers}", file=log)
    attempted = len(lat) + outcome.dropped + (tr.n_frames if tr is not None else 0)
    out = {"correct": bool(correct and failed == 0 and readings), "attempted": attempted,
           "failed": failed, "metrics": metrics, "memory_peak_bytes": memory_peak,
           "checks": checks, "gaps": numbers}
    if tr is not None:
        out["busy_s"] = tr.busy_ns() / 1e9
        out["window_s"] = tr.window_ns / 1e9
        out["breakdown"] = tr.breakdown()
    return out
