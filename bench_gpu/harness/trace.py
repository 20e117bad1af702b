"""The reading of a ``torch.profiler`` window of a few requests.

The profiler records the device's operations (kernels, copies, memsets;
those inside a replayed CUDA graph too), the host's operations, and the
harness's own spans around the steps it runs (``bench.input``,
``bench.call``, ``bench.sync``), on one clock. From them:

- **frames**: a traced request runs from its ``bench.input`` start to its
  ``bench.sync`` end; the device operations that start inside it are its
  own (each request ends in a synchronize, so none spills into the next);
- **busy**: the union of the device operations' intervals inside the
  window, the window being the first frame's start to the last's end;
- **layers** of a device operation by its name: the port's own SOR
  kernels (its ``__global__`` functions, in the top-level anonymous
  namespace of ``pde_tpu_torch/csrc``), the matrix products (cuBLAS's
  gemm and gemv kernels), copies and memsets, and PyTorch's other kernels;
- **idle gaps**: every interval of the window with no device operation,
  named by what the host was doing (its innermost event over the
  interval's middle, under the harness's span). Under the profiler the
  host's replay launch takes tens of ms, so these describe the traced
  requests, not untraced ones.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
import re
from collections import defaultdict

SPANS = ("bench.input", "bench.call", "bench.sync")

# the port's SOR kernels (``pde_tpu_torch/csrc/*.cu``; ``lines_kernel`` is
# the line solves')
SOR_KERNELS = frozenset({
    "prepare_kernel", "sweep_kernel", "prepare8_kernel", "sweep8_kernel", "disp_color_kernel",
    "pde4_color_kernel", "pde8_color_kernel", "border_kernel", "border_small_kernel",
    "tiled_sweep_kernel", "tiled_family_kernel", "resident_flow4_kernel", "resident_disp_kernel",
    "resident_pde4_kernel", "resident_llin8_kernel", "resident_pde8_kernel"})
_PORT_KERNEL = re.compile(r"(?:^|void )\(anonymous namespace\)::(\w+)")
_GEMM = re.compile(r"gemm|gemv|splitkreduce", re.IGNORECASE)


@dataclasses.dataclass(frozen=True)
class Interval:
    name: str
    start: int  # ns
    end: int


@functools.lru_cache(maxsize=None)
def layer(name: str) -> str:
    """"sor", "gemm", "copy" (copies and memsets) or "torch" for a device
    operation's name."""
    if name.startswith(("Memcpy", "Memset")):
        return "copy"
    m = _PORT_KERNEL.search(name)
    if m and m.group(1) in SOR_KERNELS:
        return "sor"
    if _GEMM.search(name):
        return "gemm"
    return "torch"


def _union(intervals, lo: int, hi: int) -> list:
    """The merged cover of ``intervals`` clipped to [lo, hi], sorted."""
    out = []
    for iv in sorted(intervals, key=lambda i: i.start):
        s, e = max(iv.start, lo), min(iv.end, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """Device operations, host events and the harness's spans of a traced
    window of whole requests."""

    def __init__(self, device_ops, host_events, spans):
        self.device_ops = sorted(device_ops, key=lambda i: i.start)
        self.host_events = sorted(host_events, key=lambda i: i.start)
        self.spans = sorted(spans, key=lambda i: i.start)
        starts = [s for s in self.spans if s.name == "bench.input"]
        ends = [s for s in self.spans if s.name == "bench.sync"]
        if not starts or len(starts) != len(ends):
            raise ValueError(f"the trace holds {len(starts)} request starts and {len(ends)} ends")
        self.frames = [(a.start, b.end) for a, b in zip(starts, ends)]
        self.window = (self.frames[0][0], self.frames[-1][1])
        self._frame_ops = None

    @property
    def n_frames(self) -> int:
        return len(self.frames)

    @property
    def window_ns(self) -> int:
        return self.window[1] - self.window[0]

    def busy_ns(self) -> int:
        return sum(e - s for s, e in _union(self.device_ops, *self.window))

    def frame_ops(self) -> list:
        """Each frame's device operations."""
        if self._frame_ops is None:
            out = [[] for _ in self.frames]
            starts = [f[0] for f in self.frames]
            for op in self.device_ops:
                k = bisect.bisect_right(starts, op.start) - 1
                if k >= 0 and op.start <= self.frames[k][1]:
                    out[k].append(op)
            self._frame_ops = out
        return self._frame_ops

    def layer_ms(self, name: str) -> float:
        """Device ms a frame in operations of layer ``name``."""
        total = sum(op.end - op.start for ops in self.frame_ops() for op in ops
                    if layer(op.name) == name)
        return total / 1e6 / self.n_frames

    def ops_per_frame(self) -> float:
        return sum(len(ops) for ops in self.frame_ops()) / self.n_frames

    def idle_intervals(self) -> list:
        """(start, end) of every interval of the window with no device operation."""
        lo, hi = self.window
        out, t = [], lo
        for s, e in _union(self.device_ops, lo, hi):
            if s > t:
                out.append((t, s))
            t = e
        if hi > t:
            out.append((t, hi))
        return out

    def host_label(self, t: int) -> str:
        """The harness's span and the innermost host event over time ``t``."""
        span = next((s.name for s in self.spans if s.start <= t <= s.end), "between requests")
        inner = [e for e in self.host_events if e.start <= t <= e.end]
        if inner:
            return f"{span}/{min(inner, key=lambda e: e.end - e.start).name}"
        return span

    def breakdown(self, n: int = 10) -> dict:
        """The ``n`` device operations of most time in the window (s, by
        name) and its ``n`` longest idle intervals named by the host's event."""
        by_name = defaultdict(int)
        for ops in self.frame_ops():
            for op in ops:
                by_name[op.name] += op.end - op.start
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.idle_intervals(), key=lambda g: g[0] - g[1])[:n]
        return {"device_ops": [[name[:160], ns / 1e9] for name, ns in top],
                "idle_gaps": [[self.host_label((s + e) // 2), (e - s) / 1e9] for s, e in gaps]}


def _ns(event, what: str) -> int:
    """An event's start or duration in ns, whichever unit this torch gives."""
    if hasattr(event, f"{what}_ns"):
        return int(getattr(event, f"{what}_ns")())
    return int(getattr(event, f"{what}_us")() * 1000)


def from_profiler(prof) -> Trace:
    """The ``Trace`` of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    device_ops, host, spans = [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = _ns(e, "start")
        iv = Interval(name, start, start + _ns(e, "duration"))
        if name in SPANS:
            if e.device_type() == DeviceType.CPU:
                spans.append(iv)
        elif e.device_type() == DeviceType.CUDA:
            if not (hasattr(e, "is_user_annotation") and e.is_user_annotation()):
                device_ops.append(iv)
        else:
            host.append(iv)
    return Trace(device_ops, host, spans)
