"""Whole-frame programs: the ``*_fused`` entry points as CUDA-graph replays.

Where ``pde_tpu`` jits a whole frame into one device program
(``jax.jit`` with static arguments), the port captures the eager frame
once per signature into a CUDA graph and replays it: a frame is then one
graph launch instead of tens of thousands of host-side launches.

- **The signature** (``graph_key``): the eager entry point, its static
  arguments (the terms and the frozen params dataclass), each input's
  shape, the device, and whether ``plain_solvers()`` is on (the dispatch
  reads it while the frame is captured, so it decides what the graph
  runs). Inputs of any dtype are cast to float32 when they are copied in,
  so dtype is not part of it. The cache is unbounded, as jit's is;
  ``release_graphs()`` drops every captured frame and its pool.
- **The first call of a signature** makes float32 static inputs on the
  card, copies the caller's inputs in and runs the eager entry point once
  on them, on the card's capture stream (the warm-up). The warm-up does
  what must not happen under capture: it builds and loads the kernels
  (``kernels/build.py``), fills the kernels' attribute and occupancy
  caches (``csrc/resident_scope.cuh``) and copies the resize matrices to
  the card (``core/resize.py``; a copy from pageable host memory cannot be
  captured). A second run is then captured on the same stream under
  ``torch.no_grad()``, in the default (global) capture mode. One stream a
  card serves every capture: PyTorch keeps a cuBLAS workspace for each
  stream that runs a matmul, so a new stream a capture would leave one
  behind each time, and ``torch.cuda.graph``'s own default stream lies on
  whichever card was current at the process's first capture.
- **Every call** copies the caller's inputs into the static inputs (a
  numpy input from the host: the frame's one host-to-device copy),
  replays the graph and returns clones of the static outputs, so that a
  later replay never overwrites what a caller holds.
- **Inputs on another device than a card** run the eager entry point,
  as it stands: the caller asked for the CPU.

On the card there is no fallback: a capture or replay that fails raises
with the CUDA error and never runs the eager path in its place. The
kernels' launch counters (``LAUNCHES`` of the wrappers) count the
warm-up and the capture, never a replay; ``utils/observe.py``'s record
counts a signature's replays and captures, times its warm-up and capture,
and keeps the capture's node count and label table (the spans of the
frame's stages noted as node ranges). The host's steps of a call are the
``observe.timed`` spans ``frame.load`` (with the spans ``frame.cast`` and
``frame.copy_in``), ``frame.launch`` and ``frame.clone``, and on a
signature's first call ``frame.warmup`` and ``frame.capture``: the record
holds their host-clock seconds and calls, every request's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pde_tpu_torch.kernels.plain_mode import _FORCE_PLAIN
from pde_tpu_torch.models._device import input_device
from pde_tpu_torch.utils import observe

_FRAMES: dict = {}
_STREAMS: dict = {}


@dataclasses.dataclass(eq=False)
class Frame:
    """One captured frame: the graph, its static inputs and outputs (a
    tensor or a tuple of tensors in the graph's pool)."""

    graph: torch.cuda.CUDAGraph
    inputs: tuple
    outputs: object

    def load(self, inputs) -> None:
        """Copy ``inputs`` (tensors or arrays) into the static inputs, on
        the current stream."""
        with observe.timed("frame.load"):
            for buf, x in zip(self.inputs, inputs):
                if not torch.is_tensor(x):
                    with observe.span("frame.cast"):
                        x = torch.from_numpy(np.asarray(x, dtype=np.float32))
                with observe.span("frame.copy_in"):
                    buf.copy_(x)


def _shape(x) -> tuple:
    return tuple(x.shape) if torch.is_tensor(x) else np.shape(x)


def _card(device: torch.device) -> torch.device:
    """``device`` with its index (``cuda`` is the current card)."""
    return device if device.index is not None else torch.device(
        "cuda", torch.cuda.current_device())


def graph_key(fn, static: tuple, inputs, device) -> tuple:
    """The signature of a frame: the eager entry point ``fn``, its static
    arguments, each input's shape, the device and whether
    ``plain_solvers()`` is on."""
    return (fn, static, tuple(_shape(x) for x in inputs), torch.device(device),
            _FORCE_PLAIN.get())


def describe(key: tuple) -> str:
    """A signature as text: the entry point, the input shapes, the device,
    ``plain`` where ``plain_solvers()`` is on, and the static arguments."""
    fn, static, shapes, device, plain = key
    return (f"{fn.__module__}.{fn.__qualname__}{list(shapes)} {device}{' plain' if plain else ''} "
            f"{static!r}")


def _clone(out):
    return tuple(o.clone() for o in out) if isinstance(out, tuple) else out.clone()


def _stream(device: torch.device) -> torch.cuda.Stream:
    """The card's warm-up and capture stream."""
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device)
    return _STREAMS[device]


def _capture(fn, static: tuple, inputs, device: torch.device, rec) -> Frame:
    """The warm-up on ``inputs``, then the capture, labelled into ``rec``
    (an ``observe.GraphRecord``). The warm-up ends in a sync of its
    stream, which the capture's start would wait for anyway."""
    bufs = tuple(torch.empty(_shape(x), dtype=torch.float32, device=device) for x in inputs)
    new = Frame(torch.cuda.CUDAGraph(), bufs, None)
    new.load(inputs)
    stream = _stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with observe.timed("frame.warmup") as warm:
        with torch.cuda.stream(stream), torch.no_grad():
            fn(*bufs, *static)
        tail = observe.GraphTail(stream)
        stream.synchronize()
    torch.cuda.current_stream(device).wait_stream(stream)
    with observe.timed("frame.capture") as cap:
        with torch.cuda.device(device), torch.no_grad(), torch.cuda.graph(new.graph, stream=stream):
            with observe.capture(rec, tail.mark, tail.resolve):
                new.outputs = fn(*bufs, *static)
    rec.warmup_s += warm.seconds
    rec.capture_s += cap.seconds
    rec.inputs = len(bufs)
    rec.outputs = len(new.outputs) if isinstance(new.outputs, tuple) else 1
    return new


def replay(fn, static: tuple, inputs, device=None):
    """``fn(*inputs, *static, device=device)`` as one replayed CUDA graph
    where the inputs go to a card (``models/_device.py``'s rule on the
    first input), else the eager call itself. On the card the frame is
    captured at the signature's first call (the warm-up on these inputs,
    then the capture), else taken from the cache with ``inputs`` copied
    into its static inputs. Returns what ``fn`` returns, in new tensors."""
    device = input_device(inputs[0], device)
    if device.type != "cuda":
        return fn(*inputs, *static, device=device)
    device = _card(device)
    key = graph_key(fn, static, inputs, device)
    rec = observe.graph(key, describe)
    found = _FRAMES.get(key)
    if found is None:
        found = _FRAMES[key] = _capture(fn, static, inputs, device, rec)
        rec.captures += 1
    else:
        found.load(inputs)
    with observe.timed("frame.launch"):
        found.graph.replay()
    rec.replays += 1
    with observe.timed("frame.clone"):
        return _clone(found.outputs)


def release_graphs() -> None:
    """Drop every captured frame and return its graph's pool to the card;
    ``observe``'s record keeps the signatures' counters and drops their
    label tables."""
    for found in _FRAMES.values():
        found.graph.reset()
    _FRAMES.clear()
    observe.drop_labels()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
