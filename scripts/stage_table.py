#!/usr/bin/env python3
"""Where a replayed frame of a benchmark cell spends its device time, stage
by stage and pyramid level by level, from the program's own labels.

    python3 scripts/stage_table.py --workload <cell> --seed <n> [--frames N]
        [--host-frames N] [--out FILE]

Runs the cell's entry point on the card as ``bench_gpu/run.py`` does (the
ring of clips from the seed, the traffic's warm-up requests, the first of
which captures the frame's CUDA graph), then:

- ``--frames`` requests under ``torch.profiler`` (default 4). Their device
  operations are named by the capture's label table
  (``pde_tpu_torch/utils/observe.py``, read by ``bench_gpu/harness/stages.py``):
  device ms a frame by stage and by (stage, level), the time between the
  graph's nodes, the busy time, the device ms of the copies outside the
  graph (the load's and the clones'), and, as a check of the labels' order,
  which stages hold the port's SOR kernels and the matrix products
  (``bench_gpu/harness/trace.py``'s layers);
- ``--host-frames`` untraced requests (default 40) before them: the
  program's own host-clock record of their steps (``frame.load``,
  ``frame.launch``, ``frame.clone``: ms a request) and the median
  request;
- the cost of a span: an ``observe.span`` with no profiler, and one under
  a profiler;
- the set-up's steps on the host clock, from the process's start: the
  imports, the CUDA context, the program's modules, the ring, the first
  request (the warm-up frame and the capture, whose seconds the program's
  record splits) and the other warm-up requests.

Prints the card's name and power limit and one JSON object last (also
written to ``--out``); exits non-zero without a card.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse
import json
import statistics
import sys
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from bench_gpu.harness import card, cells, scene, session, stages  # noqa: E402
from bench_gpu.harness.trace import _union, layer  # noqa: E402

IMPORTED = time.perf_counter()


def _span_cost(observe, n: int = 100_000) -> dict:
    t = time.perf_counter()
    for _ in range(n):
        with observe.span("x"):
            pass
    off = (time.perf_counter() - t) / n
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        t = time.perf_counter()
        for _ in range(n // 10):
            with observe.span("x"):
                pass
        on = (time.perf_counter() - t) / (n // 10)
    return {"span_off_us": off * 1e6, "span_profiled_us": on * 1e6}


def _frame_of(tr, nodes):
    """The traced frame (its bounds and device operations) that holds
    ``nodes``."""
    return next((f, ops) for f, ops in zip(tr.frames, tr.frame_ops())
                if f[0] <= nodes[0].start <= f[1])


def _gaps(tr, frames) -> dict:
    """The idle time between consecutive nodes of the traced replays, us:
    quantiles, the holes over ``stages.HOLE_NS``, the sums of the gaps
    before and after the host's launch returned, and the nodes that read as
    starting before their launch span did (the profiler's clocks)."""
    launches = [e for e in tr.host_events if e.name == "frame.launch"]
    gaps, during, after, early = [], 0, 0, []
    for nodes in frames:
        (lo, hi), _ = _frame_of(tr, nodes)
        (launch,) = [e for e in launches if lo <= e.start <= hi]
        early.append(sum(op.start < launch.start for op in nodes))
        reach = nodes[0].end
        for op in nodes[1:]:
            g = max(0, op.start - reach)
            gaps.append(g)
            if op.start <= launch.end:
                during += g
            else:
                after += g
            reach = max(reach, op.end)
    q = statistics.quantiles(gaps, n=100)
    n = len(frames)
    return {"p50_us": q[49] / 1e3, "p90_us": q[89] / 1e3, "p99_us": q[98] / 1e3,
            "max_us": max(gaps) / 1e3, "holes": sum(g > stages.HOLE_NS for g in gaps) / n,
            "during_launch_ms": during / 1e6 / n, "after_launch_ms": after / 1e6 / n,
            "nodes_before_launch_span": early}


def _host_steps(observe, program, ring, frames: int) -> dict:
    """Host ms a request of ``frames`` untraced requests: each step the
    program times (its record's seconds over its calls) and the median
    request, from the call to the card's end."""
    before = observe.record()
    requests = []
    for i in range(frames):
        t0 = time.perf_counter()
        program(ring[i % len(ring)].frames)
        torch.cuda.synchronize()
        requests.append(1e3 * (time.perf_counter() - t0))
    after = observe.record()
    out = {}
    for step in ("frame.load", "frame.launch", "frame.clone"):
        calls = after["calls"][step] - before["calls"].get(step, 0)
        out[step] = 1e3 * (after["seconds"][step] - before["seconds"].get(step, 0.0)) / calls
    out["request_median"] = statistics.median(requests)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--host-frames", type=int, default=40)
    ap.add_argument("--out")
    args = ap.parse_args()
    cell = cells.resolve(cells.load_benchmark(), args.workload)
    try:
        card.require(cell.chips)
    except card.NoCard as exc:
        print(f"stage_table: {exc}", file=sys.stderr)
        return 2
    print(card.power_limit(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from pde_tpu_torch.utils import observe

    dev = torch.device("cuda", 0)
    marks = {"imports": IMPORTED}
    torch.zeros(1, device=dev)
    marks["context"] = time.perf_counter()
    program = session.Program(cell.config, None)
    marks["program"] = time.perf_counter()
    shape = tuple(cell.config["frame"])
    ring = scene.make_ring(cell.config["scene"], shape, 2, args.seed, dev)
    marks["ring"] = time.perf_counter()
    for k in range(int(cell.traffic["warmup_requests"])):
        program(ring[k % len(ring)].frames)
        torch.cuda.synchronize()
        marks.setdefault("first_request", time.perf_counter())
    marks["warm_requests"] = time.perf_counter()
    t, setup_s = START, {}
    for name, at in marks.items():
        setup_s[name] = at - t
        t = at
    host = _host_steps(observe, program, ring, args.host_frames)
    window = session.Window(program, ring, cell.traffic, 0.0, args.seed,
                            torch.cuda.synchronize, session.Keeper([], 1))
    tr = window.traced(0, args.frames, [torch.profiler.ProfilerActivity.CPU,
                                        torch.profiler.ProfilerActivity.CUDA])
    run = session.Run(cell, shape, 0.0, session.Outcome([], 0.0, 0.0), tr)
    graph = stages.main_graph(run)
    frames = stages.frame_nodes(run, graph)
    by = stages.split(run)
    if frames is None or by is None:
        print("stage_table: the traced frames do not hold the graph's nodes", file=sys.stderr)
        return 1
    labels = stages.node_labels(graph)
    mix = defaultdict(lambda: defaultdict(int))
    for op, (stage, _) in zip(frames[0], labels):
        mix[stage][layer(op.name)] += 1
    n = tr.n_frames
    per_stage = defaultdict(float)
    per_level = defaultdict(dict)
    for (stage, level), ms in by.items():
        per_stage[stage] += ms
        per_level["before" if level is None else level][stage] = ms
    outside = 0
    for nodes in frames:
        inside = {id(op) for op in nodes}
        outside += sum(op.end - op.start for op in _frame_of(tr, nodes)[1]
                       if id(op) not in inside)
    outside /= 1e6 * len(frames)
    spans = defaultdict(list)
    for e in tr.host_events:
        if e.name.startswith("frame."):
            spans[e.name].append((e.end - e.start) / 1e6)
    rec = observe.record()
    out = {
        "workload": args.workload, "seed": args.seed, "card": card.power_limit(),
        "nodes": graph["nodes"], "captures": graph["captures"], "replays": graph["replays"],
        "frames_read": len(frames), "frames_traced": n,
        "ops_per_frame": [len(ops) for ops in tr.frame_ops()],
        "other_nodes": sum(e - s for lab, _, s, e in graph["labels"] if lab == observe.OTHER),
        "device_ops_per_frame": tr.ops_per_frame(),
        "busy_ms": tr.busy_ns() / 1e6 / n,
        "busy_read_ms": sum(e - s for nodes in frames for s, e in _union(
            _frame_of(tr, nodes)[1], *_frame_of(tr, nodes)[0])) / 1e6 / len(frames),
        "stage_ms": dict(per_stage), "stage_sum_ms": sum(per_stage.values()),
        "outside_graph_ms": outside, "gap_ms": stages.gap_ms(run), "gaps": _gaps(tr, frames),
        "level_ms": {str(k): v for k, v in sorted(per_level.items(), key=lambda kv: (
            kv[0] != "before", -kv[0] if kv[0] != "before" else 0))},
        "layers_by_stage": {k: dict(v) for k, v in mix.items()},
        "traced_span_ms": {k: statistics.median(v) for k, v in spans.items()},
        "untraced_host_ms": host,
        "setup_s": setup_s,
        "setup": {"warmup_s": graph["warmup_s"], "capture_s": graph["capture_s"],
                  "seconds": rec["seconds"], "counters": rec["counters"]},
        **_span_cost(observe),
    }
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
