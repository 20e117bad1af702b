"""The cell ``flow_nd.fullhd``: flow_nd at Spring's full HD, where the tile
kernel solves the three finest pyramid levels. Its configuration resolves
and runs correct on the CPU at a small frame; the readers of the tiled
calls (``harness/routes.py``) on a recorded window and record; the least
time of the cell's tiled calls."""

import dataclasses

import pytest
import torch

from bench_gpu.harness import cells, judge, routes, scene, session, stages
from bench_gpu.harness.trace import Interval, Trace
from helpers import SMALL

CELL = "flow_nd.fullhd"
METRICS = ("tiled.kernel_ms", "tiled_roofline", "levels.tiled_ms")
US = 1_000
TILED = {"sor.tiled.llin4.1080x1920": 1, "sor.tiled.llin4.810x1440": 1,
         "sor.tiled.llin4.608x1080": 1}
TILE_NAME = ("void (anonymous namespace)::tiled_sweep_kernel<true, 2>((anonymous "
             "namespace)::TileParams)")


def _cell(**traffic) -> cells.Cell:
    cell = cells.resolve(cells.load_benchmark(), CELL)
    return dataclasses.replace(cell, traffic={**cell.traffic, **traffic})


def test_the_cell_resolves_from_its_files():
    bench = cells.load_benchmark()
    assert CELL in [w["name"] for w in bench["workloads"]]
    cell = cells.resolve(bench, CELL)
    assert cell.chips == 1 and cell.traffic["name"] == "online-1stream"
    assert cell.config["name"] == "flow_nd_fullhd" and cell.config["frame"] == [3, 1080, 1920]
    assert cell.config["reference"] == "flow_nd" and cell.config["reduced"] == []
    assert {m["name"] for m in cell.end_to_end} == {"frames_per_s", "setup_s"}
    assert set(METRICS) <= {m["name"] for m in cell.per_layer}
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cells.metric_reader(m["name"]))
    for m in bench["per_layer"]:
        if m["name"] in METRICS:
            assert m["workloads"] == [CELL]


def test_its_configuration_is_flow_nds_at_another_frame_and_motion():
    bench = cells.load_benchmark()
    fullhd = cells.resolve(bench, CELL).config
    sintel = cells.resolve(bench, "flow_nd.sintel").config
    same = ("entry", "clip_entry", "params_class", "release", "params", "terms", "precision",
            "reference", "outputs", "pyramid_stop", "sor")
    assert {k: fullhd[k] for k in same} == {k: sintel[k] for k in same}
    assert fullhd["scene"]["texture"] == sintel["scene"]["texture"]
    motion = fullhd["scene"]["motion"]
    assert motion["uniform"] == [[-6.0, 6.0], [-6.0, 6.0]] and motion["wave_px"] == 3.0
    assert motion["wave_period_px"] == [256.0, 1920.0]
    assert {"uniform", "wave_px", "wave_period_px"} <= set(fullhd["assumed"])


def test_the_reference_agrees_with_the_port_on_the_cpu():
    cell = _cell()
    clip = scene.make_ring(cell.config["scene"], SMALL, 1, 2**31 + 24, "cpu")[0]
    (got,) = session.Program(cell.config, "cpu")(clip.frames)
    (ref,) = session.reference_fields(cell.config, clip, "cpu")
    assert len(got) == len(ref) == 2
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert judge.epe(ref, clip.truth) < 0.5


def test_a_run_on_the_cpu_is_correct():
    cell = _cell(ring=2, judged_clips=2, warmup_requests=1)
    out = session.run(cell, 2**31 + 124, 0.5, True, device="cpu", frame=SMALL)
    assert out["correct"] is True and out["failed"] == 0
    assert out["gaps"]["gap_max_px"] == 0.0  # the same torch ops on the CPU
    # the CPU path counts no SOR route: the readers of the tiled calls read nothing
    assert not set(METRICS) & set(out["metrics"])


def test_the_cells_tiled_calls_least_time():
    """16 calls at each of 1080x1920, 810x1440 and 608x1080, 60 B a pixel
    a call, over 3.35 TB/s: 1.117 ms a frame."""
    counts = {("llin4", h, w): 16 for h, w in ((1080, 1920), (810, 1440), (608, 1080))}
    assert routes.least_ms(counts) == pytest.approx(1.117, abs=5e-4)
    names = {f"sor.tiled.llin4.{h}x{w}": n for (_, h, w), n in counts.items()}
    names.update({"sor.resident.llin4.456x810": 16, "reweight.kernel": 512})
    assert routes.route_counts(names, "tiled") == counts
    assert routes.route_counts(names, "resident") == {("llin4", 456, 810): 16}


# a captured frame of 9 nodes: a pyramid node, then levels 3 (resident),
# 2, 1 and 0 (tiled), each a warp node and a solve node
LABELS = [["pyramid", None, 0, 1]] + [
    [stage, level, 1 + 2 * k + j, 2 + 2 * k + j]
    for k, level in enumerate((3, 2, 1, 0)) for j, stage in enumerate(("warp", "solve"))]
GRAPH = {"signature": "flow_nd", "captures": 1, "replays": 9, "nodes": 9, "inputs": 1,
         "outputs": 1, "warmup_s": 0.5, "capture_s": 0.5, "labels": LABELS,
         "counters": {**TILED, "sor.resident.llin4.456x810": 1, "reweight.kernel": 8}}
RECORD = {"counters": {}, "seconds": {}, "calls": {}, "graphs": [GRAPH]}


def _node_name(k: int) -> str:
    # the solve nodes of levels 2, 1 and 0 are the tile kernel's launches
    if k in (4, 6, 8):
        return TILE_NAME
    if k == 2:
        return "void (anonymous namespace)::resident_flow4_kernel<true, 1>(Params)"
    return f"kernel{k}"


def _trace(drop_tiled_in=()):
    """Two frames 1 ms apart, each the load's copy, the 9 nodes (node k
    (k + 1) us long, 1 us apart) and the clone's copy; the frames in
    ``drop_tiled_in`` lose their last tile-kernel record."""
    ops, spans = [], []
    for f, t in enumerate((0, 1000 * US)):
        spans += [Interval("bench.input", t, t + US), Interval("bench.call", t + US, t + 100 * US),
                  Interval("bench.sync", t + 100 * US, t + 900 * US)]
        ops.append(Interval("Memcpy HtoD (Pageable -> Device)", t + 10 * US, t + 19 * US))
        start = t + 40 * US
        for k in range(9):
            if f in drop_tiled_in and k == 8:
                continue
            ops.append(Interval(_node_name(k), start, start + (k + 1) * US))
            start += (k + 2) * US
        ops.append(Interval("Memcpy DtoD (Device -> Device)", start, start + 2 * US))
    return Trace(ops, [], spans)


def _run(trace, record=RECORD, monkeypatch=None):
    cell = cells.resolve(cells.load_benchmark(), CELL)
    reqs = [session.Request(i, 0, i, i, i + 0.5, i + 0.9, True, 1) for i in range(3)]
    run = session.Run(cell, tuple(cell.config["frame"]), 1.0, session.Outcome(reqs, 0, 3), trace)
    monkeypatch.setattr(stages, "program_record", lambda run: record)
    return run


def test_the_readers_on_a_recorded_window(monkeypatch):
    run = _run(_trace(), monkeypatch=monkeypatch)
    read = {m: cells.metric_reader(m)(run) for m in METRICS}
    # the tile kernel's nodes 4, 6 and 8: 5 + 7 + 9 us
    assert read["tiled.kernel_ms"] == pytest.approx(0.021)
    least = (1080 * 1920 + 810 * 1440 + 608 * 1080) * 60 / 3.35e12 * 1e3
    assert read["tiled_roofline"] == pytest.approx(100 * least / 0.021)
    # every node of levels 2, 1 and 0: nodes 3 to 8, 4 + 5 + ... + 9 us
    assert read["levels.tiled_ms"] == pytest.approx(0.039)
    assert routes.tiled_levels(run) == {0, 1, 2}


def test_a_frame_short_of_its_tiled_launches_is_left_out(monkeypatch):
    """A frame that lost a tile-kernel record is not read; where every
    frame lost one, the readers read None."""
    run = _run(_trace(drop_tiled_in=(1,)), monkeypatch=monkeypatch)
    assert routes.kernel_ms(run) == pytest.approx(0.021)
    run = _run(_trace(drop_tiled_in=(0, 1)), monkeypatch=monkeypatch)
    for m in METRICS:
        assert cells.metric_reader(m)(run) is None, m


def test_no_trace_and_no_counter_read_none(monkeypatch):
    """No trace; a program whose capture counted no route (an earlier
    checkout); a program without a record: every reader reads None."""
    cell = cells.resolve(cells.load_benchmark(), CELL)
    reqs = [session.Request(i, 0, i, i, i + 0.5, i + 0.9, True, 1) for i in range(3)]
    no_trace = session.Run(cell, tuple(cell.config["frame"]), 1.0, session.Outcome(reqs, 0, 3),
                           None)
    uncounted = {**RECORD, "graphs": [{**GRAPH, "counters": {"reweight.kernel": 8}}]}
    runs = [no_trace, _run(_trace(), record=uncounted, monkeypatch=monkeypatch)]
    runs.append(_run(_trace(), record=None, monkeypatch=monkeypatch))
    for run in runs:
        for m in METRICS:
            assert cells.metric_reader(m)(run) is None, m


# --- on the card --------------------------------------------------------


@pytest.mark.card
def test_control_fails_on_the_card():
    """The reference with TF32 resize products in the program's place, on a
    run's judged clips at the cell's own size (``bench_gpu/calibrate.py``'s
    control, seed 2**31 + 453), reads above the mean and 99th-percentile
    limits. The widest gap's limit is a net for gross faults: the control's
    widest gaps (2.0e-3 to 4.5e-2 px) and the sound runs' (up to 2.5e-3)
    overlap, so no limit of it tells the two precisions apart."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    cell = cells.resolve(cells.load_benchmark(), CELL)
    dev = torch.device("cuda", 0)
    seed, traffic = 2**31 + 453, cell.traffic
    ring = scene.make_ring(cell.config["scene"], cell.config["frame"], int(traffic["ring"]), seed,
                           dev, int(traffic.get("frames", 2)))
    judged = scene.seed_rng(seed, 2).choice(len(ring), int(traffic["judged_clips"]),
                                            replace=False)
    kept = [(int(k), session.reference_fields(cell.config, ring[int(k)], dev, "tf32"))
            for k in judged]
    numbers = judge.worst(session.judge_fields(cell.config, ring, kept, dev),
                          list(judge.STATISTICS))
    checks = cell.config["checks"]
    assert all(numbers[n] > checks[n] for n in ("gap_mean_px", "gap_p99_px")), numbers
