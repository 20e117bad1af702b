"""The harness on the CPU: cells found by name, the profile's arithmetic,
the byte counts, the percentile, and a whole run at a small size."""

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest

from bench_gpu.harness import cells, peaks, scene, session, stats
from bench_gpu.harness.trace import Interval, Trace, layer
from helpers import CELLS, ROOT, SMALL, small_cell

def test_every_cell_resolves_from_its_files():
    bench = cells.load_benchmark()
    assert [w["name"] for w in bench["workloads"]] == list(CELLS)
    for name in CELLS:
        cell = cells.resolve(bench, name)
        assert cell.chips == 1
        assert cell.config["name"] == name.split(".")[0]
        assert cell.traffic["name"] == "online-1stream"
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "frames_per_s"}
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cells.metric_reader(m["name"]))


BURSTS = """
import time
from pathlib import Path

from bench_gpu.harness.session import Outcome


def run(window):
    Path(__file__).with_suffix(".ran").touch()
    requests = []
    start = window.clock()
    i = 0
    while window.clock() - start < window.seconds:
        for _ in range(int(window.traffic["burst"])):
            requests.append(window.request(i, i % len(window.ring)))
            i += 1
        time.sleep(0.01)
    return Outcome(requests, start, requests[-1].end)
"""

MARKED_REFERENCE = """

_fields = fields


def fields(*args, **kwargs):
    import pathlib

    pathlib.Path(__file__).with_suffix(".ran").touch()
    return _fields(*args, **kwargs)
"""


def test_a_cell_of_new_files_alone_runs(tmp_path):
    """A later cell adds a configuration with its own reference, a traffic
    mix with its own loop, and a metric, as new files and entries: the
    harness loads and runs it unchanged."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench_gpu", tmp_path / "bench_gpu",
                    ignore=shutil.ignore_patterns("__pycache__"))
    new = tmp_path / "bench_gpu"
    config = json.loads((ROOT / "bench_gpu/configs/flow_nd.json").read_text())
    config.update(name="flow_nd_small", frame=list(SMALL), reference="flow_nd_small")
    (new / "configs/flow_nd_small.json").write_text(json.dumps(config))
    (new / "reference/flow_nd_small.py").write_text(
        (ROOT / "bench_gpu/reference/flow_nd.py").read_text()
        + MARKED_REFERENCE)
    traffic = json.loads((ROOT / "bench_gpu/traffic/online-1stream.json").read_text())
    traffic.update(name="bursts-2", loop="bursts", burst=2, ring=2, judged_clips=2,
                   warmup_requests=1)
    (new / "traffic/bursts-2.json").write_text(json.dumps(traffic))
    (new / "loops/bursts.py").write_text(BURSTS)
    (new / "metrics/frames_per_min.py").write_text(
        "def read(run):\n    return 60 * len(run.requests) / run.window_s\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "flow_nd_small", "source": "test",
                             "file": "bench_gpu/configs/flow_nd_small.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "flow_nd_small.bursts", "config": "flow_nd_small",
                               "traffic": "bursts-2", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "frames_per_min", "unit": "frames/min",
                                "better": "higher", "bound": 0.05, "source": "host_clock",
                                "workloads": ["flow_nd_small.bursts"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    bench = cells.load_benchmark(tmp_path)
    cell = cells.resolve(bench, "flow_nd_small.bursts", tmp_path)
    assert cell.config["frame"] == list(SMALL) and cell.traffic["loop"] == "bursts"
    assert "frames_per_min" not in {m["name"] for m in
                                    cells.resolve(bench, "flow_nd.sintel").end_to_end}
    out = session.run(cell, 5, 0.3, False, device="cpu")
    assert out["correct"] is True
    assert out["metrics"]["frames_per_min"]["value"] > 0
    assert set(out["metrics"]) == {"frames_per_s", "setup_s", "frames_per_min"}
    assert (new / "loops/bursts.ran").exists() and (new / "reference/flow_nd_small.ran").exists()


def test_the_new_loop_and_reference_are_the_ones_run(tmp_path, monkeypatch):
    """The loop and the reference are taken from the files the cell names."""
    calls = []
    real = cells.find

    def spy(kind, name, root=ROOT):
        calls.append((kind, name))
        return real(kind, name, root)

    monkeypatch.setattr(cells, "find", spy)
    out = session.run(small_cell("flow_nd.sintel"), 6, 0.2, False, device="cpu", frame=SMALL)
    assert out["correct"] is True
    assert ("loops", "closed") in calls and ("reference", "flow_nd") in calls


@pytest.mark.parametrize("arrivals", ["periodic", "poisson"])
def test_an_open_loop_runs_from_its_parameters(arrivals):
    """An open loop is the traffic file's data: the rate, the arrivals;
    latency runs from when a request fell due."""
    cell = small_cell("disparity_nd.kitti", loop="open", rate_per_s=20.0, arrivals=arrivals)
    out = session.run(cell, 2**31 + 7, 0.5, False, device="cpu", frame=SMALL)
    assert out["correct"] is True and out["failed"] == 0
    assert 5 <= out["attempted"] <= 20
    assert 0 < out["metrics"]["frames_per_s"]["value"] <= 21


def test_a_clip_traffic_runs_the_clip_entry():
    """A request of three frames goes to ``clip_entry`` and returns two
    fields, each judged against the reference of its pair."""
    cell = small_cell("flow_nd.sintel", frames=3, ring=1, judged_clips=1)
    out = session.run(cell, 2**31 + 8, 0.3, False, device="cpu", frame=SMALL)
    assert out["correct"] is True
    assert out["gaps"]["gap_max_px"] == 0.0
    assert out["metrics"]["frames_per_s"]["value"] > 0


def test_the_keeper_holds_the_first_and_last_fields():
    keeper = session.Keeper([0, 2], 2)
    for i in range(9):
        keeper.add(i % 3, [(i,)])
    assert [(s, f[0][0]) for s, f in keeper.items()] == [(0, 0), (0, 3), (0, 6), (2, 2),
                                                          (2, 5), (2, 8)]
    for i in range(9, 30):
        keeper.add(i % 3, [(i,)])
    assert [f[0][0] for s, f in keeper.items() if s == 0] == [0, 3, 24, 27]


def _trace():
    """Two requests of 10 ms, 4 ms apart: the first with a copy, a resize
    product, a PyTorch kernel and an SOR kernel, the second the same."""
    ms = 1_000_000
    ops, spans, host = [], [], []
    for k, t in enumerate((0, 14 * ms)):
        spans += [Interval("bench.input", t, t + ms // 10),
                  Interval("bench.call", t + ms // 10, t + 2 * ms),
                  Interval("bench.sync", t + 2 * ms, t + 10 * ms)]
        host.append(Interval("cudaDeviceSynchronize", t + 2 * ms, t + 10 * ms))
        ops += [Interval("Memcpy HtoD (Pageable -> Device)", t + ms, t + 2 * ms),
                Interval("sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize64x64", t + 2 * ms,
                         t + 3 * ms),
                Interval("void at::native::vectorized_elementwise_kernel<4, "
                         "at::native::(anonymous namespace)::sqrt_kernel>", t + 3 * ms,
                         t + 5 * ms),
                # an overlapping operation counts once in the busy time
                Interval("void at::native::reduce_kernel<512, 1>", t + 4 * ms, t + 6 * ms),
                Interval("(anonymous namespace)::resident_flow4_kernel((anonymous "
                         "namespace)::Params)", t + 7 * ms, t + 9 * ms)]
    return Trace(ops, host, spans)


def test_profile_arithmetic_on_a_recorded_window():
    tr = _trace()
    ms = 1_000_000
    assert tr.n_frames == 2 and tr.window == (0, 24 * ms)
    assert tr.busy_ns() == 2 * 7 * ms  # 1-6 and 7-9 in each frame
    assert tr.ops_per_frame() == 5
    assert [layer(op.name) for op in tr.frame_ops()[0]] == ["copy", "gemm", "torch", "torch",
                                                           "sor"]
    assert tr.layer_ms("sor") == 2.0 and tr.layer_ms("gemm") == 1.0
    assert tr.layer_ms("torch") == 4.0 and tr.layer_ms("copy") == 1.0
    assert tr.idle_intervals()[:3] == [(0, ms), (6 * ms, 7 * ms), (9 * ms, 15 * ms)]
    top = tr.breakdown()
    assert top["device_ops"][0][1] == pytest.approx(0.004)
    assert top["idle_gaps"][0] == ["between requests", pytest.approx(0.006)]
    assert ["bench.sync/cudaDeviceSynchronize", pytest.approx(0.001)] in top["idle_gaps"]


def test_the_readers_on_a_recorded_window():
    """The window: four requests 10 ms apart, each 2 ms in the entry call;
    the traced requests after it: 7 busy ms a request."""
    cell = cells.resolve(cells.load_benchmark(), "flow_nd.sintel")
    reqs = [session.Request(i, i % 8, t, t, t + 0.002, t + 0.009, True, 1)
            for i, t in enumerate((0.05, 0.06, 0.07, 0.08))]
    outcome = session.Outcome(reqs, 0.05, 0.45)
    run = session.Run(cell, tuple(cell.config["frame"]), 10.0, outcome, _trace())
    read = {m["name"]: cells.metric_reader(m["name"])(run)
            for m in cell.end_to_end + cell.per_layer}
    assert read["frames_per_s"] == pytest.approx(10.0) and read["setup_s"] == 10.0
    assert read["device.idle_pct"] == pytest.approx(100 * (1 - 7 / 10))
    assert read["host.call_ms"] == pytest.approx(2.0)
    assert read["graph.device_ops"] == 5
    assert read["resize.gemm_ms"] == 1.0 and read["ops.torch_ms"] == 4.0
    assert read["sor.kernel_ms"] == 2.0
    assert read["sor_roofline"] == pytest.approx(100 * 0.292949 / 2.0, rel=1e-5)


def test_the_readers_find_nothing_without_a_trace():
    cell = cells.resolve(cells.load_benchmark(), "disparity_nd.kitti")
    reqs = [session.Request(i, 0, i, i, i + 0.5, i + 0.9, True, 1) for i in range(3)]
    run = session.Run(cell, tuple(cell.config["frame"]), 1.0, session.Outcome(reqs, 0, 3), None)
    for m in cell.per_layer:
        if m["name"] != "host.call_ms":
            assert cells.metric_reader(m["name"])(run) is None, m["name"]


@pytest.mark.parametrize("name", CELLS)
def test_the_traced_requests_follow_the_window(name):
    """A traced run's window is untraced; the profiled requests come after
    it, four of them, with their spans, and are judged too."""
    cell = small_cell(name)
    out = session.run(cell, 2**31 + 9, 0.3, True, device="cpu", frame=SMALL)
    assert out["correct"] is True
    assert out["window_s"] > 0 and "breakdown" in out
    assert out["metrics"]["host.call_ms"]["value"] > 0


def test_byte_counts_give_the_kernel_tables_bounds():
    """481x641, one call: 5.5 us for llin4, 3.3 us for disp (3.35 TB/s)."""
    for family, us in (("llin4", 5.5), ("disp", 3.3), ("elin4", 4.8), ("llin8", 7.0)):
        t = 481 * 641 * peaks.sor_bytes_per_px(family) / peaks.HBM_BYTES_PER_S * 1e6
        assert round(t, 1) == us
    assert round(481 * 641 * peaks.sor_bytes_per_px("pde4", 3) / peaks.HBM_BYTES_PER_S * 1e6,
                 1) == 5.9


def test_the_cells_sor_work():
    bench = cells.load_benchmark()
    flow = cells.resolve(bench, "flow_nd.sintel").config
    disp = cells.resolve(bench, "disparity_nd.kitti").config
    assert len(peaks.pyramid_scales(436, 1024, 0.75, flow["pyramid_stop"])) == 12
    assert len(peaks.pyramid_scales(375, 1242, 0.75, disp["pyramid_stop"])) == 15
    assert peaks.sor_calls_per_level(flow) == 16 and peaks.sor_calls_per_level(disp) == 24
    assert peaks.sor_least_ms(flow) == pytest.approx(0.2929, abs=1e-4)
    assert peaks.sor_least_ms(disp) == pytest.approx(0.2758, abs=1e-4)


@pytest.mark.parametrize("name", CELLS)
def test_the_pyramid_stop_is_the_configurations(name):
    """The roofline's byte count and the reference both take the
    configuration's ``pyramid_stop``: one level more with a lower stop."""
    config = cells.resolve(cells.load_benchmark(), name).config
    lower = {**config, "pyramid_stop": 4}
    frame = (3, 24, 32)
    levels = len(peaks.pyramid_scales(24, 32, 0.75, config["pyramid_stop"]))
    assert len(peaks.pyramid_scales(24, 32, 0.75, 4)) > levels
    assert peaks.sor_frame_bytes(lower, frame) > peaks.sor_frame_bytes(config, frame)
    clip = scene.make_ring(config["scene"], frame, 1, 3, "cpu")[0]
    a = session.reference_fields(config, clip, "cpu")[0]
    b = session.reference_fields(lower, clip, "cpu")[0]
    assert not all(bool((x == y).all()) for x, y in zip(a, b))


def test_percentile_is_numpys():
    rng = np.random.default_rng(1)
    xs = list(rng.random(37))
    for q in (0, 50, 95, 100):
        assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))


def test_scene_is_the_seeds_and_its_field_is_known():
    cfg = cells.resolve(cells.load_benchmark(), "disparity_nd.kitti").config
    big = 2**31 + 12345
    a = scene.make_ring(cfg["scene"], SMALL, 2, big, "cpu")
    b = scene.make_ring(cfg["scene"], SMALL, 2, big, "cpu")
    c = scene.make_ring(cfg["scene"], SMALL, 2, big + 1, "cpu")
    assert all(np.array_equal(x, y) for p, q in zip(a, b) for x, y in zip(p.frames, q.frames))
    assert not np.array_equal(a[0].frames[0], c[0].frames[0])
    assert not np.array_equal(a[0].frames[0], a[1].frames[0])
    clip = a[0]
    assert len(clip.frames) == 2
    assert clip.frames[0].dtype == np.uint8 and clip.frames[0].shape == SMALL
    (u,) = clip.truth
    assert (u < -1.0).all() and (u > -17.0).all()  # the model's U is -disparity
    longer = scene.make_ring(cfg["scene"], SMALL, 2, big, "cpu", n_frames=4)
    assert len(longer[0].frames) == 4
    assert all(np.array_equal(x, y) for x, y in zip(longer[0].frames[:2], a[0].frames))


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_on_the_cpu_is_correct(name):
    cell = small_cell(name)
    out = session.run(cell, 2**31 + 99, 0.5, False, device="cpu", frame=SMALL)
    assert out["correct"] is True and out["failed"] == 0
    assert out["gaps"]["gap_max_px"] == 0.0  # the same torch ops on the CPU
    assert list(out["checks"]) == list(cell.config["checks"])


def test_run_without_a_card_fails_loudly(tmp_path):
    proc = subprocess.run([sys.executable, str(ROOT / "bench_gpu/run.py"), "--workload",
                           "flow_nd.sintel", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_run_outside_a_checkout_fails(tmp_path):
    """A directory of BENCHMARK.json and bench_gpu alone has no program."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench_gpu", tmp_path / "bench_gpu",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = cells.load_benchmark(tmp_path)
    cell = cells.resolve(bench, "flow_nd.sintel", tmp_path)
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from bench_gpu.harness import session;"
            "session.load('pde_tpu_torch.models.flow_nd:flow_nd_fused')")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                          text=True, cwd=tmp_path, timeout=300)
    assert proc.returncode != 0
    assert cell.config["entry"].startswith("pde_tpu_torch")
