"""The reference and the comparison: the reference agrees with the port's
CPU path, the faults a run can have read as not correct, the control in
lower precision fails on the card, and nothing loads JAX."""

import importlib
import json
import subprocess
import sys

import pytest
import torch

from bench_gpu.harness import cells, judge, scene, session
from helpers import CELLS, ROOT, SMALL, small_cell


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port_on_the_cpu(name):
    cell = cells.resolve(cells.load_benchmark(), name)
    clip = scene.make_ring(cell.config["scene"], SMALL, 1, 11, "cpu")[0]
    program = session.Program(cell.config, "cpu")
    (got,) = program(clip.frames)
    (ref,) = session.reference_fields(cell.config, clip, "cpu")
    assert len(got) == len(ref) == len(cell.config["outputs"])
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert judge.epe(ref, clip.truth) < 0.25


@pytest.mark.parametrize("name", CELLS)
def test_a_solver_that_returns_its_state_unchanged_is_not_correct(name, monkeypatch):
    from pde_tpu_torch.solvers import sor

    monkeypatch.setattr(sor, "sor_flow_llin4", lambda u, v, du, dv, *rest: (du, dv))
    monkeypatch.setattr(sor, "sor_disp_llin4", lambda u, du, *rest: du)
    out = session.run(small_cell(name), 2**31 + 5, 0.3, False, device="cpu", frame=SMALL)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("name", CELLS)
def test_an_answer_altered_where_it_is_produced_is_not_correct(name, monkeypatch):
    cell = small_cell(name)
    module_name, attr = cell.config["entry"].split(":")
    module = importlib.import_module(module_name)
    entry = getattr(module, attr)

    def altered(*args, **kwargs):
        out = entry(*args, **kwargs)
        field = out[0] if isinstance(out, tuple) else out
        field[8:16, 8:16] += 0.5
        return out

    monkeypatch.setattr(module, attr, altered)
    out = session.run(cell, 2**31 + 6, 0.3, False, device="cpu", frame=SMALL)
    assert out["correct"] is False


def test_control_in_tf32_moves_the_reference_on_the_cpu():
    """The control's mechanism here: TF32-rounded resize operands change
    the field; at the cells' size on the card it fails the limits
    (``test_control_fails_on_the_card``)."""
    cell = cells.resolve(cells.load_benchmark(), "disparity_nd.kitti")
    clip = scene.make_ring(cell.config["scene"], SMALL, 1, 12, "cpu")[0]
    (ref,) = session.reference_fields(cell.config, clip, "cpu")
    (ctl,) = session.reference_fields(cell.config, clip, "cpu", "tf32")
    assert judge.gaps(ctl, ref, ["gap_max_px"])["gap_max_px"] > 0


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(name):
    """The reference with TF32 resize products, in the program's place at
    the cell's own size, reads above the limits."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    cell = cells.resolve(cells.load_benchmark(), name)
    dev = torch.device("cuda", 0)
    ring = scene.make_ring(cell.config["scene"], cell.config["frame"], 1, 2**31 + 21, dev)
    kept = [(0, session.reference_fields(cell.config, ring[0], dev, "tf32"))]
    numbers = judge.worst(session.judge_fields(cell.config, ring, kept, dev),
                          list(judge.STATISTICS))
    correct, _ = judge.verdict(numbers, cell.config["checks"])
    assert correct is False


@pytest.mark.card
def test_a_short_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    proc = subprocess.run([sys.executable, str(ROOT / "bench_gpu/run.py"), "--workload",
                           "flow_nd.sintel", "--seed", str(2**31 + 3), "--seconds", "3",
                           "--trace", "1"], capture_output=True, text=True, cwd=ROOT,
                          timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["busy_s"] > 0


FORBIDDEN = {"jax", "jaxlib", "flax", "pde_tpu"}


def _loaded(code: str) -> set:
    probe = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); {code}; "
             "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                          timeout=600, env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    loaded = _loaded(
        "import dataclasses; import bench_gpu.run; "
        "from bench_gpu.harness import cells, session; "
        "cell = cells.resolve(cells.load_benchmark(), 'disparity_nd.kitti'); "
        "cell = dataclasses.replace(cell, traffic={**cell.traffic, 'ring': 1, "
        "'judged_clips': 1, 'warmup_requests': 1}); "
        "assert session.run(cell, 3, 0.1, True, device='cpu', frame=(3, 24, 32))['correct']; "
        "[cells.metric_reader(m['name']) for m in cell.end_to_end + cell.per_layer]")
    assert not loaded & FORBIDDEN
    assert "pde_tpu_torch" in loaded


@pytest.mark.parametrize("name", CELLS)
def test_the_reference_loads_nothing_of_the_program(name):
    reference = cells.resolve(cells.load_benchmark(), name).config["reference"]
    loaded = _loaded("from bench_gpu.harness import cells; "
                     f"cells.find('reference', {reference!r}).fields")
    assert not loaded & (FORBIDDEN | {"pde_tpu_torch"})
