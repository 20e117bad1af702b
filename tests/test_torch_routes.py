"""Where each SOR call of a frame goes, and the counter that says so.

``kernels/dispatch.sor_route`` sends a solve to the resident, the tile or
the global kernel from its shape; each card call counts
``sor.<route>.<family>.<H>x<W>`` (``utils/observe.py``). Here (no card):

- the routes of ``flow_nd``'s pyramid at Spring's full HD (3x1080x1920, 16
  levels): the tile kernel with a 16x48, k = 4 plan at exactly the three
  finest levels, the resident kernel at the other 13; MPI-Sintel's 12 and
  KITTI's 15 levels have no tiled level;
- the counter's name and count for each route of every family, the card's
  kernels replaced by stand-ins on the ``meta`` device;
- the plain tile schedule (torch ops) at that plan's tiles, on small
  frames of the full-HD levels' aspect, equals the plain sweep;
- the plain path (CPU tensors, ``plain_solvers()``) counts no ``sor.*``.

The tests marked ``card`` capture a ``flow_nd_fused`` frame at 1080x1920
on the card and read its counters; they skip where torch sees no card. On
the card (``tests/conftest.py`` imports JAX, which the card's host lacks)::

    python -m pytest tests/test_torch_routes.py -q -m card --noconftest
"""

import importlib

import numpy as np
import pytest
import torch

from pde_tpu_torch.core.pyramid import pyramid_scales
from pde_tpu_torch.kernels import (dispatch, interior_cuda, resident_cuda, sor_cuda, sweeps,
                                   tiled, tiled_cuda)
from pde_tpu_torch.kernels.plain_mode import plain_solvers
from pde_tpu_torch.models import _graph
from pde_tpu_torch.solvers import sor
from pde_tpu_torch.utils import observe

tflow = importlib.import_module("pde_tpu_torch.models.flow_nd")
tdisp = importlib.import_module("pde_tpu_torch.models.disparity")

torch.set_num_threads(1)

SMS = 132  # the H100 SXM's
# (frame (H, W), SOR family, pyramid stop): the benchmark's cells
CELL_PYRAMIDS = {"flow_nd.fullhd": ((1080, 1920), "llin4", 20),
                 "flow_nd.sintel": ((436, 1024), "llin4", 20),
                 "disparity_nd.kitti": ((375, 1242), "disp", 10)}
FULLHD_TILED = [(1080, 1920), (810, 1440), (608, 1080)]


@pytest.fixture
def clean():
    observe.reset()
    yield
    observe.reset()


def _sor_counts(counters: dict, route: str | None = None) -> dict:
    prefix = "sor." if route is None else f"sor.{route}."
    return {k: n for k, n in counters.items() if k.startswith(prefix)}


# --- the routes of the cells' pyramids ----------------------------------


def _levels(cell: str):
    (h, w), family, stop = CELL_PYRAMIDS[cell]
    return [tuple(s) for s in pyramid_scales(h, w, 0.75, stop)], family


def test_the_cells_pyramids_have_their_levels():
    assert [len(_levels(c)[0]) for c in CELL_PYRAMIDS] == [16, 12, 15]
    assert _levels("flow_nd.fullhd")[0][:3] == FULLHD_TILED


@pytest.mark.parametrize("level", range(16))
def test_fullhd_takes_the_tile_kernel_at_its_three_finest_levels(level):
    levels, family = _levels("flow_nd.fullhd")
    route, plan = dispatch.sor_route(family, *levels[level], 1, 4, SMS)
    if level < 3:
        assert route == "tiled"
        assert (plan.k, plan.tile_h, plan.tile_w) == (4, 16, 48)
    else:
        assert route == "resident"
        assert plan == resident_cuda.plan_resident(*levels[level], family, 1, SMS)


@pytest.mark.parametrize("cell", ["flow_nd.sintel", "disparity_nd.kitti"])
def test_the_other_cells_take_no_tiled_level(cell):
    levels, family = _levels(cell)
    assert {dispatch.sor_route(family, h, w, 1, 4, SMS)[0] for h, w in levels} == {"resident"}


# --- the counter of each route ------------------------------------------


def _meta(shape):
    return torch.empty(shape, device="meta")


def _call(entry: str, shape):
    """Call ``dispatch.<entry>`` with meta fields: X, TRACE, B (and every
    field of the flows and the disparity) of ``shape``, weights (H, W)."""
    hw = shape[-2:]
    if entry in ("sor_flow_llin4", "sor_flow_elin4", "sor_flow_llin8"):
        n = {"sor_flow_llin4": 13, "sor_flow_elin4": 11, "sor_flow_llin8": 17}[entry]
        args = [_meta(shape) for _ in range(n)]
    elif entry == "sor_disp_llin4":
        args = [_meta(shape) for _ in range(8)]
    elif entry == "sor_disp_llin_sym4":
        args = [_meta(shape) for _ in range(16)]
    else:
        n_w = 4 if entry == "sor_pde4" else 8
        args = [_meta(shape) for _ in range(3)] + [_meta(hw) for _ in range(n_w)]
    return getattr(dispatch, entry)(*args, 4, 1.9)


@pytest.fixture
def stand_ins(monkeypatch):
    """Every card kernel of the SOR families replaced by one that notes its
    name; 132 SMs."""
    called = []

    def stub(name):
        def run(*args, **kwargs):
            called.append(name)
            # the tile wrapper takes (family, fields, ...) and returns the relaxed fields
            fields = args[1] if name.startswith("tiled.") else args
            return fields[0], fields[1]
        return run

    def systems(family, systems, *args, **kwargs):
        called.append("tiled.systems")
        return [(s[0],) for s in systems]

    monkeypatch.setattr(resident_cuda, "sm_count", lambda index: SMS)
    for mod, prefix in ((resident_cuda, "resident"), (sor_cuda, "global"),
                        (interior_cuda, "global")):
        for name in ("flow_llin4_sor", "flow_elin4_sor", "flow_llin8_sor", "disp_llin4_sor",
                     "pde4_sor", "pde8_sor", "disp_llin4_pair"):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, stub(f"{prefix}.{name}"))
    monkeypatch.setattr(tiled_cuda, "tiled_sor", stub("tiled.tiled_sor"))
    monkeypatch.setattr(tiled_cuda, "tiled_sor_systems", systems)
    return called


# (dispatch entry, family, route, the fields' shape): one call of each
# route of every family; a flow whose fields carry a batch no other kernel
# takes goes to the global kernel
COUNTED = {
    "llin4 resident": ("sor_flow_llin4", "llin4", "resident", (480, 640)),
    "llin4 tiled": ("sor_flow_llin4", "llin4", "tiled", (1080, 1920)),
    "llin4 global": ("sor_flow_llin4", "llin4", "global", (2, 480, 640)),
    "elin4 resident": ("sor_flow_elin4", "elin4", "resident", (480, 640)),
    "elin4 tiled": ("sor_flow_elin4", "elin4", "tiled", (1024, 1024)),
    "elin4 global": ("sor_flow_elin4", "elin4", "global", (2, 480, 640)),
    "llin8 resident": ("sor_flow_llin8", "llin8", "resident", (480, 640)),
    "llin8 tiled": ("sor_flow_llin8", "llin8", "tiled", (1024, 1024)),
    "llin8 global": ("sor_flow_llin8", "llin8", "global", (2, 480, 640)),
    "disp resident": ("sor_disp_llin4", "disp", "resident", (480, 640)),
    "disp tiled": ("sor_disp_llin4", "disp", "tiled", (1024, 1024)),
    "disp global": ("sor_disp_llin4", "disp", "global", (1, 9)),
    "disp pair resident": ("sor_disp_llin_sym4", "disp", "resident", (480, 640)),
    "disp pair tiled": ("sor_disp_llin_sym4", "disp", "tiled", (1024, 1024)),
    "disp pair global": ("sor_disp_llin_sym4", "disp", "global", (5000, 2)),
    "pde4 resident": ("sor_pde4", "pde4", "resident", (3, 480, 640)),
    "pde4 tiled": ("sor_pde4", "pde4", "tiled", (3, 1024, 1024)),
    "pde4 global": ("sor_pde4", "pde4", "global", (2, 5000)),
    "pde8 resident": ("sor_pde8", "pde8", "resident", (3, 480, 640)),
    "pde8 tiled": ("sor_pde8", "pde8", "tiled", (3, 1024, 1024)),
    "pde8 global": ("sor_pde8", "pde8", "global", (2, 5000)),
}


@pytest.mark.parametrize("case", list(COUNTED))
def test_a_card_call_counts_its_route(case, clean, stand_ins):
    """One call off the CPU counts 1 under ``sor.<route>.<family>.<H>x<W>``
    and runs the kernel of that route."""
    entry, family, route, shape = COUNTED[case]
    _call(entry, shape)
    h, w = shape[-2:]
    assert observe.record()["counters"] == {f"sor.{route}.{family}.{h}x{w}": 1}
    assert len(stand_ins) == 1 and stand_ins[0].startswith(f"{route}.")


def test_calls_add_up_under_their_shapes(clean, stand_ins):
    for _ in range(3):
        _call("sor_flow_llin4", (1080, 1920))
    _call("sor_flow_llin4", (810, 1440))
    _call("sor_flow_llin4", (435, 768))
    assert observe.record()["counters"] == {"sor.tiled.llin4.1080x1920": 3,
                                            "sor.tiled.llin4.810x1440": 1,
                                            "sor.resident.llin4.435x768": 1}


def test_a_capture_holds_the_routes_it_counted(clean, stand_ins):
    """What a captured frame counts is its record's ``counters``."""
    rec = observe.GraphRecord("stand-in")
    with observe.capture(rec, lambda: 0, lambda marks: [0] * len(marks)):
        _call("sor_flow_llin4", (1080, 1920))
        _call("sor_flow_llin4", (456, 810))
    assert rec.counters == {"sor.tiled.llin4.1080x1920": 1, "sor.resident.llin4.456x810": 1}


# --- the plain path counts nothing --------------------------------------


def _cpu_fields(rng, n, hw):
    return [torch.from_numpy((rng.random(hw) + 0.5).astype(np.float32)) for _ in range(n)]


def test_cpu_calls_count_no_route(clean):
    rng = np.random.default_rng(24)
    hw = (13, 17)
    dispatch.sor_flow_llin4(*_cpu_fields(rng, 13, hw), 4, 1.9)
    dispatch.sor_flow_elin4(*_cpu_fields(rng, 11, hw), 4, 1.9)
    dispatch.sor_flow_llin8(*_cpu_fields(rng, 17, hw), 4, 1.9)
    dispatch.sor_disp_llin4(*_cpu_fields(rng, 8, hw), 4, 1.9)
    dispatch.sor_disp_llin_sym4(*_cpu_fields(rng, 16, hw), 4, 1.9)
    dispatch.sor_pde4(*_cpu_fields(rng, 7, hw), 4, 1.9)
    dispatch.sor_pde8(*_cpu_fields(rng, 11, hw), 4, 1.9)
    assert observe.record()["counters"] == {}


def test_plain_solvers_count_no_route(clean, stand_ins):
    """Inside ``plain_solvers()`` a tensor off the CPU runs the plain
    version and counts nothing; outside, the same call counts its route."""
    with plain_solvers():
        _call("sor_flow_llin4", (96, 128))
        _call("sor_disp_llin4", (96, 128))
    assert observe.record()["counters"] == {} and stand_ins == []
    _call("sor_flow_llin4", (96, 128))
    assert observe.record()["counters"] == {"sor.resident.llin4.96x128": 1}


def test_a_cpu_frame_counts_no_route(clean):
    rng = np.random.default_rng(25)
    a = (rng.random((3, 40, 56)) * 255).astype(np.float32)
    b = np.roll(a, 1, axis=-1)
    tflow.flow_nd(a, b, params=tflow.FlowNDParams(firstLoop=2, secondLoop=2), device="cpu")
    assert _sor_counts(observe.record()["counters"]) == {}
    assert observe.record()["counters"]["reweight.plain"] > 0


# --- the plain tile schedule at the full-HD plan ------------------------


LLIN = tiled_cuda.FIELD_NAMES["flow_llin4"]


def _llin_fields(rng, hw, nan: bool):
    """Unit-scale llin4 fields in the tile engine's order, 5% NaN in the
    data terms where ``nan``."""
    out = []
    for n in LLIN:
        if n in ("duc", "dvc"):
            x = rng.random(hw) + 1.0
        elif n == "m":
            x = rng.random(hw) * 0.01
        elif n.startswith("w"):
            x = rng.random(hw) + 0.1
        else:
            x = rng.random(hw) * 0.2
        if nan and n in ("cu", "cv", "duc", "dvc"):
            x = np.where(rng.random(hw) < 0.05, np.nan, x)
        out.append(torch.from_numpy(x.astype(np.float32)))
    return out


def _equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        assert torch.equal(torch.nan_to_num(g, 0.0), torch.nan_to_num(w, 0.0))


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("level", range(3))
def test_plain_tile_schedule_at_the_fullhd_plan_equals_the_plain_sweep(level, nan):
    """The full-HD levels' plan (16x48 tiles, k = 4, its pairs a thread) on
    a tenth of each tiled level's size, ragged tiles at both edges."""
    h, w = FULLHD_TILED[level]
    plan = dispatch.sor_route("llin4", h, w, 1, 4, SMS)[1]
    small = (h // 10 + 1, w // 10)
    t = _llin_fields(np.random.default_rng(level), small, nan)
    prepare, sweep = sweeps.flow_llin4_sweep(1.9)
    got = tiled.tiled_relax(t, sweep, 2, 4, prepare_fn=prepare,
                            plan_override=(plan.k, (plan.tile_h, plan.tile_w), plan.slots))
    du, dv, u, v, *rest = t
    _equal(got, sor.sor_flow_llin4(u, v, du, dv, *rest, 4, 1.9))


# --- on the card --------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _graph.release_graphs()
    observe.reset()
    yield torch.device("cuda", 0)
    _graph.release_graphs()
    observe.reset()


def _pair(shape, seed):
    """A noise frame and its partner shifted by (1, 2) px, as the
    reweighting's card tests make them."""
    a = (np.random.default_rng(seed).random(shape) * 255).astype(np.float32)
    return a, np.roll(a, (1, 2), axis=(-2, -1))


def _gaps(got, want):
    """(mean, widest) |got - want| over the fields."""
    d = torch.cat([(g - w).abs().reshape(-1) for g, w in zip(got, want)])
    return float(d.mean()), float(d.max())


@pytest.mark.card
def test_the_fullhd_frame_takes_48_tiled_and_208_resident_calls(card):
    """The captured 3x1080x1920 frame counts 16 tiled llin4 calls at each
    of its three finest levels, 16 resident ones at each of the other 13,
    and 256 robust + 256 weights kernels; it equals the eager frame bit for
    bit (the same kernels), and the all-plain frame within the llin4
    kernels' rounding: their products and sums are left to the compiler's
    fma contraction, so a solve moves by ~1e-6 px, which the frame's warps
    and medians carry to a few pixels. On this scene the frame reads
    2.09e-3 px widest and 9.0e-7 mean from the all-plain one (NVIDIA H100
    80GB HBM3), so the bounds are twice the widest gap and the cell's mean
    limit."""
    a, b = _pair((3, 1080, 1920), 24)
    got = tflow.flow_nd_fused(a, b)
    (rec,) = observe.record()["graphs"]
    counters = rec["counters"]
    tiled_counts = _sor_counts(counters, "tiled")
    assert tiled_counts == {f"sor.tiled.llin4.{h}x{w}": 16 for h, w in FULLHD_TILED}
    resident = _sor_counts(counters, "resident")
    levels = [tuple(s) for s in pyramid_scales(1080, 1920, 0.75, 20)]
    assert resident == {f"sor.resident.llin4.{h}x{w}": 16 for h, w in levels[3:]}
    assert sum(resident.values()) == 208
    assert set(counters) == set(tiled_counts) | set(resident) | {"reweight.kernel"}
    assert counters["reweight.kernel"] == 512
    eager = tflow.flow_nd(a, b)
    assert all(torch.equal(g, e) for g, e in zip(got, eager))
    with plain_solvers():
        plain = tflow.flow_nd(a, b)
    mean, widest = _gaps(got, plain)
    print(f"full-HD frame against the all-plain frame: mean {mean:.3g} px, widest {widest:.3g}")
    assert mean <= 8e-6 and widest <= 4.2e-3, (mean, widest)


@pytest.mark.card
@pytest.mark.parametrize("cell", ["flow_nd.sintel", "disparity_nd.kitti"])
def test_the_other_cells_frames_take_no_tiled_call(card, cell):
    (h, w), family, _ = CELL_PYRAMIDS[cell]
    fused = tflow.flow_nd_fused if family == "llin4" else tdisp.disparity_nd_fused
    fused(*_pair((3, h, w), 25))
    (rec,) = observe.record()["graphs"]
    assert _sor_counts(rec["counters"], "tiled") == {}
    calls = {"llin4": 16 * 12, "disp": 24 * 15}[family]
    assert sum(_sor_counts(rec["counters"]).values()) == calls
    assert sum(_sor_counts(rec["counters"], "resident").values()) == calls
