"""The resident SOR kernel's host side (``pde_tpu_torch/kernels/resident_cuda.py``
and its routing in ``kernels/dispatch.py``): the launch plan, the map of
threads to pixels, the choice between the resident and the global kernels
from the shape, and the rules that hold without a card. The plain version
of both families is ``solvers/sor.py``'s, held against ``pde_tpu`` here
through the dispatch at a pyramid level's shape.

The kernel itself runs only on the card: ``chip_smoke.py`` holds it against
the global kernels (bit for bit) and the plain version there.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pde_tpu.solvers import sor as jsor
from pde_tpu_torch.core.grid import replicate_border
from pde_tpu_torch.core.pyramid import pyramid_scales
from pde_tpu_torch.kernels import build, dispatch, interior_cuda, resident_cuda, sor_cuda
from pde_tpu_torch.solvers import sor

torch.set_num_threads(1)

LLIN4 = resident_cuda.LLIN4_NAMES
DISP = resident_cuda.DISP_NAMES
# the pyramids at 3x480x640: flow_nd stops at 20 px, the stereo models at 10
FLOW_LEVELS = pyramid_scales(480, 640, 0.75, 20)
STEREO_LEVELS = pyramid_scales(480, 640, 0.75, 10)
# the plan of every level (PERF.md, rows 1 and 5): (scope, blocks per batch entry),
# finest level first
FLOW_PLANS = [("grid", 120), ("grid", 90), ("grid", 54), ("grid", 68), ("grid", 31),
              ("grid", 20), ("cluster", 11), ("cluster", 6), ("cluster", 4)] + [("block", 1)] * 4
DISP_PLANS = [("grid", 120), ("grid", 90), ("grid", 54), ("grid", 68), ("grid", 31),
              ("grid", 23), ("cluster", 11), ("cluster", 6), ("cluster", 4)] + [("block", 1)] * 6
SYM_PLANS = [("grid", 54), ("grid", 60), ("grid", 54), ("grid", 29)] + DISP_PLANS[4:]
# registers a pixel keeps, the reckoning a plan is held to: llin4 ten
# coefficient floats, half a position word and its flag bits, with room;
# disp seven floats and the same (the compiler's counts a thread are in
# PERF.md: none spills)
REGS_PER_PX = {"llin4": 12, "disp": 9}
REGS_PER_SM = 65536
# odd shapes, the pyramids' levels and a few large ones
PLAN_SHAPES = sorted(set(STEREO_LEVELS) | {(3, 3), (3, 1000), (1000, 3), (37, 53), (481, 641),
                                           (1024, 1024)})


def _fields(rng, names, shape, nan=True):
    out = []
    for n in names:
        if n in ("duc", "dvc"):
            x = rng.random(shape) + 1.0
        elif n == "m":
            x = rng.random(shape) * 0.01
        elif n.startswith("w"):
            x = rng.random(shape) + 0.1
        else:
            x = rng.random(shape) * 0.2
        if nan and n in ("cu", "duc"):
            x = np.where(rng.random(shape) < 0.05, np.nan, x)
        out.append(x.astype(np.float32))
    return out


def _t(fields):
    return [torch.from_numpy(f) for f in fields]


def _no_build(name):
    raise AssertionError("nothing may be built here")


@pytest.mark.parametrize("family,batch", [("llin4", 1), ("disp", 1), ("disp", 2)])
def test_plan_covers_every_pixel_once_within_budgets(family, batch):
    hws = 0
    for h, w in PLAN_SHAPES:
        plan = resident_cuda.plan_resident(h, w, family, batch)
        if plan is None:
            continue
        hws += 1
        px = resident_cuda.slot_pixels(plan, h, w)
        count = torch.zeros((h, w), dtype=torch.int64)
        count.index_put_((px[:, 0], px[:, 1]), torch.ones(len(px), dtype=torch.int64),
                         accumulate=True)
        assert bool((count == 1).all()), (h, w, plan)
        # shared memory, as the kernel counts it, within a block's
        assert plan.smem_bytes == resident_cuda.smem_bytes(family, plan.rows, w)
        assert plan.smem_bytes <= resident_cuda.MAX_SMEM
        # registers at the reckoned count a pixel, within an SM's
        assert plan.threads * plan.pixels_per_thread * REGS_PER_PX[family] <= REGS_PER_SM
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= resident_cuda.MAX_THREADS
        assert plan.slots in resident_cuda.SLOTS[family]
        assert plan.rows * ((w + 1) // 2) <= plan.threads * plan.slots
        # the bands: one a block, two rows at least, for disp the last too
        assert plan.blocks == -(-h // plan.rows)
        if plan.blocks > 1:
            assert plan.rows >= 2
            assert family == "llin4" or h - (plan.blocks - 1) * plan.rows >= 2
        assert (plan.scope == "block") == (plan.blocks == 1)
        if plan.scope == "cluster":
            assert plan.blocks <= resident_cuda.MAX_CLUSTER
        if plan.scope == "grid":
            assert plan.blocks * batch <= resident_cuda.SM_COUNT
    assert hws >= len(STEREO_LEVELS)


@pytest.mark.parametrize("family,batch,levels,want", [
    ("llin4", 1, FLOW_LEVELS, FLOW_PLANS),
    ("disp", 1, STEREO_LEVELS, DISP_PLANS),
    ("disp", 2, STEREO_LEVELS, SYM_PLANS),
])
def test_pyramid_levels_get_the_documented_plan(family, batch, levels, want):
    """flow_nd (llin4), disparity_nd (disp, B = 1) and disparity_sym (disp,
    B = 2) at 3x480x640: every level one launch, with the scope and bands
    PERF.md gives."""
    got = [resident_cuda.plan_resident(h, w, family, batch) for h, w in levels]
    assert all(p is not None for p in got)
    assert [(p.scope, p.blocks) for p in got] == want


def test_plan_refuses_what_the_kernel_does_not_take():
    assert resident_cuda.plan_resident(2, 9, "disp") is None  # no interior
    assert resident_cuda.plan_resident(9, 2, "disp") is None
    assert resident_cuda.plan_resident(37, 53, "disp", 3) is None  # batch
    assert resident_cuda.plan_resident(37, 53, "llin4", 2) is None
    # a level too large for one block, or for one band an SM
    assert resident_cuda.plan_with_bands(480, 640, "llin4", 1, 1) is None
    assert resident_cuda.plan_resident(480, 640, "llin4", 1, sm_count=60) is None
    assert resident_cuda.plan_resident(1024, 1024, "llin4") is None
    assert resident_cuda.plan_resident(1, 1, "llin4").scope == "block"
    with pytest.raises(ValueError, match="family"):
        resident_cuda.plan_resident(9, 9, "pde4")


def test_default_plan_is_the_cheapest_of_the_candidates():
    def cost(p):
        return (p.slots + resident_cuda.SCOPE_COST[p.scope], resident_cuda.SCOPES.index(p.scope),
                p.blocks)

    for family, batch, levels in (("llin4", 1, FLOW_LEVELS), ("disp", 2, STEREO_LEVELS)):
        for h, w in levels:
            plans = resident_cuda.plans_resident(h, w, family, batch)
            best = resident_cuda.plan_resident(h, w, family, batch)
            assert best in plans and all(cost(best) <= cost(p) for p in plans)


def test_border_shortcut_holds(rng):
    """What the kernel's disp border rests on: after the plain fill, a
    border neighbour of an interior pixel holds that pixel's own value, and
    every border pixel holds the value at (clamp(i, 1, H-2), clamp(j, 1,
    W-2))."""
    for h, w in ((3, 3), (3, 7), (8, 3), (10, 13)):
        y = replicate_border(torch.from_numpy(rng.random((2, h, w)).astype(np.float32)))
        inner = y[:, 1:-1, 1:-1]
        assert torch.equal(y[:, 0, 1:-1], inner[:, 0]) and torch.equal(y[:, -1, 1:-1], inner[:, -1])
        assert torch.equal(y[:, 1:-1, 0], inner[:, :, 0])
        assert torch.equal(y[:, 1:-1, -1], inner[:, :, -1])
        i = torch.arange(h).clamp(1, h - 2)
        j = torch.arange(w).clamp(1, w - 2)
        assert torch.equal(y, y[:, i][:, :, j])


@pytest.mark.parametrize("system", ["llin4", "disp", "sym"])
def test_dispatch_cpu_is_plain_and_builds_nothing(rng, monkeypatch, system):
    """CPU tensors take the plain solver, launch nothing and build nothing;
    at a pyramid level's shape the result is also pde_tpu's."""
    monkeypatch.setattr(build, "load", _no_build)
    counts = [dict(m.LAUNCHES) for m in (resident_cuda, sor_cuda, interior_cuda)]
    h, w = FLOW_LEVELS[-1]
    if system == "llin4":
        f = _fields(rng, LLIN4, (h, w))
        got = dispatch.sor_flow_llin4(*_t(f), 4, 1.9)
        want = jsor.sor_flow_llin4(*(jnp.asarray(x) for x in f), 4, 1.9)
        plain = sor.sor_flow_llin4(*_t(f), 4, 1.9)
    elif system == "disp":
        f = _fields(rng, DISP, (h, w))
        got = (dispatch.sor_disp_llin4(*_t(f), 4, 1.9),)
        want = (jsor.sor_disp_llin4(*(jnp.asarray(x) for x in f), 4, 1.9),)
        plain = (sor.sor_disp_llin4(*_t(f), 4, 1.9),)
    else:
        f = _fields(rng, DISP, (h, w)) + _fields(rng, DISP, (h, w))
        got = dispatch.sor_disp_llin_sym4(*_t(f), 4, 1.9)
        want = jsor.sor_disp_llin_sym4(*(jnp.asarray(x) for x in f), 4, 1.9)
        plain = sor.sor_disp_llin_sym4(*_t(f), 4, 1.9)
    for g, w_, p in zip(got, want, plain):
        assert torch.equal(g, p)
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=1e-5, rtol=0)
    assert [dict(m.LAUNCHES) for m in (resident_cuda, sor_cuda, interior_cuda)] == counts


@pytest.fixture
def card_routes(monkeypatch):
    """Dispatch as for CUDA tensors, with every kernel wrapper replaced by a
    recorder of (wrapper, plan, fields) and nothing built."""
    monkeypatch.setattr(build, "load", _no_build)
    monkeypatch.setattr(dispatch, "_plain", lambda x: False)
    monkeypatch.setattr(resident_cuda, "sm_count", lambda index: resident_cuda.SM_COUNT)
    calls = []

    def recorder(name, n_out):
        def run(*args, plan=None):
            calls.append((name, plan, args))
            out = tuple(torch.zeros((2, 1)) for _ in range(n_out))
            return out if n_out > 1 else out[0]
        return run

    monkeypatch.setattr(resident_cuda, "flow_llin4_sor", recorder("resident llin4", 2))
    monkeypatch.setattr(resident_cuda, "disp_llin4_sor", recorder("resident disp", 1))
    monkeypatch.setattr(resident_cuda, "disp_llin4_pair", recorder("resident pair", 2))
    monkeypatch.setattr(sor_cuda, "flow_llin4_sor", recorder("global llin4", 2))
    monkeypatch.setattr(interior_cuda, "disp_llin4_sor", recorder("global disp", 1))
    return calls


@pytest.mark.parametrize("h,w", [FLOW_LEVELS[0], FLOW_LEVELS[3], FLOW_LEVELS[-1]])
def test_dispatch_picks_the_resident_kernel_from_the_shape(card_routes, monkeypatch, h, w):
    x = torch.zeros((h, w))
    dispatch.sor_flow_llin4(*([x] * 13), 4, 1.9)
    dispatch.sor_disp_llin4(*([x] * 8), 4, 1.9)
    dispatch.sor_disp_llin4(*([torch.zeros((2, h, w))] * 8), 4, 1.9)

    def no_stack(*args, **kwargs):
        raise AssertionError("the resident pair must not stack its planes")

    pair = [torch.full((h, w), float(k)) for k in range(16)]
    with monkeypatch.context() as m:
        m.setattr(torch, "stack", no_stack)
        dispatch.sor_disp_llin_sym4(*pair, 4, 1.9)
    names = [c[0] for c in card_routes]
    assert names == ["resident llin4", "resident disp", "resident disp", "resident pair"]
    plans = [c[1] for c in card_routes]
    assert plans == [resident_cuda.plan_resident(h, w, "llin4"),
                     resident_cuda.plan_resident(h, w, "disp"),
                     resident_cuda.plan_resident(h, w, "disp", 2),
                     resident_cuda.plan_resident(h, w, "disp", 2)]
    # the pair's two systems keep their own planes, in order
    f0, f1 = card_routes[-1][2][:2]
    assert all(a is b for a, b in zip(f0 + f1, pair))


def test_dispatch_sends_shapes_without_a_plan_to_the_global_kernels(card_routes):
    x = torch.zeros((2, 9))
    dispatch.sor_disp_llin4(*([x] * 8), 4, 1.9)
    dispatch.sor_disp_llin4(*([torch.zeros((3, 9, 9))] * 8), 4, 1.9)  # batch of 3
    dispatch.sor_disp_llin_sym4(*([x] * 16), 4, 1.9)
    dispatch.sor_flow_llin4(*([torch.zeros((2, 5, 5))] * 13), 4, 1.9)  # not (H, W)
    assert [c[0] for c in card_routes] == ["global disp"] * 3 + ["global llin4"]
    assert all(c[1] is None for c in card_routes)


def test_resident_wrapper_rejects_cpu_tensors_before_building(rng, monkeypatch):
    monkeypatch.setattr(build, "load", _no_build)
    before = dict(resident_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        resident_cuda.flow_llin4_sor(*_t(_fields(rng, LLIN4, (8, 9))), 4, 1.9)
    with pytest.raises(ValueError, match="CUDA"):
        resident_cuda.disp_llin4_sor(*_t(_fields(rng, DISP, (8, 9))), 4, 1.9)
    with pytest.raises(ValueError, match="CUDA"):
        resident_cuda.disp_llin4_pair(_t(_fields(rng, DISP, (8, 9))),
                                      _t(_fields(rng, DISP, (8, 9))), 4, 1.9)
    assert resident_cuda.LAUNCHES == before


def test_library_name_follows_source_and_headers():
    path = build.library_path(resident_cuda.SOURCE)
    assert path.parent == build.BUILD_DIR and path.name.startswith("libresident_sor_")
    headers = [f.name for f in build._with_headers(build.CSRC / "resident_sor.cu")]
    assert headers == ["resident_sor.cu", "disp_update.cuh", "flow_update.cuh",
                       "resident_scope.cuh"]
    # the global disp kernel rounds with the same header
    assert "disp_update.cuh" in [f.name for f in build._with_headers(build.CSRC /
                                                                     "interior_sor.cu")]
