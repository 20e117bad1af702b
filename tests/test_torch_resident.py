"""The resident SOR kernel's host side (``pde_tpu_torch/kernels/resident_cuda.py``
and its routing in ``kernels/dispatch.py``) for its four families, llin4,
disp llin4, pde4 and elin4 (``csrc/resident_sor.cu``): the launch plan, the
map of threads to pixels, the rule by which the kernel reads its neighbours
(pde4 and elin4, written in torch ops and held bit for bit against the
plain solvers), the choice between the resident and the global kernels
from the shape, and the rules that hold without a card. The plain version
of every family is ``solvers/sor.py``'s, held against ``pde_tpu`` here
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
from pde_tpu_torch.kernels import (build, dispatch, interior_cuda, resident_cuda, sor_cuda, tiled,
                                   tiled_cuda)
from pde_tpu_torch.solvers import sor

torch.set_num_threads(1)

LLIN4 = resident_cuda.LLIN4_NAMES
ELIN4 = resident_cuda.ELIN4_NAMES
DISP = resident_cuda.DISP_NAMES
PDE4 = resident_cuda.PDE4_NAMES
W4 = ("ww", "wn", "we", "ws")
# the pyramids at 3x480x640: flow_nd and flow_hs stop at 20 px, the stereo
# models at 10; tv_denoise4's partial one at half the image
FLOW_LEVELS = pyramid_scales(480, 640, 0.75, 20)
STEREO_LEVELS = pyramid_scales(480, 640, 0.75, 10)
TV4_LEVELS = [(480, 640), (360, 480), (270, 360), (203, 270)]
# the plan of every level (PERF.md, rows 1 and 5): (scope, blocks per batch entry),
# finest level first
FLOW_PLANS = [("grid", 120), ("grid", 90), ("grid", 54), ("grid", 68), ("grid", 31),
              ("grid", 20), ("cluster", 11), ("cluster", 6), ("cluster", 4)] + [("block", 1)] * 4
DISP_PLANS = [("grid", 120), ("grid", 90), ("grid", 54), ("grid", 68), ("grid", 31),
              ("grid", 23), ("cluster", 11), ("cluster", 6), ("cluster", 4)] + [("block", 1)] * 6
SYM_PLANS = [("grid", 54), ("grid", 60), ("grid", 54), ("grid", 29)] + DISP_PLANS[4:]
PDE4_PLANS = [("grid", 120), ("grid", 120), ("grid", 90), ("grid", 68)]  # C = 1 and 3
# registers a pixel keeps, the reckoning a plan is held to: llin4 ten
# coefficient floats, half a position word and its flag bits, with room;
# elin4 nine floats and the same; disp seven floats and the same; pde4 four
# weights and two floats a channel, and the same (the compiler's counts a
# thread are in PERF.md: none spills)
REGS_PER_PX = {"llin4": 12, "elin4": 11, "disp": 9, "pde4": lambda c: 6 + 2 * c}
REGS_PER_SM = 65536
# odd shapes, the pyramids' levels and a few large ones
PLAN_SHAPES = sorted(set(STEREO_LEVELS) | {(3, 3), (3, 1000), (1000, 3), (37, 53), (481, 641),
                                           (1024, 1024)})


def _fields(rng, names, shape, nan=True):
    out = []
    for n in names:
        if n in ("duc", "dvc"):
            x = rng.random(shape) + 1.0
        elif n == "trace":  # above the weights' sum, as tv_denoise4's
            x = rng.random(shape) + 4.5
        elif n == "m":
            x = rng.random(shape) * 0.01
        elif n.startswith("w"):
            x = rng.random(shape) + 0.1
        else:
            x = rng.random(shape) * 0.2
        if nan and n in ("cu", "duc", "trace"):
            x = np.where(rng.random(shape) < 0.05, np.nan, x)
        out.append(x.astype(np.float32))
    return out


def _t(fields):
    return [torch.from_numpy(f) for f in fields]


def _no_build(name):
    raise AssertionError("nothing may be built here")


def _regs(family, batch):
    regs = REGS_PER_PX[family]
    return regs(batch) if callable(regs) else regs


@pytest.mark.parametrize("family,batch", [("llin4", 1), ("disp", 1), ("disp", 2), ("pde4", 1),
                                          ("pde4", 3), ("elin4", 1)])
def test_plan_covers_every_pixel_once_within_budgets(family, batch):
    hws = 0
    for h, w in PLAN_SHAPES + TV4_LEVELS:
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
        assert plan.smem_bytes == resident_cuda.smem_bytes(family, plan.rows, w, batch)
        assert plan.smem_bytes <= resident_cuda.MAX_SMEM
        # registers at the reckoned count a pixel, within an SM's
        assert plan.threads * plan.pixels_per_thread * _regs(family, batch) <= REGS_PER_SM
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= resident_cuda.MAX_THREADS
        assert plan.slots in resident_cuda.SLOTS[family]
        # pde4's coefficients spill past 6 - C slots (the kernel has none)
        assert family != "pde4" or plan.slots <= resident_cuda.PDE4_MAX_SLOTS - batch
        assert plan.rows * ((w + 1) // 2) <= plan.threads * plan.slots
        # the bands: one a block, two rows at least, for disp and pde4 the
        # last too
        assert plan.blocks == -(-h // plan.rows)
        if plan.blocks > 1:
            assert plan.rows >= 2
            assert family in ("llin4", "elin4") or h - (plan.blocks - 1) * plan.rows >= 2
        assert (plan.scope == "block") == (plan.blocks == 1)
        if plan.scope == "cluster":
            assert plan.blocks <= resident_cuda.MAX_CLUSTER
        if plan.scope == "grid":
            # pde4's channels share the thread that owns a pixel
            assert plan.blocks * (batch if family == "disp" else 1) <= resident_cuda.SM_COUNT
    assert hws >= len(STEREO_LEVELS)


@pytest.mark.parametrize("family,batch,levels,want", [
    ("llin4", 1, FLOW_LEVELS, FLOW_PLANS),
    ("disp", 1, STEREO_LEVELS, DISP_PLANS),
    ("disp", 2, STEREO_LEVELS, SYM_PLANS),
    ("pde4", 1, TV4_LEVELS, PDE4_PLANS),
    ("pde4", 3, TV4_LEVELS, PDE4_PLANS),
    ("elin4", 1, FLOW_LEVELS, FLOW_PLANS),
])
def test_pyramid_levels_get_the_documented_plan(family, batch, levels, want):
    """flow_nd (llin4), disparity_nd (disp, B = 1), disparity_sym (disp,
    B = 2), tv_denoise4 (pde4, C = 1 and 3) and flow_hs with solver=1 (elin4)
    at 3x480x640: every level one launch, with the scope and bands PERF.md
    gives."""
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
    assert resident_cuda.plan_resident(2, 9, "pde4") is None  # no interior
    assert resident_cuda.plan_resident(9, 2, "pde4", 3) is None
    assert resident_cuda.plan_resident(37, 53, "pde4", 4) is None  # channels
    assert resident_cuda.plan_resident(37, 53, "elin4", 2) is None
    # 1024x1024: eight slots a thread at 512 threads (pde4 C = 3 and elin4 too)
    for family, batch in (("pde4", 1), ("pde4", 3), ("elin4", 1)):
        assert resident_cuda.plan_resident(1024, 1024, family, batch) is None
    assert resident_cuda.plan_resident(1, 1, "elin4").scope == "block"
    with pytest.raises(ValueError, match="family"):
        resident_cuda.plan_resident(9, 9, "pde2")


def test_default_plan_is_the_cheapest_of_the_candidates():
    """llin4, disp and elin4: slots a thread plus the barrier's cost; pde4
    as pde8: slots times warps a scheduler, and no plan of any band count
    costs less."""
    def cost(p, family):
        if family == "pde4":
            return (p.slots * p.threads / 128 + resident_cuda.SCOPE_COST8[p.scope],
                    resident_cuda.SCOPES.index(p.scope), p.blocks)
        return (p.slots + resident_cuda.SCOPE_COST[p.scope], resident_cuda.SCOPES.index(p.scope),
                p.blocks)

    for family, batch, levels in (("llin4", 1, FLOW_LEVELS), ("disp", 2, STEREO_LEVELS),
                                  ("pde4", 1, TV4_LEVELS), ("pde4", 3, TV4_LEVELS),
                                  ("elin4", 1, FLOW_LEVELS)):
        for h, w in levels:
            plans = resident_cuda.plans_resident(h, w, family, batch)
            best = resident_cuda.plan_resident(h, w, family, batch)
            assert best in plans and all(cost(best, family) <= cost(p, family) for p in plans)
            if family == "pde4":
                for n in range(1, h + 1):
                    p = resident_cuda.plan_with_bands(h, w, family, batch, n)
                    assert p is None or cost(best, family)[0] <= cost(p, family)[0]


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


def _pde4_fields(rng, shape, shared=(), nan=True):
    """pde4 fields as tv_denoise4 hands them over: X of ``shape``, TRACE and
    B of it too unless named in ``shared`` (then one (H, W) plane), the four
    weights (H, W) planes."""
    plane = shape[-2:]
    f = _fields(rng, ("x",), shape, nan)
    f += [_fields(rng, (n,), plane if n in shared else shape, nan)[0] for n in ("trace", "b")]
    return f + _fields(rng, W4, plane, nan)


@pytest.mark.parametrize("system", ["llin4", "disp", "sym", "pde4", "elin4"])
def test_dispatch_cpu_is_plain_and_builds_nothing(rng, monkeypatch, system):
    """CPU tensors take the plain solver, launch nothing and build nothing;
    at a pyramid level's shape the result is also pde_tpu's (pde4 as
    tv_denoise4 calls it: (C, H, W) X, TRACE and B, (H, W) weights)."""
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
    elif system == "sym":
        f = _fields(rng, DISP, (h, w)) + _fields(rng, DISP, (h, w))
        got = dispatch.sor_disp_llin_sym4(*_t(f), 4, 1.9)
        want = jsor.sor_disp_llin_sym4(*(jnp.asarray(x) for x in f), 4, 1.9)
        plain = sor.sor_disp_llin_sym4(*_t(f), 4, 1.9)
    elif system == "pde4":
        f = _pde4_fields(rng, (3, h, w))
        got = (dispatch.sor_pde4(*_t(f), 5, 1.75),)
        want = (jsor.sor_pde4(*(jnp.asarray(x) for x in f), 5, 1.75),)
        plain = (sor.sor_pde4(*_t(f), 5, 1.75),)
    else:
        f = _fields(rng, ELIN4, (h, w))
        got = dispatch.sor_flow_elin4(*_t(f), 20, 1.9)
        want = jsor.sor_flow_elin4(*(jnp.asarray(x) for x in f), 20, 1.9)
        plain = sor.sor_flow_elin4(*_t(f), 20, 1.9)
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
    monkeypatch.setattr(resident_cuda, "pde4_sor", recorder("resident pde4", 1))
    monkeypatch.setattr(resident_cuda, "flow_elin4_sor", recorder("resident elin4", 2))
    monkeypatch.setattr(sor_cuda, "flow_llin4_sor", recorder("global llin4", 2))
    monkeypatch.setattr(interior_cuda, "disp_llin4_sor", recorder("global disp", 1))
    monkeypatch.setattr(interior_cuda, "pde4_sor", recorder("global pde4", 1))
    monkeypatch.setattr(sor_cuda, "flow_elin4_sor", recorder("global elin4", 2))

    def tile_recorder(family, fields, iters, omega, k, tile_h, tile_w, double_buffer=False,
                      slots=None):
        name = {"disp_llin4": "disp"}.get(family, family.removeprefix("flow_"))
        calls.append((f"tile {name}", (k, tile_h, tile_w, slots), fields))
        return torch.zeros((2, 1)), torch.zeros((2, 1))

    monkeypatch.setattr(tiled_cuda, "tiled_sor", tile_recorder)
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


@pytest.mark.parametrize("h,w", TV4_LEVELS + [FLOW_LEVELS[6], FLOW_LEVELS[-1]])
def test_dispatch_picks_resident_pde4_and_elin4_from_the_shape(card_routes, h, w):
    """tv_denoise4's call (C = 3 over shared weights), a gray one and a
    shared TRACE/B, and flow_hs's elin4 call: one resident launch each, with
    the default plan."""
    x, xc = torch.zeros((h, w)), torch.zeros((3, h, w))
    dispatch.sor_pde4(xc, xc, xc, *([x] * 4), 5, 1.75)
    dispatch.sor_pde4(*([x] * 7), 5, 1.75)
    dispatch.sor_pde4(xc, x, x, *([x] * 4), 5, 1.75)
    dispatch.sor_flow_elin4(*([x] * 11), 20, 1.9)
    assert [c[0] for c in card_routes] == ["resident pde4"] * 3 + ["resident elin4"]
    assert [c[1] for c in card_routes] == [resident_cuda.plan_resident(h, w, "pde4", 3),
                                           resident_cuda.plan_resident(h, w, "pde4", 1),
                                           resident_cuda.plan_resident(h, w, "pde4", 3),
                                           resident_cuda.plan_resident(h, w, "elin4", 1)]


def test_dispatch_sends_pde4_and_elin4_without_a_plan_to_the_global_kernels(card_routes):
    """pde4 that no kernel of a plan takes (no interior, more channels or
    weights per channel), and elin4 of a shape that is not (H, W), go to
    the global kernels. An elin4 or pde4 (H, W) without a resident plan
    (1024x1024) now goes to the tile kernel instead, the route that
    tests/test_torch_tiled.py holds for every such shape."""
    big = torch.zeros((1024, 1024))
    dispatch.sor_pde4(*([big] * 7), 5, 1.75)                                 # eight slots: tile
    dispatch.sor_pde4(*([torch.zeros((2, 9))] * 7), 5, 1.75)                # no interior
    x4, x = torch.zeros((4, 9, 9)), torch.zeros((9, 9))
    dispatch.sor_pde4(x4, x4, x4, *([x] * 4), 5, 1.75)                      # 4 channels
    x3 = torch.zeros((3, 9, 9))
    dispatch.sor_pde4(*([x3] * 7), 5, 1.75)                                 # weights per channel
    dispatch.sor_pde4(torch.zeros((2, 3, 9, 9)), *([x] * 6), 5, 1.75)       # (B, C, H, W)
    # eight slots: no resident plan, so the tile kernel (since the tile
    # kernel's redesign every llin4 and elin4 shape without one takes it)
    dispatch.sor_flow_elin4(*([big] * 11), 20, 1.9)
    dispatch.sor_flow_elin4(*([torch.zeros((2, 5, 5))] * 11), 20, 1.9)     # not (H, W)
    assert [c[0] for c in card_routes] == (["tile pde4"] + ["global pde4"] * 4
                                           + ["tile elin4", "global elin4"])
    assert all(c[1] is None for c in card_routes if c[0].startswith("global"))
    plan = tiled.plan_tiles(1024, 1024, "pde4", 5, 4, sm_count=resident_cuda.SM_COUNT)
    assert card_routes[0][1] == (4, plan.tile_h, plan.tile_w, plan.slots)
    plan = tiled.plan_tiles(1024, 1024, "flow_elin4", 20, 4, sm_count=resident_cuda.SM_COUNT)
    assert card_routes[5][1] == (4, plan.tile_h, plan.tile_w, plan.slots)


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
    with pytest.raises(ValueError, match="CUDA"):
        resident_cuda.pde4_sor(*_t(_pde4_fields(rng, (3, 8, 9))), 5, 1.75)
    with pytest.raises(ValueError, match="CUDA"):
        resident_cuda.flow_elin4_sor(*_t(_fields(rng, ELIN4, (8, 9))), 20, 1.9)
    assert resident_cuda.LAUNCHES == before


def test_library_name_follows_source_and_headers():
    path = build.library_path(resident_cuda.SOURCE)
    assert path.parent == build.BUILD_DIR and path.name.startswith("libresident_sor_")
    headers = [f.name for f in build._with_headers(build.CSRC / "resident_sor.cu")]
    assert headers == ["resident_sor.cu", "disp_update.cuh", "flow_update.cuh",
                       "pde4_update.cuh", "resident_scope.cuh"]
    # the global kernels round with the same headers
    interior = [f.name for f in build._with_headers(build.CSRC / "interior_sor.cu")]
    assert "disp_update.cuh" in interior and "pde4_update.cuh" in interior
    assert "flow_update.cuh" in [f.name for f in build._with_headers(build.CSRC /
                                                                     "flow_llin4_sor.cu")]


# ---- the read rule of pde4 and elin4 ----------------------------------------

class _Bands:
    """The kernel's storage of the relaxed fields (..., H, W) under a plan
    of ``rows`` rows a band: each band's own pixels, and the first and last
    rows of every band, which the neighbouring bands read (the output on the
    grid, the owner's shared memory in a cluster). What no band stores for
    the others is NaN, so a read across bands of anything but an edge row
    shows."""

    def __init__(self, fields, rows):
        h = fields[0].shape[-2]
        ii = torch.arange(h)
        self.band = ii // rows
        self.edge_row = (ii == self.band * rows) | (ii == torch.clamp((self.band + 1) * rows,
                                                                       max=h) - 1)
        self.own = [f.clone() for f in fields]
        self.edge = [torch.where(self.edge_row[:, None], f, float("nan")) for f in fields]

    def read(self, f, i, ni, nj):
        """Field ``f`` at (ni, nj) as the pixels of rows ``i`` read it."""
        same = self.band[ni] == self.band[i]
        return torch.where(same, self.own[f][..., ni, nj], self.edge[f][..., ni, nj])

    def write(self, f, i, j, value):
        self.own[f][..., i, j] = value
        on_edge = self.edge_row[i]
        self.edge[f][..., i[on_edge], j[on_edge]] = value[..., on_edge]


def _colour_slots(plan, h, w, c):
    """The pixels of colour c that the kernel's threads own under ``plan``,
    in the order of ``slot_pixels``."""
    px = resident_cuda.slot_pixels(plan, h, w)
    px = px[(px[:, 0] + px[:, 1]) % 2 == c]
    return px[:, 0], px[:, 1]


def read_rule_pde4(x, trace, b, weights, iters, omega, plan, shortcut=True):
    """``sor_pde4`` computed as the resident kernel reads its fields: each
    colour phase over the pixels the plan's threads own, the neighbours in
    other bands from the band-edge rows, every channel by the same reads,
    and the border by the shortcut: in sweep 0 a border neighbour is the
    input's border, from sweep 1 on the pixel's own value of that channel;
    the border filled once, from the band, at the end. Without
    ``shortcut`` a border neighbour stays the input's in every sweep."""
    h, w = x.shape[-2:]
    ww, wn, we, ws = weights
    wsum = sor._weight_sum(weights)
    tr_nan = torch.isnan(trace)
    inv = torch.where(tr_nan, 1.0 / wsum, 1.0 / torch.nan_to_num(trace, nan=1.0)).expand_as(x)
    b_eff = torch.where(tr_nan, 0.0, b).expand_as(x)
    st = _Bands((x,), plan.rows)
    for it in range(iters):
        for c in (0, 1):
            i, j = _colour_slots(plan, h, w, c)
            inner = (i >= 1) & (i <= h - 2) & (j >= 1) & (j <= w - 2)
            i, j = i[inner], j[inner]
            xc = st.read(0, i, i, j)
            filled = it > 0 and shortcut

            def nbr(ni, nj, border):
                return torch.where(border & filled, xc, st.read(0, i, ni, nj))

            total = nbr(i, j - 1, j == 1) * ww[i, j]
            total = total + nbr(i, j + 1, j == w - 2) * we[i, j]
            total = total + nbr(i - 1, j, i == 1) * wn[i, j]
            total = total + nbr(i + 1, j, i == h - 2) * ws[i, j]
            new = (b_eff[..., i, j] + total) * inv[..., i, j]
            st.write(0, i, j, (1.0 - omega) * xc + omega * new)
    out = st.own[0]
    if iters > 0:
        out = out[..., torch.arange(h).clamp(1, h - 2), :][..., torch.arange(w).clamp(1, w - 2)]
    return out


def read_rule_elin4(u, v, m, cu, cv, duc, dvc, weights, iters, omega, plan):
    """``sor_flow_elin4`` computed as the resident kernel reads its fields:
    each colour phase over the pixels the plan's threads own, every pixel
    relaxed, a neighbour off the image clamped to the pixel itself (its
    weight is zero), the neighbours in other bands from the band-edge rows,
    U first and V from the refreshed U."""
    h, w = u.shape
    co = sor.flow_coefficients(m, cu, cv, duc, dvc, sor._edge_zeroed(*weights))
    ww, wn, we, ws = co.weights
    st = _Bands((u, v), plan.rows)
    for _ in range(iters):
        for c in (0, 1):
            i, j = _colour_slots(plan, h, w, c)
            nbrs = ((i, (j - 1).clamp(min=0), ww), (i, (j + 1).clamp(max=w - 1), we),
                    ((i - 1).clamp(min=0), j, wn), ((i + 1).clamp(max=h - 1), j, ws))

            def diffusion(f):
                total = None
                for ni, nj, wt in nbrs:
                    term = st.read(f, i, ni, nj) * wt[i, j]
                    total = term if total is None else total + term
                return total

            fu, fv = st.read(0, i, i, j), st.read(1, i, i, j)
            su, sv = diffusion(0), diffusion(1)
            num_u = torch.where(co.cu_nan[i, j], su, su + co.cu0[i, j] - co.m0[i, j] * fv)
            new_u = (1.0 - omega) * fu + omega * num_u * co.inv_u[i, j]
            num_v = torch.where(co.cv_nan[i, j], sv, sv + co.cv0[i, j] - co.m0[i, j] * new_u)
            new_v = (1.0 - omega) * fv + omega * num_v * co.inv_v[i, j]
            st.write(0, i, j, new_u)
            st.write(1, i, j, new_v)
    return st.own[0], st.own[1]


def _bit_equal(a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _band_plans(family, h, w, batch):
    """One plan for each band count the kernel takes at (h, w), a few."""
    plans = {resident_cuda.plan_with_bands(h, w, family, batch, n) for n in (1, 2, 3, 5, h)}
    return [p for p in plans if p is not None]


READ_SHAPES = [(3, 3), (3, 8), (7, 3), (9, 12), (10, 13), (13, 17)]


@pytest.mark.parametrize("h,w", READ_SHAPES)
@pytest.mark.parametrize("channels,shared", [(1, ()), (3, ()), (3, ("trace", "b")), (3, ("b",))])
def test_pde4_read_rule_is_the_plain_solver_bit_for_bit(rng, h, w, channels, shared):
    """C = 1 and 3 over shared weights, TRACE and B per channel or shared,
    5% NaN in TRACE: each channel's border neighbour is that channel's own
    value from the second sweep on."""
    shape = (h, w) if channels == 1 else (channels, h, w)
    f = _t(_pde4_fields(rng, shape, shared))
    for iters in (0, 1, 2, 5):
        want = sor.sor_pde4(*f, iters, 1.75)
        for plan in _band_plans("pde4", h, w, channels):
            got = read_rule_pde4(f[0], f[1], f[2], f[3:], iters, 1.75, plan)
            assert _bit_equal(got, want), (plan, iters)


@pytest.mark.parametrize("h,w", READ_SHAPES + [(1, 1), (1, 9), (9, 1), (2, 5)])
def test_elin4_read_rule_is_the_plain_solver_bit_for_bit(rng, h, w):
    """5% NaN in Cu and Du; every pixel relaxed, the edges one-sided."""
    f = _t(_fields(rng, ELIN4, (h, w)))
    for iters in (0, 1, 4, 20):
        want = sor.sor_flow_elin4(*f, iters, 1.9)
        for plan in _band_plans("elin4", h, w, 1):
            got = read_rule_elin4(*f[:7], f[7:], iters, 1.9, plan)
            assert _bit_equal(got[0], want[0]) and _bit_equal(got[1], want[1]), (plan, iters)


def test_pde4_border_shortcut_matters(rng):
    """Reading the border neighbours' input in every sweep instead gives
    other floats from sweep 1 on: the shortcut stands for the plain
    version's fill after each sweep. After one sweep the two agree."""
    f = _t(_pde4_fields(rng, (3, 10, 13), nan=False))
    plan = resident_cuda.plan_resident(10, 13, "pde4", 3)
    args = (f[0], f[1], f[2], f[3:])
    assert not _bit_equal(read_rule_pde4(*args, 3, 1.75, plan, shortcut=False),
                          sor.sor_pde4(*f, 3, 1.75))
    assert _bit_equal(read_rule_pde4(*args, 1, 1.75, plan, shortcut=False),
                      sor.sor_pde4(*f, 1, 1.75))
