"""The tile engine (``pde_tpu_torch/kernels/tiled.py``): its plain tile
schedule held exactly against the port's plain global solvers and within
``tests/test_kernels.py``'s tolerance against ``pde_tpu``'s Pallas stripe
engine in interpret mode (serial and double-buffered), also at the tiles
of the redesigned kernel's plans and through windows; the tile plan (a
block an SM, the colour-split slot's bytes, threads); the dispatch's route
from the shape (``kernels/dispatch.sor_route``: resident, tile or global
kernel); the wrapper's refusals; and the build rule for headers.

The kernel (``csrc/tiled_sor.cu``) runs only on the card: ``chip_smoke.py``
holds it against the plain schedule there.
"""

import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pde_tpu.kernels import sweeps as jsweeps
from pde_tpu.kernels.tiled import tiled_relax as jtiled_relax
from pde_tpu_torch.kernels import build, dispatch, resident_cuda, sor_cuda, sweeps, tiled, tiled_cuda
from pde_tpu_torch.solvers import sor

torch.set_num_threads(1)

LLIN = ("du", "dv", "u", "v", "m", "cu", "cv", "duc", "dvc", "ww", "wn", "we", "ws")
ELIN = ("u", "v", "m", "cu", "cv", "duc", "dvc", "ww", "wn", "we", "ws")
FAMILIES = {"flow_llin4": (LLIN, sweeps.flow_llin4_sweep, jsweeps.flow_llin4_sweep),
            "flow_elin4": (ELIN, sweeps.flow_elin4_sweep, jsweeps.flow_elin4_sweep)}
NAN_ALL = ("cu", "cv", "duc", "dvc")


def _fields(rng, h, w, names, nan_names=()):
    """Unit-scale fields as tests/test_kernels.py makes them, 5% NaN in
    ``nan_names``; numpy float32, in the order of ``names``."""
    out = []
    for n in names:
        if n in ("duc", "dvc"):
            x = rng.random((h, w)) + 1.0
        elif n == "m":
            x = rng.random((h, w)) * 0.01
        elif n.startswith("w"):
            x = rng.random((h, w)) + 0.1
        else:
            x = rng.random((h, w)) * 0.2
        if n in nan_names:
            x = np.where(rng.random((h, w)) < 0.05, np.nan, x)
        out.append(x.astype(np.float32))
    return out


def _plain_global(family, t, iters):
    if family == "flow_llin4":
        du, dv, u, v, *rest = t
        return sor.sor_flow_llin4(u, v, du, dv, *rest, iters, 1.9)
    return sor.sor_flow_elin4(*t, iters, 1.9)


def _assert_equal(got, want):
    """Bit for bit, NaN where the other has NaN."""
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape
        assert torch.equal(torch.isnan(g), torch.isnan(w_))
        assert torch.equal(torch.where(torch.isnan(g), 0.0, g), torch.where(torch.isnan(w_), 0.0, w_))


# (h, w, iters, NaN fields, tiled_relax keywords)
EXACT_CASES = {
    "multi-tile, unaligned width, iters % k != 0": (48, 65, 5, (), dict(plan_override=(2, 16))),
    "rectangular tiles": (48, 65, 5, (), dict(plan_override=(2, (8, 24)))),
    "NaN data": (48, 65, 5, NAN_ALL, dict(plan_override=(2, 16))),
    "one tile, k = iters": (24, 30, 4, NAN_ALL, dict(plan_override=(4, (24, 32)))),
    "the plan's own tile, k_max = 3": (37, 53, 7, ("cu", "duc"), dict(k_max=3)),
    "1x9": (1, 9, 5, NAN_ALL, dict(plan_override=(2, 8))),
    "9x1": (9, 1, 5, NAN_ALL, dict(plan_override=(2, 8))),
    "1x1": (1, 1, 5, NAN_ALL, dict(plan_override=(2, 8))),
}


@pytest.mark.parametrize("case", sorted(EXACT_CASES))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_plain_tile_schedule_equals_plain_global_solver(rng, family, case):
    h, w, iters, nan_names, kw = EXACT_CASES[case]
    names, factory, _ = FAMILIES[family]
    t = [torch.from_numpy(x) for x in _fields(rng, h, w, names, nan_names)]
    prepare, sweep = factory(1.9)
    got = tiled.tiled_relax(t, sweep, 2, iters, prepare_fn=prepare, **kw)
    _assert_equal(got, _plain_global(family, t, iters))


@pytest.mark.parametrize("double_buffer", [False, True])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_tiled_relax_matches_pallas_stripe_engine(rng, family, double_buffer):
    """The shapes of tests/test_kernels.py's multi-stripe cases, NaN in Cu
    and Du; pde_tpu's kernel in interpret mode, 16-row stripes."""
    names, factory, jfactory = FAMILIES[family]
    f = _fields(rng, 48, 65, names, ("cu", "duc"))
    jprep, jsweep = jfactory(1.9)
    want = jtiled_relax(tuple(jnp.asarray(x) for x in f), jsweep, 2, 5, prepare_fn=jprep,
                        interpret=True, plan_override=(2, 16), double_buffer=double_buffer)
    prepare, sweep = factory(1.9)
    got = tiled.tiled_relax([torch.from_numpy(x) for x in f], sweep, 2, 5, prepare_fn=prepare,
                            plan_override=(2, 16), double_buffer=double_buffer)
    for g, w_ in zip(got, want):
        g = g.numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w_), atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("sweeps_", [3, 4096])
@pytest.mark.parametrize("double_buffer", [False, True])
@pytest.mark.parametrize("k_max", [1, 4, 8])
@pytest.mark.parametrize("h,w,n_fields", [(1024, 1024, 13), (480, 640, 13), (481, 641, 11)])
def test_plan_tiles(h, w, n_fields, k_max, double_buffer, sweeps_):
    plan = tiled.plan_tiles(h, w, n_fields, sweeps_, k_max, double_buffer=double_buffer)
    assert 1 <= plan.k <= min(k_max, sweeps_)
    assert tiled._halo_for(plan.k) == 2 * plan.k
    slot = tiled.slot_bytes(n_fields, plan.k, plan.tile_h, plan.tile_w)
    assert plan.smem_bytes == (2 if double_buffer else 1) * slot <= tiled.SMEM_PER_BLOCK
    # every pixel in exactly one tile
    cover = np.zeros((h, w), np.int32)
    origins = tiled.tile_origins(h, w, plan.tile_h, plan.tile_w)
    assert len(origins) == plan.n_tiles_h * plan.n_tiles_w
    for r0, c0 in origins:
        cover[r0:r0 + plan.tile_h, c0:c0 + plan.tile_w] += 1
    assert (cover == 1).all()


def test_plan_override_and_no_plan(rng, monkeypatch):
    seen = []

    def spy(fields, sweep_fn, prepare_fn, n_mut, iters, k, tile_h, tile_w):
        seen.append((k, tile_h, tile_w))
        return tuple(fields[:n_mut])

    monkeypatch.setattr(tiled, "plain_tiled_relax", spy)
    t = [torch.from_numpy(x) for x in _fields(rng, 20, 30, LLIN)]
    prepare, sweep = sweeps.flow_llin4_sweep(1.9)
    tiled.tiled_relax(t, sweep, 2, 5, prepare_fn=prepare, plan_override=(3, (8, 16)))
    tiled.tiled_relax(t, sweep, 2, 5, prepare_fn=prepare, plan_override=(2, 12))
    assert seen == [(3, 8, 16), (2, 12, 12)]
    assert tiled.plan_tiles(1024, 1024, 4000, 4) is None
    assert tiled.tiled_relax(t * 400, sweep, 2, 5, prepare_fn=prepare) is None


def _llin_cpu(rng, dtype=torch.float32, h=8, w=9):
    return [torch.from_numpy(x).to(dtype) for x in _fields(rng, h, w, LLIN)]


@pytest.mark.parametrize("what", ["cpu", "float64", "non-contiguous", "count"])
def test_wrapper_refuses_before_building(rng, monkeypatch, what):
    def no_build(*args, **kwargs):
        raise AssertionError("the wrapper must check its inputs before it builds")

    monkeypatch.setattr(build, "load", no_build)
    fields = _llin_cpu(rng, torch.float64 if what == "float64" else torch.float32)
    if what == "non-contiguous":
        fields[5] = torch.from_numpy(_fields(rng, 9, 8, ("cu",))[0]).t()
    if what == "count":
        fields = fields[:-1]
    match = {"cpu": "CUDA", "float64": "float32", "non-contiguous": "contiguous",
             "count": "takes 13 fields"}[what]
    before = dict(tiled_cuda.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        tiled_cuda.tiled_flow_sor("flow_llin4", fields, 4, 1.9, 2, 16, 16)
    assert tiled_cuda.LAUNCHES == before


def test_off_cpu_goes_to_the_kernel_or_raises(monkeypatch):
    """A tensor off the CPU never takes the plain schedule: a sweep the
    kernel has goes to the wrapper (which refuses a non-CUDA device), any
    other sweep raises."""
    monkeypatch.setattr(tiled, "plain_tiled_relax", None)
    meta = [torch.empty((16, 16), device="meta") for _ in LLIN]
    prepare, sweep = sweeps.flow_llin4_sweep(1.9)
    with pytest.raises(ValueError, match="CUDA"):
        tiled.tiled_relax(meta, sweep, 2, 4, prepare_fn=prepare)
    with pytest.raises(ValueError, match="tile kernel runs"):
        tiled.tiled_relax(meta, sweep, 2, 4, prepare_fn=sweeps.flow_llin4_sweep(1.5)[0])
    with pytest.raises(ValueError, match="tile kernel runs"):
        tiled.tiled_relax(meta, sweep, 2, 4, prepare_fn=None)


def test_cpu_path_and_import_build_nothing(rng, monkeypatch, tmp_path):
    def no_build(*args, **kwargs):
        raise AssertionError("nothing may be built on the CPU path")

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "build", no_build)
    monkeypatch.setattr(build, "load", no_build)
    importlib.reload(tiled)
    before = dict(tiled_cuda.LAUNCHES)
    t = _llin_cpu(rng, h=20, w=21)
    prepare, sweep = sweeps.flow_llin4_sweep(1.9)
    _assert_equal(tiled.tiled_relax(t, sweep, 2, 3, prepare_fn=prepare, plan_override=(2, 8)),
                  _plain_global("flow_llin4", t, 3))
    assert tiled_cuda.LAUNCHES == before
    assert tiled_cuda._lib.cache_info().currsize == 0


def test_library_path_follows_included_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include <cstdint>\n#include "a.cuh"\nint f();\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cuh").write_text("// not included\n")
    assert build._with_headers(tmp_path / "k.cu") == [tmp_path / n for n in ("k.cu", "a.cuh", "b.cuh")]
    first = build.library_path("k")
    assert first.name.startswith("libk_") and not first.exists()
    (tmp_path / "other.cuh").write_text("// edited\n")
    assert build.library_path("k") == first
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    assert build.library_path("k") != first


def test_tiled_source_includes_the_shared_arithmetic():
    # the global source's llin8 arithmetic is flow8_update.cuh, which the
    # resident 8-neighbour kernel shares; it includes flow_update.cuh too
    for source, headers in ((tiled_cuda.SOURCE, ["flow_update.cuh"]),
                            ("flow_llin4_sor", ["flow8_update.cuh", "flow_update.cuh"])):
        files = build._with_headers(build.CSRC / f"{source}.cu")
        assert [f.name for f in files] == [f"{source}.cu", *headers]
    path = build.library_path(tiled_cuda.SOURCE)
    assert path.parent == build.BUILD_DIR and path.name.startswith("libtiled_sor_")


# ---------------------------------------------------------------------------
# the redesigned kernel's plan and the dispatch's route
# ---------------------------------------------------------------------------

# (family, (h, w), where the dispatch sends it): phase 16's shapes of
# chip_smoke.py and the main path's
ROUTES = {
    "llin4 1024x1024": ("llin4", (1024, 1024), "tiled"),
    "llin4 768x768": ("llin4", (768, 768), "tiled"),
    "elin4 1024x1024": ("elin4", (1024, 1024), "tiled"),
    "elin4 768x768": ("elin4", (768, 768), "tiled"),
    "llin4 480x640": ("llin4", (480, 640), "resident"),
    "elin4 480x640": ("elin4", (480, 640), "resident"),
    "llin8 1024x1024, no tile kernel": ("llin8", (1024, 1024), "global"),
    "disp 1024x1024, no tile kernel": ("disp", (1024, 1024), "global"),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_sor_route_from_the_shape(case):
    family, (h, w), want = ROUTES[case]
    route, plan = dispatch.sor_route(family, h, w, 1, 4, 132)
    assert route == want
    if route == "tiled":
        n_fields = len(tiled_cuda.FIELD_NAMES[f"flow_{family}"])
        assert plan == tiled.plan_tiles(h, w, n_fields, 4, 4, sm_count=132)
        assert plan.k == 4 and plan.n_tiles_h * plan.n_tiles_w >= 132
    elif route == "resident":
        assert plan == resident_cuda.plan_resident(h, w, family, 1, 132)
    else:
        assert plan is None
    # a batch has no tile kernel
    if route == "tiled":
        assert dispatch.sor_route(family, h, w, 2, 4, 132)[0] == "global"


@pytest.mark.parametrize("family", ["llin4", "elin4"])
def test_dispatch_sends_a_shape_without_resident_plan_to_the_tile_kernel(monkeypatch, family):
    """Off the CPU, a 1024x1024 solve goes to the tile wrapper with the
    route's plan, chosen before any launch; neither the resident nor the
    global kernel is called."""
    seen = []

    def tile_spy(fam, fields, iters, omega, k, tile_h, tile_w, double_buffer=False, slots=None):
        seen.append((fam, len(fields), iters, k, tile_h, tile_w, slots))
        return fields[0], fields[1]

    def refuse(*args, **kwargs):
        raise AssertionError("the shape has a tile plan: no other kernel may run")

    monkeypatch.setattr(resident_cuda, "sm_count", lambda index: 132)
    monkeypatch.setattr(tiled_cuda, "tiled_flow_sor", tile_spy)
    for mod, name in ((sor_cuda, f"flow_{family}_sor"), (resident_cuda, f"flow_{family}_sor")):
        monkeypatch.setattr(mod, name, refuse)
    names = LLIN if family == "llin4" else ELIN
    meta = [torch.empty((1024, 1024), device="meta") for _ in names]
    fn = dispatch.sor_flow_llin4 if family == "llin4" else dispatch.sor_flow_elin4
    if family == "llin4":
        du, dv, u, v, *rest = meta
        fn(u, v, du, dv, *rest, 9, 1.9)
    else:
        fn(*meta, 9, 1.9)
    plan = dispatch.sor_route(family, 1024, 1024, 1, 9, 132)[1]
    assert seen == [(f"flow_{family}", len(names), 9, 4, plan.tile_h, plan.tile_w, plan.slots)]


# (the array (h, w), the window's box, or None for the whole array; the
# plan's tile and pairs a thread)
PLAN_SHAPES = {
    "1024x1024": ((1024, 1024), None, (16, 48, 2)),
    "a 240x320 shard and its 8-px halo (2x2 mesh over 480x640)":
        ((248, 328), (0, 240, 0, 320), (16, 24, 2)),
    "a 480x160 shard and its halo (1x4 mesh over 480x640)":
        ((480, 168), (0, 480, 0, 160), (16, 24, 2)),
    "a 180x240 shard and its halo (2x2 mesh over 360x480)":
        ((188, 248), (0, 180, 0, 240), (8, 24, 1)),
}


@pytest.mark.parametrize("double_buffer", [False, True])
@pytest.mark.parametrize("n_fields", [13, 11])
@pytest.mark.parametrize("case", sorted(PLAN_SHAPES))
def test_plan_fills_the_card(case, n_fields, double_buffer):
    (h, w), box, want = PLAN_SHAPES[case]
    bh, bw = (h, w) if box is None else (box[1] - box[0], box[3] - box[2])
    plan = tiled.plan_tiles(bh, bw, n_fields, 4, 4, double_buffer=double_buffer,
                            exact_k=box is not None, sm_count=132)
    assert plan.k == 4
    assert plan.n_tiles_h * plan.n_tiles_w >= 132  # a block an SM at least
    assert plan.smem_bytes == (2 if double_buffer else 1) * tiled.slot_bytes(
        n_fields, 4, plan.tile_h, plan.tile_w) <= tiled.SMEM_PER_BLOCK
    assert plan.threads == tiled.block_threads(4, plan.tile_h, plan.tile_w, plan.slots)
    assert plan.threads <= tiled.MAX_THREADS[plan.slots] and plan.threads % 32 == 0
    # 16x48 tiles give a shard fewer blocks than SMs (105, 120, 60)
    assert (plan.tile_h, plan.tile_w, plan.slots) == want
    assert plan.threads <= tiled.PLAN_THREADS  # two blocks an SM
    rows, hc = tiled._slot_dims(4, plan.tile_h, plan.tile_w)
    assert plan.threads * plan.slots >= rows * hc  # every pair of the slot owned


@pytest.mark.parametrize("k", [6, 8, 9])
def test_plan_of_a_long_window_chunk_takes_smaller_tiles(k):
    """A window's chunk of more than 4 sweeps keeps its k (exact_k): its
    halo gives 16x48 tiles more pairs than a block holds, so the plan takes
    a smaller tile or more pairs a thread, which the kernel takes."""
    plan = tiled.plan_tiles(240, 320, 13, k, k, exact_k=True, sm_count=132)
    assert plan.k == k
    assert (plan.tile_h, plan.tile_w) in tiled.TILES[1:]
    assert plan.threads <= tiled.MAX_THREADS[plan.slots]
    assert plan == tiled.make_plan(240, 320, 13, k, plan.tile_h, plan.tile_w, plan.slots)


# (n_fields, k, tile_h, tile_w, bytes): two float32 planes (one a colour) of
# each field neighbours read, over the tile and its 2k halo, 16-byte rounded
SLOT_BYTES = {
    "llin4 32x48, k=4": (13, 4, 32, 48, 4 * 2 * 4 * 48 * 32),
    "elin4 32x48, k=4": (11, 4, 32, 48, 4 * 2 * 2 * 48 * 32),
    "llin4 odd 7x9, k=3": (13, 3, 7, 9, 4 * 2 * 4 * 19 * 11),
    "elin4 1x1, k=1": (11, 1, 1, 1, 4 * 2 * 2 * 5 * 3),
}


@pytest.mark.parametrize("case", sorted(SLOT_BYTES))
def test_slot_bytes_of_the_colour_split_layout(case):
    n_fields, k, th, tw, want = SLOT_BYTES[case]
    assert tiled.slot_bytes(n_fields, k, th, tw) == want
    # the old layout, every field and a flag byte a pixel, took 53 (45) B a pixel
    px = (th + 4 * k) * (tw + 4 * k)
    assert tiled.slot_bytes(n_fields, k, th, tw) < (n_fields * 4 + 1) * px


def test_plan_refuses_what_the_kernel_does_not_take():
    assert tiled.make_plan(64, 64, 13, 4, 300, 16) is None          # rows past 254
    assert tiled.make_plan(64, 64, 13, 4, 16, 600) is None          # half-columns past 255
    assert tiled.make_plan(64, 64, 13, 4, 64, 96, slots=1) is None  # too many threads
    plan = tiled.make_plan(64, 64, 13, 4, 16, 24)
    assert plan.slots == 1 and plan.threads == tiled.block_threads(4, 16, 24, 1)


# (h, w, iters, NaN fields, k, tile, slots): the new plans' tile shapes at
# small sizes, ragged edges and several chunks
NEW_TILE_CASES = {
    "16x24 tiles, k = 4, 9 sweeps": (40, 53, 9, NAN_ALL, 4, (16, 24), 2),
    "32x32 tiles, k = 4, one tile ragged": (37, 45, 4, NAN_ALL, 4, (32, 32), 2),
    "24x48 tiles, k = 3": (50, 61, 7, ("cu", "duc"), 3, (24, 48), 3),
    "8x16 tiles, k = 2": (19, 35, 5, NAN_ALL, 2, (8, 16), 1),
}


@pytest.mark.parametrize("case", sorted(NEW_TILE_CASES))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_plain_schedule_at_the_new_tiles_equals_plain_global_solver(rng, family, case):
    h, w, iters, nan_names, k, tile, slots = NEW_TILE_CASES[case]
    names, factory, _ = FAMILIES[family]
    t = [torch.from_numpy(x) for x in _fields(rng, h, w, names, nan_names)]
    prepare, sweep = factory(1.9)
    for double_buffer in (False, True):
        got = tiled.tiled_relax(t, sweep, 2, iters, prepare_fn=prepare,
                                plan_override=(k, tile, slots), double_buffer=double_buffer)
        _assert_equal(got, _plain_global(family, t, iters))


# (image (gh, gw), box in the image (R0, R1, C0, C1), k, tile or None for
# the default plan): odd origins, the image's edges, NaN data
NEW_WINDOW_CASES = {
    "odd origin, 16x24 tiles": ((45, 61), (9, 30, 13, 44), 4, (16, 24)),
    "the image's corner, 8x16 tiles": ((45, 61), (0, 17, 40, 61), 3, (8, 16)),
    "a 2x2 shard, the default plan": ((64, 96), (32, 64, 0, 48), 4, None),
}


@pytest.mark.parametrize("case", sorted(NEW_WINDOW_CASES))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_windowed_schedule_at_the_new_tiles_equals_plain_global_solver(rng, family, case):
    (gh, gw), (R0, R1, C0, C1), k, tile = NEW_WINDOW_CASES[case]
    names, factory, _ = FAMILIES[family]
    t = [torch.from_numpy(x) for x in _fields(rng, gh, gw, names, NAN_ALL)]
    want = _plain_global(family, t, k)
    halo = 2 * k
    r0, r1 = max(0, R0 - halo), min(gh, R1 + halo)
    c0, c1 = max(0, C0 - halo), min(gw, C1 + halo)
    window = tiled.Window(r0, c0, gh, gw, (R0 - r0, R1 - r0, C0 - c0, C1 - c0))
    prepare, sweep = factory(1.9)
    kw = {} if tile is None else dict(plan_override=(k, tile))
    got = tiled.tiled_relax([x[r0:r1, c0:c1] for x in t], sweep, 2, k, prepare_fn=prepare,
                            window=window, **kw)
    _assert_equal(tuple(got), tuple(x[R0:R1, C0:C1] for x in want))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_new_tile_shape_matches_pallas_stripe_engine(rng, family):
    """The port's plain schedule at a tile of the new plans (16x24, k = 4)
    against pde_tpu's kernel in interpret mode (16-row stripes, k = 2), NaN
    in Cu and Du, within tests/test_kernels.py's tolerance."""
    names, factory, jfactory = FAMILIES[family]
    f = _fields(rng, 48, 65, names, ("cu", "duc"))
    jprep, jsweep = jfactory(1.9)
    want = jtiled_relax(tuple(jnp.asarray(x) for x in f), jsweep, 2, 5, prepare_fn=jprep,
                        interpret=True, plan_override=(2, 16))
    prepare, sweep = factory(1.9)
    got = tiled.tiled_relax([torch.from_numpy(x) for x in f], sweep, 2, 5, prepare_fn=prepare,
                            plan_override=(4, (16, 24), 2))
    for g, w_ in zip(got, want):
        g = g.numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w_), atol=2e-6, rtol=1e-5)
