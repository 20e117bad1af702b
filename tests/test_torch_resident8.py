"""The resident 8-neighbour SOR kernels' host side and read rule
(``pde_tpu_torch/csrc/resident8_sor.cu`` through
``kernels/resident_cuda.py`` and ``kernels/dispatch.py``): the launch plans
of llin8 (``flow_ad``) and pde8 (``tv_denoise8``) at every pyramid level,
the rule by which the kernel reads its neighbours (ping-pong colour planes,
band edges, pde8's border), written in torch ops and held bit for bit
against the plain solvers, the choice between the resident and the global
kernels from the shape, and the rules that hold without a card.

The kernels themselves run only on the card: ``chip_smoke.py`` holds them
against the global kernels and the plain versions there.
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

W8 = resident_cuda.W8_NAMES
LLIN8 = resident_cuda.LLIN8_NAMES
PDE8 = resident_cuda.PDE8_NAMES
DIAG = ("wnw", "wne", "wse", "wsw")
# flow_ad's pyramid at 3x480x640 (it stops at 20 px, as flow_nd's), and
# tv_denoise8's two levels (its partial pyramid stops at 0.75 of the image)
FLOW_LEVELS = pyramid_scales(480, 640, 0.75, 20)
TV8_LEVELS = [(480, 640), (360, 480)]
# the plan of every level: (scope, bands), finest level first
LLIN8_PLANS = [("grid", 120), ("grid", 120), ("grid", 90), ("grid", 102), ("grid", 77),
               ("grid", 58), ("cluster", 15), ("cluster", 14), ("cluster", 13), ("cluster", 13),
               ("cluster", 15), ("block", 1), ("block", 1)]
PDE8_PLANS = [("grid", 120), ("grid", 120)]
# registers a pixel keeps, the reckoning a plan is held to: llin8 five
# coefficient floats and its flag bits, pde8 two floats a channel and a
# position word, with room (the weights sit in shared memory)
REGS_PER_PX = {"llin8": 7, "pde8": lambda c: 2 * c + 2}
REGS_PER_SM = 65536
# the neighbours in the plain order W, E, N, S, NW, NE, SW, SE
NBRS = ((0, -1), (0, 1), (-1, 0), (1, 0), (-1, -1), (-1, 1), (1, -1), (1, 1))


def _field(rng, name, shape):
    if name in ("duc", "dvc", "trace"):
        return rng.random(shape) + 1.0
    if name == "m":
        return rng.random(shape) * 0.01
    if name in DIAG:
        return rng.random(shape) * 0.3 - 0.15
    if name.startswith("w"):
        return rng.random(shape) + 0.1
    return rng.random(shape) * 0.2


def _fields(rng, names, shape, nan_names=(), shared=()):
    """Unit-scale solver fields, diagonal weights of both signs, 5% NaN in
    ``nan_names``; the names in ``shared`` are one (H, W) plane; TRACE above
    the weights' absolute sum, as tv_denoise8's."""
    out = {n: _field(rng, n, shape[-2:] if n in shared else shape) for n in names}
    if "trace" in out:
        out["trace"] = out["trace"] + sum(np.abs(out[n]) for n in W8)
    for n in nan_names:
        out[n] = np.where(rng.random(out[n].shape) < 0.05, np.nan, out[n])
    return [out[n].astype(np.float32) for n in names]


def _t(fields):
    return [torch.from_numpy(f) for f in fields]


def _bit_equal(a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _no_build(name):
    raise AssertionError("nothing may be built here")


# ---- plans ----------------------------------------------------------------

@pytest.mark.parametrize("family,batch,levels", [
    ("llin8", 1, FLOW_LEVELS),
    ("pde8", 1, TV8_LEVELS),
    ("pde8", 3, TV8_LEVELS),
])
def test_every_level_has_a_plan_that_covers_every_pixel_once(family, batch, levels):
    for h, w in levels:
        plan = resident_cuda.plan_resident(h, w, family, batch)
        assert plan is not None, (family, batch, h, w)
        px = resident_cuda.slot_pixels(plan, h, w)
        count = torch.zeros((h, w), dtype=torch.int64)
        count.index_put_((px[:, 0], px[:, 1]), torch.ones(len(px), dtype=torch.int64),
                         accumulate=True)
        assert bool((count == 1).all()), (h, w, plan)
        assert plan.smem_bytes == resident_cuda.smem_bytes(family, plan.rows, w, batch)
        assert plan.smem_bytes <= resident_cuda.MAX_SMEM
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= resident_cuda.MAX_THREADS
        assert plan.slots in resident_cuda.SLOTS[family]
        assert plan.blocks == -(-h // plan.rows) and plan.batch == batch
        regs = REGS_PER_PX[family] if family == "llin8" else REGS_PER_PX[family](batch)
        assert plan.threads * plan.pixels_per_thread * regs <= REGS_PER_SM
        if plan.blocks > 1:
            assert plan.rows >= 2
            assert family == "llin8" or h - (plan.blocks - 1) * plan.rows >= 2
        assert (plan.scope == "block") == (plan.blocks == 1)
        if plan.scope == "cluster":
            assert plan.blocks <= resident_cuda.MAX_CLUSTER
        # pde8's channels share a thread: one band a block whatever the batch
        assert plan.blocks <= resident_cuda.SM_COUNT


@pytest.mark.parametrize("family,batch,levels,want", [
    ("llin8", 1, FLOW_LEVELS, LLIN8_PLANS),
    ("pde8", 1, TV8_LEVELS, PDE8_PLANS),
    ("pde8", 3, TV8_LEVELS, PDE8_PLANS),
])
def test_pyramid_levels_get_the_documented_plan(family, batch, levels, want):
    got = [resident_cuda.plan_resident(h, w, family, batch) for h, w in levels]
    assert [(p.scope, p.blocks) for p in got] == want


@pytest.mark.parametrize("family,batch", [("llin8", 1), ("pde8", 1), ("pde8", 3)])
def test_default_plan_is_the_cheapest_of_the_candidates(family, batch):
    """The cost: slots a thread times warps a scheduler, threads / 128, plus
    the barrier's; within a scope more and narrower bands cost less."""
    def cost(p):
        return (p.slots * p.threads / 128 + resident_cuda.SCOPE_COST8[p.scope],
                resident_cuda.SCOPES.index(p.scope), p.blocks)

    for h, w in (FLOW_LEVELS if family == "llin8" else TV8_LEVELS):
        plans = resident_cuda.plans_resident(h, w, family, batch)
        best = resident_cuda.plan_resident(h, w, family, batch)
        assert best in plans and all(cost(best) <= cost(p) for p in plans)
        # and no plan of any band count costs less
        for n in range(1, h + 1):
            p = resident_cuda.plan_with_bands(h, w, family, batch, n)
            assert p is None or cost(best)[0] <= cost(p)[0]


def test_plan_refuses_what_the_kernel_does_not_take():
    assert resident_cuda.plan_resident(2, 9, "pde8") is None       # no interior
    assert resident_cuda.plan_resident(9, 2, "pde8", 3) is None
    assert resident_cuda.plan_resident(37, 53, "pde8", 4) is None   # channels
    assert resident_cuda.plan_resident(37, 53, "llin8", 2) is None
    assert resident_cuda.plan_resident(1024, 1024, "llin8") is None  # one band an SM
    assert resident_cuda.plan_resident(1024, 1024, "pde8", 3) is None
    assert resident_cuda.plan_resident(480, 640, "llin8", sm_count=60) is None
    # a 1x1 flow system is one block; the band edges hold two rows at least
    assert resident_cuda.plan_resident(1, 1, "llin8").scope == "block"
    for h in (481, 97, 13):
        plan = resident_cuda.plan_resident(h, 64, "pde8")
        assert plan.blocks == 1 or h - (plan.blocks - 1) * plan.rows >= 2


def test_edge_scratch_holds_two_buffers_of_every_band_edge():
    plan = resident_cuda.plan_resident(480, 640, "pde8", 3)
    assert resident_cuda.edge_floats("pde8", 3, plan.blocks, 640) == 2 * 3 * 2 * plan.blocks * 640
    assert resident_cuda.edge_floats("llin8", 1, 120, 640) == 2 * 2 * 2 * 120 * 640


# ---- the read rule --------------------------------------------------------

class _Band:
    """The kernel's storage of the relaxed fields: per pixel two buffers
    (the ping-pong planes of its colour), and the grid's band-edge scratch,
    two buffers of the first and last row of every band of ``rows`` rows.
    A neighbour in another band is read from the scratch only; what the
    kernel never stores is NaN, so a wrong read shows."""

    def __init__(self, fields, rows):
        h, w = fields[0].shape[-2:]
        self.h, self.w, self.rows = h, w, rows
        ii = torch.arange(h)[:, None].expand(h, w)
        self.band = ii // rows
        last = torch.clamp((self.band + 1) * rows, max=h) - 1
        self.edge_row = (ii == self.band * rows) | (ii == last)
        nan = float("nan")
        self.buf = [[f.clone() for f in fields], [torch.full_like(f, nan) for f in fields]]
        self.edge = [[torch.where(self.edge_row, f, nan) for f in fields],
                     [torch.full_like(f, nan) for f in fields]]

    def read(self, f, ni, nj, b):
        """Field ``f`` at (ni, nj) from buffer ``b`` (index tensors of the
        image's shape), as the pixel at each position reads it."""
        own = self.band[ni, nj] == self.band
        from_buf = torch.where(b == 0, self.buf[0][f][..., ni, nj], self.buf[1][f][..., ni, nj])
        from_edge = torch.where(b == 0, self.edge[0][f][..., ni, nj],
                                self.edge[1][f][..., ni, nj])
        return torch.where(own, from_buf, from_edge)

    def write(self, f, mask, value, b):
        self.buf[b][f] = torch.where(mask, value, self.buf[b][f])
        self.edge[b][f] = torch.where(mask & self.edge_row, value, self.edge[b][f])


def _grid(h, w):
    ii = torch.arange(h)[:, None].expand(h, w)
    jj = torch.arange(w)[None, :].expand(h, w)
    return ii, jj


def _current(it, c, ni, nj):
    """The buffer of a pixel at (ni, nj) in the phase of colour c of sweep
    it: its colour's count of relaxations, modulo 2."""
    return (it + ((ni + nj) % 2 < c).long()) % 2


def read_rule_llin8(u, v, du, dv, m, cu, cv, duc, dvc, weights, iters, omega, rows):
    """``sor_flow_llin8`` computed as the resident kernel reads its fields:
    each phase from the ping-pong buffers and band-edge rows, with the
    plain version's arithmetic."""
    h, w = u.shape
    ii, jj = _grid(h, w)
    co = sor.flow_coefficients(m, cu, cv, duc, dvc, sor._edge_zeroed8(*weights))
    ww, wnw, wn, wne, we, wse, ws, wsw = co.weights
    wk = (ww, we, wn, ws, wnw, wne, wsw, wse)  # the neighbours' order
    st = _Band((du, dv), rows)
    for it in range(iters):
        for c in (0, 1):
            mask = (ii + jj) % 2 == c
            old = torch.full_like(ii, it % 2)
            fu, fv = st.read(0, ii, jj, old), st.read(1, ii, jj, old)

            def diff_term(f, g):
                total = None
                for (di, dj), wt in zip(NBRS, wk):
                    ni, nj = (ii + di).clamp(0, h - 1), (jj + dj).clamp(0, w - 1)
                    term = (st.read(f, ni, nj, _current(it, c, ni, nj)) + g[ni, nj]) * wt
                    total = term if total is None else total + term
                return total - g * co.wsum

            su, sv = diff_term(0, u), diff_term(1, v)
            num_u = torch.where(co.cu_nan, su, su + co.cu0 - co.m0 * fv)
            new_u = torch.where(mask, (1.0 - omega) * fu + omega * num_u * co.inv_u, fu)
            num_v = torch.where(co.cv_nan, sv, sv + co.cv0 - co.m0 * new_u)
            new_v = torch.where(mask, (1.0 - omega) * fv + omega * num_v * co.inv_v, fv)
            st.write(0, mask, new_u, (it + 1) % 2)
            st.write(1, mask, new_v, (it + 1) % 2)
    return st.buf[iters % 2][0], st.buf[iters % 2][1]


def read_rule_pde8(x, trace, b, weights, iters, omega, rows, border_rule="kernel"):
    """``sor_pde8`` computed as the resident kernel reads its field: the
    ping-pong buffers and band-edge rows, and the border by the kernel's
    rule (in sweep s >= 1 a border neighbour is its fill source at count s,
    buffer s & 1; in sweep 0 the input's border). ``border_rule="current"``
    reads the fill source's current buffer instead (the disp shortcut),
    which the plain version does not compute."""
    h, w = x.shape[-2:]
    ii, jj = _grid(h, w)
    ww, wnw, wn, wne, we, wse, ws, wsw = weights
    wk = (ww, we, wn, ws, wnw, wne, wsw, wse)
    wsum = sor._weight_sum(weights)
    tr_nan = torch.isnan(trace)
    inv = torch.where(tr_nan, 1.0 / wsum, 1.0 / torch.nan_to_num(trace, nan=1.0))
    b_eff = torch.where(tr_nan, 0.0, b)
    inner = (ii >= 1) & (ii <= h - 2) & (jj >= 1) & (jj <= w - 2)
    st = _Band((x,), rows)
    for it in range(iters):
        for c in (0, 1):
            mask = ((ii + jj) % 2 == c) & inner
            xc = st.read(0, ii, jj, torch.full_like(ii, it % 2))
            nbr = None
            for (di, dj), wt in zip(NBRS, wk):
                ni, nj = (ii + di).clamp(0, h - 1), (jj + dj).clamp(0, w - 1)
                border = (ni == 0) | (ni == h - 1) | (nj == 0) | (nj == w - 1)
                si, sj = ni.clamp(1, h - 2), nj.clamp(1, w - 2)
                if it == 0:
                    val = torch.where(border, st.read(0, ni, nj, torch.zeros_like(ni)),
                                      st.read(0, ni, nj, _current(it, c, ni, nj)))
                else:
                    src_buf = (torch.full_like(ni, it % 2) if border_rule == "kernel"
                               else _current(it, c, si, sj))
                    val = torch.where(border, st.read(0, si, sj, src_buf),
                                      st.read(0, ni, nj, _current(it, c, ni, nj)))
                term = val * wt
                nbr = term if nbr is None else nbr + term
            new = (b_eff + nbr) * inv
            st.write(0, mask, torch.where(mask, (1.0 - omega) * xc + omega * new, xc),
                     (it + 1) % 2)
    out = st.buf[iters % 2][0]
    if iters > 0:  # the border filled once, from the band
        out = out[..., ii.clamp(1, h - 2), jj.clamp(1, w - 2)]
    return out


READ_SHAPES = [(3, 3), (3, 8), (7, 3), (9, 12), (10, 13), (13, 17)]


@pytest.mark.parametrize("h,w", READ_SHAPES)
@pytest.mark.parametrize("iters", [0, 1, 3, 4])
def test_llin8_read_rule_is_the_plain_solver_bit_for_bit(rng, h, w, iters):
    f = _t(_fields(rng, LLIN8, (h, w), ("cu", "duc")))
    want = sor.sor_flow_llin8(*f, iters, 1.9)
    for rows in sorted({2, 3, h}):
        got = read_rule_llin8(*f[:9], f[9:], iters, 1.9, rows)
        assert _bit_equal(got[0], want[0]) and _bit_equal(got[1], want[1]), (rows, iters)


@pytest.mark.parametrize("h,w", READ_SHAPES)
@pytest.mark.parametrize("channels", [1, 3])
def test_pde8_read_rule_is_the_plain_solver_bit_for_bit(rng, h, w, channels):
    """The border is not pre-replicated, so a colour-1 pixel beside it reads
    in sweep 0 the input's border and from sweep 1 on the colour-0 value of
    the end of the previous sweep, not the current one."""
    shape = (h, w) if channels == 1 else (channels, h, w)
    f = _t(_fields(rng, PDE8, shape, ("trace",), shared=W8))
    for iters in (0, 1, 2, 4):
        want = sor.sor_pde8(*f, iters, 1.75)
        # bands of 2 to 5 rows where the last one has two rows too
        for rows in sorted({h} | {r for r in (2, 3, 4, 5) if r < h and h % r != 1}):
            got = read_rule_pde8(f[0], f[1], f[2], f[3:], iters, 1.75, rows)
            assert _bit_equal(got, want), (rows, iters)


def test_pde8_border_rule_matters(rng):
    """Reading the fill source's current value instead (the disp llin4
    shortcut) gives other floats from sweep 1 on: the border rule is what
    makes the kernel exact."""
    f = _t(_fields(rng, PDE8, (3, 10, 13), ("trace",), shared=W8))
    want = sor.sor_pde8(*f, 3, 1.75)
    got = read_rule_pde8(f[0], f[1], f[2], f[3:], 3, 1.75, 3, border_rule="current")
    assert not _bit_equal(got, want)
    # and after one sweep the two agree: sweep 0 reads the input's border
    want1 = sor.sor_pde8(*f, 1, 1.75)
    assert _bit_equal(read_rule_pde8(f[0], f[1], f[2], f[3:], 1, 1.75, 3, "current"), want1)


def test_border_fill_sources_lie_in_the_band():
    """The fill the kernel writes at the end: every border pixel takes
    (clamp(i, 1, H-2), clamp(j, 1, W-2)), whose row lies in the pixel's band
    when every band has two rows."""
    for h, w in ((3, 3), (10, 13), (481, 641)):
        plan = resident_cuda.plan_resident(h, w, "pde8", 1)
        y = replicate_border(torch.arange(h * w, dtype=torch.float32).reshape(h, w))
        ii, jj = _grid(h, w)
        src = (ii.clamp(1, h - 2), jj.clamp(1, w - 2))
        assert torch.equal(y, y[src])
        assert torch.equal(src[0] // plan.rows, ii // plan.rows)


# ---- dispatch and wrappers ------------------------------------------------

@pytest.mark.parametrize("system", ["llin8", "pde8"])
def test_dispatch_cpu_is_plain_builds_nothing_and_is_pde_tpu(rng, monkeypatch, system):
    """CPU tensors take the plain solver, launch nothing and build nothing;
    at a small level's shape the result is also pde_tpu's (<= 1e-4)."""
    monkeypatch.setattr(build, "load", _no_build)
    counts = [dict(m.LAUNCHES) for m in (resident_cuda, sor_cuda, interior_cuda)]
    h, w = FLOW_LEVELS[-1]
    if system == "llin8":
        f = _fields(rng, LLIN8, (h, w), ("cu", "duc"))
        got = dispatch.sor_flow_llin8(*_t(f), 4, 1.9)
        want = jsor.sor_flow_llin8(*(jnp.asarray(x) for x in f), 4, 1.9)
        plain = sor.sor_flow_llin8(*_t(f), 4, 1.9)
    else:
        f = _fields(rng, PDE8, (3, h, w), ("trace",), shared=W8)
        got = (dispatch.sor_pde8(*_t(f), 4, 1.75),)
        want = (jsor.sor_pde8(*(jnp.asarray(x) for x in f), 4, 1.75),)
        plain = (sor.sor_pde8(*_t(f), 4, 1.75),)
    for g, w_, p in zip(got, want, plain):
        assert torch.equal(g, p)
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=1e-4, rtol=0)
    assert [dict(m.LAUNCHES) for m in (resident_cuda, sor_cuda, interior_cuda)] == counts


@pytest.fixture
def card_routes(monkeypatch):
    """Dispatch as for CUDA tensors, with every llin8/pde8 kernel wrapper
    (and the tile kernel's) replaced by a recorder of (wrapper, plan) and
    nothing built."""
    monkeypatch.setattr(build, "load", _no_build)
    monkeypatch.setattr(dispatch, "_plain", lambda x: False)
    monkeypatch.setattr(resident_cuda, "sm_count", lambda index: resident_cuda.SM_COUNT)
    calls = []

    def recorder(name, n_out):
        def run(*args, plan=None):
            calls.append((name, plan))
            out = tuple(torch.zeros((2, 1)) for _ in range(n_out))
            return out if n_out > 1 else out[0]
        return run

    monkeypatch.setattr(resident_cuda, "flow_llin8_sor", recorder("resident llin8", 2))
    monkeypatch.setattr(resident_cuda, "pde8_sor", recorder("resident pde8", 1))
    monkeypatch.setattr(sor_cuda, "flow_llin8_sor", recorder("global llin8", 2))
    monkeypatch.setattr(interior_cuda, "pde8_sor", recorder("global pde8", 1))

    def tile_recorder(family, fields, iters, omega, k, tile_h, tile_w, double_buffer=False,
                      slots=None):
        calls.append((f"tile {family}", (k, tile_h, tile_w, slots)))
        return tuple(torch.zeros((2, 1)) for _ in range(tiled.LAYOUTS[family].n_mut))

    monkeypatch.setattr(tiled_cuda, "tiled_sor", tile_recorder)
    return calls


@pytest.mark.parametrize("h,w", [FLOW_LEVELS[0], FLOW_LEVELS[6], FLOW_LEVELS[-1], TV8_LEVELS[1]])
def test_dispatch_picks_the_resident_kernel_from_the_shape(card_routes, h, w):
    x = torch.zeros((h, w))
    dispatch.sor_flow_llin8(*([x] * 17), 4, 1.9)
    dispatch.sor_pde8(*([x] * 11), 4, 1.75)                                  # C = 1
    xc = torch.zeros((3, h, w))
    dispatch.sor_pde8(xc, xc, xc, *([x] * 8), 4, 1.75)                       # tv_denoise8's
    dispatch.sor_pde8(xc, x, x, *([x] * 8), 4, 1.75)                         # shared TRACE, B
    assert [c[0] for c in card_routes] == ["resident llin8"] + ["resident pde8"] * 3
    assert [c[1] for c in card_routes] == [resident_cuda.plan_resident(h, w, "llin8"),
                                           resident_cuda.plan_resident(h, w, "pde8", 1),
                                           resident_cuda.plan_resident(h, w, "pde8", 3),
                                           resident_cuda.plan_resident(h, w, "pde8", 3)]


def test_dispatch_sends_shapes_without_a_plan_to_the_global_kernels(card_routes):
    """Shapes no kernel of a plan takes go to the global kernels; a llin8
    (H, W) without a resident plan (1024x1024) goes to the tile kernel,
    the route tests/test_torch_tiled.py holds for every such shape."""
    big = torch.zeros((1024, 1024))
    dispatch.sor_flow_llin8(*([big] * 17), 4, 1.9)                           # the tile kernel
    dispatch.sor_flow_llin8(*([torch.zeros((2, 5, 5))] * 17), 4, 1.9)       # not (H, W)
    dispatch.sor_pde8(*([torch.zeros((2, 9))] * 11), 4, 1.75)               # no interior
    x4 = torch.zeros((4, 9, 9))
    dispatch.sor_pde8(x4, x4, x4, *([torch.zeros((9, 9))] * 8), 4, 1.75)   # 4 channels
    x3 = torch.zeros((3, 9, 9))
    dispatch.sor_pde8(*([x3] * 11), 4, 1.75)                                # weights per channel
    dispatch.sor_pde8(torch.zeros((2, 3, 9, 9)), *([torch.zeros((9, 9))] * 10), 4, 1.75)
    assert [c[0] for c in card_routes] == (["tile flow_llin8", "global llin8"]
                                           + ["global pde8"] * 4)
    plan = tiled.plan_tiles(1024, 1024, "flow_llin8", 4, 4, sm_count=resident_cuda.SM_COUNT)
    assert card_routes[0][1] == (4, plan.tile_h, plan.tile_w, plan.slots)
    assert all(c[1] is None for c in card_routes[1:])


def test_resident_wrappers_reject_cpu_tensors_before_building(rng, monkeypatch):
    monkeypatch.setattr(build, "load", _no_build)
    before = dict(resident_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        resident_cuda.flow_llin8_sor(*_t(_fields(rng, LLIN8, (8, 9))), 4, 1.9)
    with pytest.raises(ValueError, match="CUDA"):
        resident_cuda.pde8_sor(*_t(_fields(rng, PDE8, (3, 8, 9), shared=W8)), 4, 1.75)
    assert resident_cuda.LAUNCHES == before


def test_library_names_follow_sources_and_headers():
    path = build.library_path(resident_cuda.SOURCE8)
    assert path.parent == build.BUILD_DIR and path.name.startswith("libresident8_sor_")
    headers = [f.name for f in build._with_headers(build.CSRC / "resident8_sor.cu")]
    assert headers == ["resident8_sor.cu", "flow8_update.cuh", "pde8_update.cuh",
                       "resident_scope.cuh", "flow_update.cuh", "disp_update.cuh"]
    # the global kernels round with the same headers
    assert "flow8_update.cuh" in [f.name for f in build._with_headers(build.CSRC /
                                                                      "flow_llin4_sor.cu")]
    assert "pde8_update.cuh" in [f.name for f in build._with_headers(build.CSRC /
                                                                     "interior_sor.cu")]
