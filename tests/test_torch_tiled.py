"""The tile engine (``pde_tpu_torch/kernels/tiled.py``) for its six
families (llin4, elin4, disp llin4, pde4, llin8, pde8): its plain tile
schedule held exactly against the port's plain global solvers (disp at a
batch of 2, pde4 and pde8 at 3 channels too) and within a stated
tolerance against ``pde_tpu``'s Pallas stripe engine in interpret mode
(serial and double-buffered), also at the tiles of the
redesigned kernel's plans and through windows; the kernel's llin8 and disp
phase order from the neighbours' pre-added sums fl(dU + U), emulated in
torch ops, bit for bit against both; the tile plan (a block an SM, the
colour-split slot's bytes, threads); the dispatch's route from the
shape (``kernels/dispatch.sor_route``: resident, tile or global kernel);
the wrapper's refusals; and the build rule for headers.

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
from pde_tpu_torch.kernels import (build, dispatch, interior_cuda, resident_cuda, sor_cuda, sweeps,
                                   tiled, tiled_cuda)
from pde_tpu_torch.solvers import sor

torch.set_num_threads(1)

LLIN = tiled_cuda.FIELD_NAMES["flow_llin4"]
ELIN = tiled_cuda.FIELD_NAMES["flow_elin4"]
FAMILIES = {family: (tiled_cuda.FIELD_NAMES[family], getattr(sweeps, f"{family}_sweep"),
                     getattr(jsweeps, f"{family}_sweep"))
            for family in tiled.LAYOUTS}
NAN_ALL = ("cu", "cv", "duc", "dvc", "trace")


def _fields(rng, h, w, names, nan_names=()):
    """Unit-scale fields as tests/test_kernels.py makes them, 5% NaN in
    ``nan_names``; numpy float32, in the order of ``names``."""
    out = []
    for n in names:
        if n in ("duc", "dvc", "trace"):
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
    """The plain global solver of ``family`` on the tile engine's fields;
    the relaxed fields."""
    if family in ("flow_llin4", "flow_llin8"):
        du, dv, u, v, *rest = t
        return getattr(sor, f"sor_{family}")(u, v, du, dv, *rest, iters, 1.9)
    if family == "flow_elin4":
        return sor.sor_flow_elin4(*t, iters, 1.9)
    if family == "disp_llin4":
        du, u, *rest = t
        return (sor.sor_disp_llin4(u, du, *rest, iters, 1.9),)
    return (getattr(sor, f"sor_{family}")(*t, iters, 1.9),)


def _n_mut(family):
    return tiled.LAYOUTS[family].n_mut


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
    got = tiled.tiled_relax(t, sweep, _n_mut(family), iters, prepare_fn=prepare, **kw)
    _assert_equal(got, _plain_global(family, t, iters))


# (family, systems or channels, TRACE and B shared by the channels): the
# symmetric disparity pair and the denoisers' colour channels over shared
# weights
BATCH_CASES = {"disp_llin4, B = 2": ("disp_llin4", 2, False),
               **{f"{family}, C = {c}, TRACE and B {'shared' if shared else 'per channel'}":
                  (family, c, shared)
                  for family in ("pde4", "pde8") for c in (2, 3) for shared in (True, False)}}


def _batch_fields(rng, family, batch, shared, h=48, w=65, nan_names=NAN_ALL):
    """numpy fields of a batch: a plane a system for the relaxed field (every
    field of disp, TRACE and B of pde unless ``shared``), the others (H, W)
    planes the systems share."""
    out = []
    for i, name in enumerate(FAMILIES[family][0]):
        per_system = i == 0 or family == "disp_llin4" or (name in ("trace", "b") and not shared)
        planes = [_fields(rng, h, w, (name,), nan_names)[0] for _ in range(batch)]
        out.append(np.stack(planes) if per_system else planes[0])
    return out


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_plain_tile_schedule_of_a_batch_equals_plain_global_solver(rng, case):
    """A batch through the tile schedule (disp's systems along the kernel's
    grid, the pde channels in one block), the weights (H, W) planes shared
    by the channels: 48x65, 5 sweeps, k = 2, NaN data, bit for bit."""
    family, batch, shared = BATCH_CASES[case]
    names, factory, _ = FAMILIES[family]
    t = [torch.from_numpy(x) for x in _batch_fields(rng, family, batch, shared)]
    prepare, sweep = factory(1.9)
    got = tiled.tiled_relax(t, sweep, 1, 5, prepare_fn=prepare, plan_override=(2, 16))
    assert got[0].shape == (batch, 48, 65)
    _assert_equal(got, _plain_global(family, t, 5))


@pytest.mark.parametrize("double_buffer", [False, True])
@pytest.mark.parametrize("shared", [True, False], ids=["TRACE, B shared", "TRACE, B per channel"])
@pytest.mark.parametrize("family", ["pde4", "pde8"])
def test_channels_of_a_block_match_pallas_stripe_engine(rng, family, shared, double_buffer):
    """C = 2 channels over shared weights (the kernel's one block a tile
    for every channel), NaN in TRACE, through the port's plain schedule at
    the 40x32 tile of the multi-channel plans, against pde_tpu's stripe
    engine in interpret mode run channel by channel (its kernels take (H,
    W) fields), 16-row stripes, k = 2; within tests/test_kernels.py's atol
    2e-6, rtol 1e-5 (ROADMAP F3)."""
    names, factory, jfactory = FAMILIES[family]
    f = _batch_fields(rng, family, 2, shared, nan_names=("trace",))
    jprep, jsweep = jfactory(1.9)
    want = [jtiled_relax(tuple(jnp.asarray(x[c] if x.ndim == 3 else x) for x in f), jsweep, 1, 5,
                         prepare_fn=jprep, interpret=True, plan_override=(2, 16),
                         double_buffer=double_buffer)[0] for c in range(2)]
    prepare, sweep = factory(1.9)
    (got,) = tiled.tiled_relax([torch.from_numpy(x) for x in f], sweep, 1, 5, prepare_fn=prepare,
                               plan_override=(4, (40, 32), 3), double_buffer=double_buffer)
    assert got.shape == (2, 48, 65) and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.stack([np.asarray(w_) for w_ in want]),
                               atol=2e-6, rtol=1e-5)


# every family, serial and double-buffered
STRIPE_CASES = [(family, db) for family in sorted(FAMILIES) for db in (False, True)]


@pytest.mark.parametrize("family,double_buffer", STRIPE_CASES)
def test_tiled_relax_matches_pallas_stripe_engine(rng, family, double_buffer):
    """The shapes of tests/test_kernels.py's multi-stripe cases, NaN in Cu
    and Du (TRACE for pde4 and pde8); pde_tpu's kernel in interpret mode,
    16-row stripes. Within tests/test_kernels.py's atol 2e-6, rtol 1e-5:
    XLA on the CPU does not round the neighbour sums op by op (ROADMAP F3),
    so the two meet to a few ulps, not bit for bit."""
    names, factory, jfactory = FAMILIES[family]
    f = _fields(rng, 48, 65, names, ("cu", "duc", "trace"))
    jprep, jsweep = jfactory(1.9)
    n_mut = _n_mut(family)
    want = jtiled_relax(tuple(jnp.asarray(x) for x in f), jsweep, n_mut, 5, prepare_fn=jprep,
                        interpret=True, plan_override=(2, 16), double_buffer=double_buffer)
    prepare, sweep = factory(1.9)
    got = tiled.tiled_relax([torch.from_numpy(x) for x in f], sweep, n_mut, 5,
                            prepare_fn=prepare, plan_override=(2, 16),
                            double_buffer=double_buffer)
    assert len(got) == len(want) == n_mut
    for g, w_ in zip(got, want):
        g = g.numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w_), atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_default_plan_double_buffered_matches_pallas_stripe_engine(rng, family):
    """``double_buffer=True`` at the default plan, 48x65, 5 sweeps, NaN in
    Cu and Du (TRACE for pde4 and pde8): the relaxed fields in every
    family, as ``pde_tpu``'s ``_stripe_kernel_db`` in interpret mode gives
    them, the serial form's bits, and within tests/test_kernels.py's atol
    2e-6, rtol 1e-5 of pde_tpu's (ROADMAP F3)."""
    names, factory, jfactory = FAMILIES[family]
    f = _fields(rng, 48, 65, names, ("cu", "duc", "trace"))
    jprep, jsweep = jfactory(1.9)
    n_mut = _n_mut(family)
    want = jtiled_relax(tuple(jnp.asarray(x) for x in f), jsweep, n_mut, 5, prepare_fn=jprep,
                        interpret=True, double_buffer=True)
    assert want is not None
    prepare, sweep = factory(1.9)
    t = [torch.from_numpy(x) for x in f]
    got = tiled.tiled_relax(t, sweep, n_mut, 5, prepare_fn=prepare, double_buffer=True)
    assert got is not None and len(got) == len(want) == n_mut
    _assert_equal(got, tiled.tiled_relax(t, sweep, n_mut, 5, prepare_fn=prepare))
    for g, w_ in zip(got, want):
        g = g.numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w_), atol=2e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# llin8's and disp's colour phases in the kernel's order, from the
# neighbours' pre-added sums fl(dU + U) (fl(dV + V)): llin8's kernel keeps
# them in shared memory; disp's forms each as it reads dU and U (the kept
# sums measured slower there), the same floats
# ---------------------------------------------------------------------------

_NBR8 = ((0, -1), (0, 1), (-1, 0), (1, 0), (-1, -1), (-1, 1), (1, -1), (1, 1))
_NBR4 = _NBR8[:4]


def _pre_added_chunk(family, mut, const, k, tile_h, tile_w):
    """One chunk of ``k`` sweeps of flow_llin8 or disp_llin4 (one system,
    (H, W) fields), tile by tile, as ``csrc/tiled_sor.cu`` runs it: a slot
    (the tile and its halo) keeps each relaxed field and, for the
    neighbours, its sum with the frozen field, in two buffers (llin8: a
    diagonal neighbour has the pixel's own colour; buffer 1 starts as NaN,
    so that a read before a write shows) or one (disp). The phase of image
    colour ``c`` in sweep ``s`` reads a neighbour of its own colour from
    buffer ``s & 1``, of the other from ``(s + c) & 1``, and writes the new
    fields in place and their sums into ``(s + 1) & 1``. llin8 reads a
    neighbour off the image as the clamped pixel's sum; disp reads a border
    neighbour after sweep 0 as fl(dU of this pixel + U of the border pixel),
    what the plain fill leaves there. The arithmetic is the plain version's
    (``solvers/sor.py``), from the sums on."""
    eight = family == "flow_llin8"
    n_mut = len(mut)
    h, w = mut[0].shape
    fill = 0 if eight else 1
    halo = 2 * k + fill
    prepare, _ = FAMILIES[family][1](1.9)
    out = [x.clone() for x in mut]
    for r0, c0 in tiled.tile_origins(h, w, tile_h, tile_w):
        r1, c1 = min(r0 + tile_h, h), min(c0 + tile_w, w)
        gr0, gr1, gc0, gc1 = max(r0 - halo, 0), min(r1 + halo, h), max(c0 - halo, 0), min(c1 + halo, w)
        rows, cols = gr1 - gr0, gc1 - gc0
        gi = torch.arange(gr0, gr1)[:, None].expand(rows, cols)
        gj = torch.arange(gc0, gc1)[None, :].expand(rows, cols)
        colour = (gi + gj) % 2
        inner = (gi >= 1) & (gi <= h - 2) & (gj >= 1) & (gj <= w - 2)
        aux = sweeps.TileAux(colour == 0, colour == 1, gj == 0, gi == 0, gj == w - 1, gi == h - 1)
        frozen, co = (lambda t: (t[:-1], t[-1]))(
            prepare([x[gr0:gr1, gc0:gc1] for x in const], aux))
        vals = [x[gr0:gr1, gc0:gc1].clone() for x in mut]
        bufs = [[d + u for d, u in zip(vals, frozen)],
                [torch.full_like(d, float("nan")) for d in vals]]
        for s in range(k):
            for c in (0, 1):
                reach = 2 * (k - 1 - s) + 1 - c + fill
                mask = ((colour == c) & (gi >= r0 - reach) & (gi < r1 + reach)
                        & (gj >= c0 - reach) & (gj < c1 + reach))
                if not eight:
                    mask &= inner
                rb, ob, wb = (s & 1, (s + c) & 1, (s + 1) & 1) if eight else (0, 0, 0)
                terms = []
                for di, dj in (_NBR8 if eight else _NBR4):
                    ni = (gi + di).clamp(0, h - 1).clamp(gr0, gr1 - 1) - gr0
                    nj = (gj + dj).clamp(0, w - 1).clamp(gc0, gc1 - 1) - gc0
                    same = colour[ni, nj] == c
                    t = [torch.where(same, bufs[rb][f][ni, nj], bufs[ob][f][ni, nj])
                         for f in range(n_mut)]
                    if not eight and s > 0:
                        on_border = ~inner[ni, nj]
                        t = [torch.where(on_border, vals[0] + frozen[0][ni, nj], t[0])]
                    terms.append(t)
                new = _phase_from_sums(eight, vals, frozen, terms, co, mask)
                for f in range(n_mut):
                    vals[f] = new[f]
                    bufs[wb][f] = torch.where(mask, new[f] + frozen[f], bufs[wb][f])
        # the tile's interior; disp's border pixels take their fill source
        ii = torch.arange(r0, r1)[:, None].expand(r1 - r0, c1 - c0)
        jj = torch.arange(c0, c1)[None, :].expand(r1 - r0, c1 - c0)
        if not eight:
            ii, jj = ii.clamp(1, h - 2), jj.clamp(1, w - 2)
        for o, v in zip(out, vals):
            o[r0:r1, c0:c1] = v[ii - gr0, jj - gc0]
    return out


def _phase_from_sums(eight, vals, frozen, terms, co, mask):
    """One colour of the plain half-sweep (``flow_half_sweep`` with eight
    weights, ``disp_half_sweep``) from the neighbours' sums ``terms``, in
    the plain sum's order W, E, N, S (NW, NE, SW, SE)."""
    if eight:
        ww, wnw, wn, wne, we, wse, ws, wsw = co.weights
        order = (ww, we, wn, ws, wnw, wne, wsw, wse)
    else:
        ww, wn, we, ws = co.weights
        order = (ww, we, wn, ws)
    sums = []
    for f in range(len(vals)):
        acc = terms[0][f] * order[0]
        for t, wt in zip(terms[1:], order[1:]):
            acc = acc + t[f] * wt
        sums.append(acc - frozen[f] * co.wsum)
    if not eight:
        (df,), (s,) = vals, sums
        num = torch.where(co.cu_nan, s, s + co.cu0)
        return [torch.where(mask, (1.0 - 1.9) * df + 1.9 * num * co.inv, df)]
    (fu, fv), (su, sv) = vals, sums
    num_u = torch.where(co.cu_nan, su, su + co.cu0 - co.m0 * fv)
    new_u = torch.where(mask, (1.0 - 1.9) * fu + 1.9 * num_u * co.inv_u, fu)
    num_v = torch.where(co.cv_nan, sv, sv + co.cv0 - co.m0 * new_u)
    new_v = torch.where(mask, (1.0 - 1.9) * fv + 1.9 * num_v * co.inv_v, fv)
    return [new_u, new_v]


def _pre_added_relax(family, t, iters, k, tile_h, tile_w):
    """``iters`` sweeps in chunks of ``k`` through ``_pre_added_chunk``, each
    system of a batch (disp's, (B, H, W) fields) on its own."""
    n_mut = _n_mut(family)
    batch = max([x.shape[0] for x in t if x.ndim == 3] or [1])
    systems = [[x[b] if x.ndim == 3 else x for x in t] for b in range(batch)]
    outs = []
    for fields in systems:
        mut, const = fields[:n_mut], fields[n_mut:]
        n_full, rem = divmod(iters, k)
        for kc in [k] * n_full + ([rem] if rem else []):
            mut = _pre_added_chunk(family, mut, const, kc, tile_h, tile_w)
        outs.append(mut)
    if batch == 1 and t[0].ndim == 2:
        return tuple(outs[0])
    return tuple(torch.stack([o[f] for o in outs]) for f in range(n_mut))


# EXACT_CASES (the kernel takes disp at H, W >= 3 only), 1-px edge tiles
# along both axes (F10: their border pixels fill from sources in the next
# tile), and disparity_sym's pair
PRE_ADDED_CASES = {
    **{(family, case): EXACT_CASES[case] for family in ("flow_llin8", "disp_llin4")
       for case in EXACT_CASES if family == "flow_llin8" or min(EXACT_CASES[case][:2]) >= 3},
    **{(family, "1-px edge tiles, both axes"): (49, 65, 5, NAN_ALL, dict(plan_override=(2, 16)))
       for family in ("flow_llin8", "disp_llin4")},
    ("disp_llin4", "B = 2, NaN data"): (48, 65, 5, NAN_ALL, dict(plan_override=(2, 16))),
}


def _plan_of(family, h, w, iters, kw):
    if "plan_override" in kw:
        k, tile = kw["plan_override"]
        return (k, *((tile, tile) if isinstance(tile, int) else tile))
    plan = tiled.plan_tiles(h, w, family, iters, kw["k_max"])
    return plan.k, plan.tile_h, plan.tile_w


@pytest.mark.parametrize("family,case", sorted(PRE_ADDED_CASES), ids=" / ".join)
def test_pre_added_sums_give_the_plain_bits(rng, family, case):
    """The kernel's llin8 and disp phases read the neighbours' pre-added
    sums, fl(dU + U), in place of dU and U: the float each neighbour term of
    the plain version starts from, so the emulation of that order equals
    the plain tile schedule and the plain global solver bit for bit."""
    h, w, iters, nan_names, kw = PRE_ADDED_CASES[family, case]
    if case.startswith("B = 2"):
        t = [torch.from_numpy(x) for x in _batch_fields(rng, family, 2, False)]
    else:
        t = [torch.from_numpy(x) for x in _fields(rng, h, w, FAMILIES[family][0], nan_names)]
    k, tile_h, tile_w = _plan_of(family, h, w, iters, kw)
    got = _pre_added_relax(family, t, iters, k, tile_h, tile_w)
    prepare, sweep = FAMILIES[family][1](1.9)
    _assert_equal(got, tiled.tiled_relax(t, sweep, _n_mut(family), iters, prepare_fn=prepare,
                                         plan_override=(k, (tile_h, tile_w))))
    _assert_equal(got, _plain_global(family, t, iters))


@pytest.mark.parametrize("family", ["disp_llin4", "flow_llin8"])
def test_pre_added_sums_match_pallas_stripe_engine(rng, family):
    """The same emulation against pde_tpu's stripe engine in interpret mode
    (its sweeps add the frozen field before they take the neighbours,
    ``sweeps.py:129, :162``), 48x65, NaN in Cu and Du, 16-row stripes,
    k = 2; within tests/test_kernels.py's atol 2e-6, rtol 1e-5 (ROADMAP
    F3)."""
    names, _, jfactory = FAMILIES[family]
    f = _fields(rng, 48, 65, names, ("cu", "duc"))
    jprep, jsweep = jfactory(1.9)
    n_mut = _n_mut(family)
    want = jtiled_relax(tuple(jnp.asarray(x) for x in f), jsweep, n_mut, 5, prepare_fn=jprep,
                        interpret=True, plan_override=(2, 16))
    got = _pre_added_relax(family, [torch.from_numpy(x) for x in f], 5, 4, 16, 24)
    assert len(got) == len(want) == n_mut
    for g, w_ in zip(got, want):
        g = g.numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w_), atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("sweeps_", [3, 4096])
@pytest.mark.parametrize("double_buffer", [False, True])
@pytest.mark.parametrize("k_max", [1, 4, 8])
@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("h,w", [(1024, 1024), (480, 640), (481, 641)])
def test_plan_tiles(h, w, family, k_max, double_buffer, sweeps_):
    plan = tiled.plan_tiles(h, w, family, sweeps_, k_max, double_buffer=double_buffer)
    assert 1 <= plan.k <= min(k_max, sweeps_)
    # the families that fill the border read one pixel more
    assert tiled._halo_for(family, plan.k) == 2 * plan.k + tiled.LAYOUTS[family].fill
    slot = tiled.slot_bytes(family, plan.k, plan.tile_h, plan.tile_w)
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
    # a window's chunk keeps its k: 64 sweeps give every tile a slot past 254 rows
    assert tiled.plan_tiles(1024, 1024, "flow_llin4", 64, 64, exact_k=True) is None
    assert tiled.tiled_relax(t, sweep, 2, 64, prepare_fn=prepare,
                             window=tiled.whole(20, 30)) is None
    with pytest.raises(ValueError, match="no tile layout"):
        tiled.plan_tiles(1024, 1024, "flow_llin5", 4)


# (family, what is wrong, the error's words): every refusal comes before a
# build or a launch
REFUSALS = {
    "cpu": ("flow_llin4", "cpu", "CUDA"),
    "float64": ("flow_llin4", "float64", "float32"),
    "non-contiguous": ("flow_llin4", "non-contiguous", "contiguous"),
    "count": ("flow_llin4", "count", "takes 13 fields"),
    "disp_llin4 cpu": ("disp_llin4", "cpu", "CUDA"),
    "pde8 float64": ("pde8", "float64", "float32"),
    "flow_llin8 two slots over 227 KB": ("flow_llin8", "two slots", "double_buffer=True"),
    "disp_llin4 double-buffered, three systems": ("disp_llin4", "batch db", "1 to 2 systems"),
    "pde4 a 2-px image (W4)": ("pde4", "small", "H, W >= 3"),
    "pde4 four channels": ("pde4", "batch", "1 to 3 systems"),
    "disp_llin4 three systems": ("disp_llin4", "batch", "1 to 2 systems"),
    "flow_llin8 a batch": ("flow_llin8", "batch", "1 to 1 systems"),
    "pde8 has no window": ("pde8", "window", "no tile kernel window"),
    "pde4 weights a plane a channel": ("pde4", "batch weights", "shared weights"),
    "pde8 weights a plane a channel": ("pde8", "batch weights", "shared weights"),
}


@pytest.mark.parametrize("what", sorted(REFUSALS))
def test_wrapper_refuses_before_building(rng, monkeypatch, what):
    def no_build(*args, **kwargs):
        raise AssertionError("the wrapper must check its inputs before it builds")

    monkeypatch.setattr(build, "load", no_build)
    family, wrong, match = REFUSALS[what]
    names = FAMILIES[family][0]
    h, w = (2, 9) if wrong == "small" else (8, 9)
    dtype = torch.float64 if wrong == "float64" else torch.float32
    fields = [torch.from_numpy(x).to(dtype) for x in _fields(rng, h, w, names)]
    if wrong == "non-contiguous":
        fields[5] = torch.from_numpy(_fields(rng, 9, 8, ("cu",))[0]).t()
    if wrong == "count":
        fields = fields[:-1]
    if wrong == "batch weights":  # two channels, each its own weights
        fields = [x.expand(2, h, w).contiguous() if i in (0, 3) else x
                  for i, x in enumerate(fields)]
    elif wrong.startswith("batch"):
        fields[0] = fields[0].expand(tiled.LAYOUTS[family].max_batch + 1, h, w).contiguous()
    # k = 4 over 64x96 tiles: over the block's 232,448 bytes (llin8: one slot already)
    plan = (4, 64, 96) if wrong == "two slots" else (2, 16, 16)
    before = dict(tiled_cuda.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        if wrong == "window":
            tiled_cuda.tiled_sor_window(family, fields, 2, 1.9, tiled.whole(h, w), 8, 8)
        else:
            tiled_cuda.tiled_sor(family, fields, 4, 1.9, *plan,
                                 double_buffer=wrong in ("two slots", "batch db"))
    assert tiled_cuda.LAUNCHES == before


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_off_cpu_goes_to_the_kernel_or_raises(monkeypatch, family):
    """A tensor off the CPU never takes the plain schedule: a sweep the
    kernel has goes to the wrapper (which refuses a non-CUDA device), any
    other sweep raises."""
    monkeypatch.setattr(tiled, "plain_tiled_relax", None)
    names, factory, _ = FAMILIES[family]
    n_mut = _n_mut(family)
    meta = [torch.empty((16, 16), device="meta") for _ in names]
    prepare, sweep = factory(1.9)
    with pytest.raises(ValueError, match="CUDA"):
        tiled.tiled_relax(meta, sweep, n_mut, 4, prepare_fn=prepare)
    with pytest.raises(ValueError, match="tile kernel runs"):
        tiled.tiled_relax(meta, sweep, n_mut, 4, prepare_fn=factory(1.5)[0])
    with pytest.raises(ValueError, match="tile kernel runs"):
        tiled.tiled_relax(meta, sweep, n_mut, 4, prepare_fn=None)
    other = "pde4" if family != "pde4" else "disp_llin4"
    with pytest.raises(ValueError, match="tile kernel runs"):
        tiled.tiled_relax(meta, sweep, n_mut, 4, prepare_fn=FAMILIES[other][1](1.9)[0])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_cpu_path_and_import_build_nothing(rng, monkeypatch, tmp_path, family):
    def no_build(*args, **kwargs):
        raise AssertionError("nothing may be built on the CPU path")

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "build", no_build)
    monkeypatch.setattr(build, "load", no_build)
    importlib.reload(tiled)
    before = dict(tiled_cuda.LAUNCHES)
    names, factory, _ = FAMILIES[family]
    t = [torch.from_numpy(x) for x in _fields(rng, 20, 21, names)]
    prepare, sweep = factory(1.9)
    _assert_equal(tiled.tiled_relax(t, sweep, _n_mut(family), 3, prepare_fn=prepare,
                                    plan_override=(2, 8)),
                  _plain_global(family, t, 3))
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
    # resident 8-neighbour kernel shares; it includes flow_update.cuh too.
    # The tile kernel includes every family's header
    tile_headers = ["disp_update.cuh", "flow8_update.cuh", "flow_update.cuh", "pde4_update.cuh",
                    "pde8_update.cuh"]
    for source, headers in ((tiled_cuda.SOURCE, tile_headers),
                            ("flow_llin4_sor", ["flow8_update.cuh", "flow_update.cuh"])):
        files = build._with_headers(build.CSRC / f"{source}.cu")
        assert [f.name for f in files] == [f"{source}.cu", *headers]
    path = build.library_path(tiled_cuda.SOURCE)
    assert path.parent == build.BUILD_DIR and path.name.startswith("libtiled_sor_")


# ---------------------------------------------------------------------------
# the redesigned kernel's plan and the dispatch's route
# ---------------------------------------------------------------------------

# (family, (h, w), systems or channels, where the dispatch sends it): phase
# 16's shapes of chip_smoke.py and the main path's (PERF.md §7: the shapes
# without a resident plan)
ROUTES = {
    "llin4 1024x1024": ("llin4", (1024, 1024), 1, "tiled"),
    "llin4 768x768": ("llin4", (768, 768), 1, "tiled"),
    "elin4 1024x1024": ("elin4", (1024, 1024), 1, "tiled"),
    "elin4 768x768": ("elin4", (768, 768), 1, "tiled"),
    "llin4 480x640": ("llin4", (480, 640), 1, "resident"),
    "elin4 480x640": ("elin4", (480, 640), 1, "resident"),
    "llin8 1024x1024": ("llin8", (1024, 1024), 1, "tiled"),
    "disp 1024x1024": ("disp", (1024, 1024), 1, "tiled"),
    "disp 1024x1024, the symmetric pair": ("disp", (1024, 1024), 2, "tiled"),
    "disp 480x640, the symmetric pair": ("disp", (480, 640), 2, "resident"),
    "pde4 1024x1024, C = 3": ("pde4", (1024, 1024), 3, "tiled"),
    "pde4 481x641, C = 3": ("pde4", (481, 641), 3, "tiled"),
    "pde4 576x576, C = 3": ("pde4", (576, 576), 3, "tiled"),
    "pde4 768x768, C = 3": ("pde4", (768, 768), 3, "tiled"),
    "pde4 480x640, C = 3": ("pde4", (480, 640), 3, "resident"),
    "pde4 1024x1024, C = 1": ("pde4", (1024, 1024), 1, "tiled"),
    "pde4 481x641, C = 2": ("pde4", (481, 641), 2, "tiled"),
    "pde8 1024x1024, C = 3": ("pde8", (1024, 1024), 3, "tiled"),
    "pde8 768x768, C = 3": ("pde8", (768, 768), 3, "tiled"),
    "pde8 576x576, C = 3": ("pde8", (576, 576), 3, "resident"),
    # the tile kernel measured faster than the global one there (PERF.md)
    "pde8 481x641, C = 3": ("pde8", (481, 641), 3, "tiled"),
    "pde8 480x640, C = 3": ("pde8", (480, 640), 3, "resident"),
    "pde8 1024x1024, C = 1": ("pde8", (1024, 1024), 1, "tiled"),
    "pde8 481x641, C = 2": ("pde8", (481, 641), 2, "tiled"),
    # W4: an image under 3 px stays with the global kernels
    "pde4 2x5000": ("pde4", (2, 5000), 1, "global"),
    "disp 5000x2, the symmetric pair": ("disp", (5000, 2), 2, "global"),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_sor_route_from_the_shape(case):
    family, (h, w), batch, want = ROUTES[case]
    route, plan = dispatch.sor_route(family, h, w, batch, 4, 132)
    assert route == want
    if route == "tiled":
        tile_family = dispatch.TILE_FAMILY[family]
        assert plan == tiled.plan_tiles(h, w, tile_family, 4, 4, sm_count=132, batch=batch)
        layout = tiled.LAYOUTS[tile_family]
        # a pde block holds every channel of its tile: its blocks are the tiles
        assert plan.k == 4 and layout.blocks(plan.n_tiles_h * plan.n_tiles_w, batch) >= 132
        # a batch the kernel does not take goes to the global kernel
        too_many = tiled.LAYOUTS[tile_family].max_batch + 1
        assert dispatch.sor_route(family, h, w, too_many, 4, 132)[0] == "global"
    elif route == "resident":
        assert plan == resident_cuda.plan_resident(h, w, family, batch, 132)
    else:
        assert plan is None


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
    monkeypatch.setattr(tiled_cuda, "tiled_sor", tile_spy)
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


def _meta(names, shape, batched=()):
    """Meta tensors (no data) of the fields ``names``: (h, w), the names in
    ``batched`` with a leading dimension of ``shape[0]``."""
    return [torch.empty(shape if n in batched else shape[-2:], device="meta") for n in names]


# (dispatch entry, the tile kernel's family, its fields' shape, the fields
# with a batch): one shape without a resident plan each
DISPATCHES = {
    "sor_flow_llin8": ("flow_llin8", (1024, 1024), ()),
    "sor_disp_llin4": ("disp_llin4", (1024, 1024), ()),
    "sor_disp_llin4, a batch of 2": ("disp_llin4", (2, 1024, 1024),
                                     tiled_cuda.FIELD_NAMES["disp_llin4"]),
    "sor_pde4": ("pde4", (3, 481, 641), ("x", "trace", "b")),
    "sor_pde8": ("pde8", (3, 481, 641), ("x",)),
}


@pytest.mark.parametrize("case", sorted(DISPATCHES))
def test_dispatch_sends_the_other_families_to_the_tile_kernel(monkeypatch, case):
    """Off the CPU, llin8, disp and pde solves whose shape has no resident
    plan go to the tile wrapper with the route's plan, their fields in the
    kernel's order, chosen before any launch; neither the resident nor the
    global kernel is called."""
    family, shape, batched = DISPATCHES[case]
    names = tiled_cuda.FIELD_NAMES[family]
    seen = []

    def tile_spy(fam, fields, iters, omega, k, tile_h, tile_w, double_buffer=False, slots=None):
        seen.append((fam, tuple(fields), iters, k, tile_h, tile_w, slots))
        return tuple(fields[:tiled.LAYOUTS[fam].n_mut])

    def refuse(*args, **kwargs):
        raise AssertionError("the shape has a tile plan: no other kernel may run")

    monkeypatch.setattr(resident_cuda, "sm_count", lambda index: 132)
    monkeypatch.setattr(tiled_cuda, "tiled_sor", tile_spy)
    for mod in (sor_cuda, resident_cuda, interior_cuda):
        for name in ("flow_llin8_sor", "disp_llin4_sor", "pde4_sor", "pde8_sor"):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, refuse)
    meta = _meta(names, shape, batched)
    by_name = dict(zip(names, meta))
    entry = case.split(",")[0]
    solver = {"sor_flow_llin8": "llin8", "sor_disp_llin4": "disp", "sor_pde4": "pde4",
              "sor_pde8": "pde8"}[entry]
    if entry == "sor_flow_llin8":
        args = [by_name[n] for n in ("u", "v", "du", "dv")] + meta[4:]
    elif entry == "sor_disp_llin4":
        args = [by_name["u"], by_name["du"]] + meta[2:]
    else:
        args = meta
    getattr(dispatch, entry)(*args, 9, 1.9)
    batch = shape[0] if len(shape) == 3 else 1
    plan = dispatch.sor_route(solver, *shape[-2:], batch, 9, 132)[1]
    assert seen == [(family, tuple(meta), 9, 4, plan.tile_h, plan.tile_w, plan.slots)]


def test_dispatch_sends_the_symmetric_pair_to_the_tile_kernel_unstacked(monkeypatch):
    """disparity_sym's pair at 1024x1024 (no resident plan) is one tile
    launch of two systems, each its own planes: never stacked."""
    seen = []

    def systems_spy(family, systems, iters, omega, k, tile_h, tile_w, slots=None):
        seen.append((family, [tuple(s) for s in systems], iters, k, tile_h, tile_w, slots))
        return [(s[0],) for s in systems]

    def refuse(*args, **kwargs):
        raise AssertionError("the pair has a tile plan: no other kernel, and no stack")

    monkeypatch.setattr(resident_cuda, "sm_count", lambda index: 132)
    monkeypatch.setattr(tiled_cuda, "tiled_sor_systems", systems_spy)
    for mod, name in ((interior_cuda, "disp_llin4_sor"), (resident_cuda, "disp_llin4_pair"),
                      (torch, "stack")):
        monkeypatch.setattr(mod, name, refuse)
    names = tiled_cuda.FIELD_NAMES["disp_llin4"]
    pair = [_meta(names, (1024, 1024)) for _ in range(2)]
    by_name = [dict(zip(names, p)) for p in pair]
    args = [x for b in by_name for x in [b["u"], b["du"], *[b[n] for n in names[2:]]]]
    out0, out1 = dispatch.sor_disp_llin_sym4(*args, 9, 1.9)
    plan = dispatch.sor_route("disp", 1024, 1024, 2, 9, 132)[1]
    assert seen == [("disp_llin4", [tuple(p) for p in pair], 9, 4, plan.tile_h, plan.tile_w,
                     plan.slots)]
    assert out0 is pair[0][0] and out1 is pair[1][0]


# (the array (h, w), the window's box, or None for the whole array; the
# plan's tile and pairs a thread, without and with a border fill, whose
# 2k + 1 halo gives the 16x48 tile more pairs)
PLAN_SHAPES = {
    "1024x1024": ((1024, 1024), None, (16, 48, 2), (16, 48, 3)),
    "a 240x320 shard and its 8-px halo (2x2 mesh over 480x640)":
        ((248, 328), (0, 240, 0, 320), (16, 24, 2), (16, 24, 2)),
    "a 480x160 shard and its halo (1x4 mesh over 480x640)":
        ((480, 168), (0, 480, 0, 160), (16, 24, 2), (16, 24, 2)),
    "a 180x240 shard and its halo (2x2 mesh over 360x480)":
        ((188, 248), (0, 180, 0, 240), (8, 24, 1), (8, 24, 2)),
}
# the whole 1024x1024 image's plan of the families that hold one block an
# SM at 3 pairs a thread, by channels a block: a taller first tile, for a
# pde4 block of 2 or 3 channels a taller one still; disp's 40x32 at 4 pairs,
# two blocks an SM (scripts/tiled_plan_sweep.py, PERF.md)
PLAN_1024 = {"flow_llin8": {1: (32, 48, 3)}, "pde8": dict.fromkeys((1, 2, 3), (40, 32, 3)),
             "pde4": {1: (32, 32, 3), 2: (40, 32, 3), 3: (40, 32, 3)},
             "disp_llin4": {1: (40, 32, 4)}}
# llin8 at the shards, planned among all its plans (tiled.ANY_BLOCKS): one
# round of the card's SMs of the fewest slot pixels, under a block an SM
PLAN_SHARDS_LLIN8 = {"a 240x320 shard and its 8-px halo (2x2 mesh over 480x640)": (24, 32, 2),
                     "a 480x160 shard and its halo (1x4 mesh over 480x640)": (24, 32, 2),
                     "a 180x240 shard and its halo (2x2 mesh over 360x480)": (16, 24, 2)}
# the families, and pde4 and pde8 with a batch of channels (one block a tile
# for all of them: the plan's blocks are its tiles)
PLAN_FAMILIES = sorted(FAMILIES) + [f"{f} C={c}" for f in ("pde4", "pde8") for c in (2, 3)]


@pytest.mark.parametrize("double_buffer", [False, True])
@pytest.mark.parametrize("family", PLAN_FAMILIES)
@pytest.mark.parametrize("case", sorted(PLAN_SHAPES))
def test_plan_fills_the_card(case, family, double_buffer):
    (h, w), box, want, want_fill = PLAN_SHAPES[case]
    family, _, channels = family.partition(" C=")
    batch = int(channels or 1)
    bh, bw = (h, w) if box is None else (box[1] - box[0], box[3] - box[2])
    plan = tiled.plan_tiles(bh, bw, family, 4, 4, double_buffer=double_buffer,
                            exact_k=box is not None, sm_count=132, batch=batch)
    assert plan.k == 4
    if family not in tiled.ANY_BLOCKS:
        assert plan.n_tiles_h * plan.n_tiles_w >= 132  # a block an SM at least
    assert tiled.LAYOUTS[family].blocks(plan.n_tiles_h * plan.n_tiles_w, batch) == (
        plan.n_tiles_h * plan.n_tiles_w)
    assert plan.smem_bytes == (2 if double_buffer else 1) * tiled.slot_bytes(
        family, 4, plan.tile_h, plan.tile_w, batch) <= tiled.SMEM_PER_BLOCK
    assert plan.threads == tiled.block_threads(family, 4, plan.tile_h, plan.tile_w, plan.slots)
    assert plan.threads <= tiled.max_threads(family, plan.slots) and plan.threads % 32 == 0
    # 16x48 tiles give a shard fewer blocks than SMs (105, 120, 60)
    if box is None and family in PLAN_1024:
        want = PLAN_1024[family][batch]
        if (family, batch, double_buffer, want[2]) in tiled.SPILLS:
            want = want[:2] + (want[2] + 1,)  # the next pairs a thread, whose kernel does not spill
    elif family == "flow_llin8":
        want = PLAN_SHARDS_LLIN8[case]
    elif tiled.LAYOUTS[family].fill:
        want = want_fill
    assert (plan.tile_h, plan.tile_w, plan.slots) == want
    assert plan.threads <= tiled.PLAN_THREADS  # two blocks an SM
    rows, hc = tiled._slot_dims(family, 4, plan.tile_h, plan.tile_w)
    assert plan.threads * plan.slots >= rows * hc  # every pair of the slot owned


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("k", [6, 8, 9])
def test_plan_of_a_long_window_chunk_takes_smaller_tiles(k, family):
    """A window's chunk of more than 4 sweeps keeps its k (exact_k): its
    halo gives 16x48 tiles more pairs than a block holds, so the plan takes
    a smaller tile or more pairs a thread, which the kernel takes."""
    plan = tiled.plan_tiles(240, 320, family, k, k, exact_k=True, sm_count=132)
    assert plan.k == k
    # llin8: its own 24x32 (tiled.FIRST_TILES) while its slot fits a block
    assert (plan.tile_h, plan.tile_w) in tiled.TILES[1:] + tiled.FIRST_TILES.get(family, ())[1:]
    assert plan.threads <= tiled.max_threads(family, plan.slots)
    assert plan == tiled.make_plan(240, 320, family, k, plan.tile_h, plan.tile_w, plan.slots)


# (family, k, tile_h, tile_w, bytes[, channels]): two float32 planes (one a
# colour) of each field neighbours read (two a colour of an 8-neighbour
# family's relaxed fields), over the tile and its 2k halo (2k + 1 with a
# border fill), 16-byte rounded; pde4 and pde8 a set of them a channel;
# llin8 two of each field and four of each relaxed field's sum with its
# frozen field, which the neighbours read
SLOT_BYTES = {
    "llin4 32x48, k=4": ("flow_llin4", 4, 32, 48, 4 * 2 * 4 * 48 * 32),
    "elin4 32x48, k=4": ("flow_elin4", 4, 32, 48, 4 * 2 * 2 * 48 * 32),
    "llin4 odd 7x9, k=3": ("flow_llin4", 3, 7, 9, 4 * 2 * 4 * 19 * 11),
    "elin4 1x1, k=1": ("flow_elin4", 1, 1, 1, 4 * 2 * 2 * 5 * 3),
    "disp 32x48, k=4 (dU, U)": ("disp_llin4", 4, 32, 48, 4 * 2 * 2 * 50 * 33),
    "pde4 32x48, k=4 (X)": ("pde4", 4, 32, 48, 4 * 2 * 1 * 50 * 33),
    "llin8 32x48, k=4 (dU, dV twice, U, V)": ("flow_llin8", 4, 32, 48, 4 * 2 * 8 * 48 * 32),
    "pde8 32x48, k=4 (X twice)": ("pde8", 4, 32, 48, 4 * 2 * 2 * 50 * 33),
    "pde8 odd 7x9, k=1, 16-byte rounded": ("pde8", 1, 7, 9, 4 * 4 * 13 * 8),
    "disp 32x48, k=4, B = 2 (a system a block)": ("disp_llin4", 4, 32, 48, 4 * 2 * 2 * 50 * 33, 2),
    **{f"{family} 32x48, k=4, C = {c}": (family, 4, 32, 48, 4 * 2 * bufs * 50 * 33 * c, c)
       for family, bufs in (("pde4", 1), ("pde8", 2)) for c in (2, 3)},
    "pde8 odd 7x9, k=1, C = 3": ("pde8", 1, 7, 9, 4 * 3 * 4 * 13 * 8, 3),
    "pde4 odd 7x7, k=1, C = 3, 16-byte rounded": ("pde4", 1, 7, 7, 4 * 548, 3),  # 6 x 13 x 7
}


@pytest.mark.parametrize("case", sorted(SLOT_BYTES))
def test_slot_bytes_of_the_colour_split_layout(case):
    family, k, th, tw, want, *batch = SLOT_BYTES[case]
    batch = batch[0] if batch else 1
    assert tiled.slot_bytes(family, k, th, tw, batch) == want
    if batch == 1:
        assert tiled.slot_bytes(family, k, th, tw) == want
    # the old layout, every field and a flag byte a pixel, took 53 (45) B a pixel
    halo = tiled._halo_for(family, k)
    px = (th + 2 * halo) * (tw + 2 * halo)
    assert tiled.slot_bytes(family, k, th, tw, batch) < (
        tiled.LAYOUTS[family].fields * 4 + 1) * px * batch


@pytest.mark.parametrize("double_buffer", [False, True])
@pytest.mark.parametrize("batch", [1, 2, 3])
def test_plan_takes_no_kernel_that_spills(batch, double_buffer):
    """pde8's double-buffered kernel with 3 channels at 3 pairs a thread
    spills registers (the compiler's report on the H100): a plan of its own
    choice takes 4 pairs there, and the serial form and fewer channels keep
    3; a plan asked for 3 pairs gets them."""
    plan = tiled.plan_tiles(1024, 1024, "pde8", 4, 4, double_buffer=double_buffer,
                            sm_count=132, batch=batch)
    spills = ("pde8", batch, double_buffer, 3) in tiled.SPILLS
    assert spills == (batch == 3 and double_buffer)
    assert (plan.tile_h, plan.tile_w, plan.slots) == (40, 32, 4 if spills else 3)
    assert tiled.make_plan(1024, 1024, "pde8", 4, 40, 32, double_buffer=double_buffer,
                           batch=batch).slots == plan.slots
    assert tiled.make_plan(1024, 1024, "pde8", 4, 40, 32, 3, double_buffer, batch).slots == 3


def test_plan_refuses_what_the_kernel_does_not_take():
    assert tiled.make_plan(64, 64, "flow_llin4", 4, 300, 16) is None          # rows past 254
    assert tiled.make_plan(64, 64, "flow_llin4", 4, 16, 600) is None          # half-columns past 255
    assert tiled.make_plan(64, 64, "flow_llin4", 4, 64, 96, slots=1) is None  # too many threads
    plan = tiled.make_plan(64, 64, "flow_llin4", 4, 16, 24)
    assert plan.slots == 1 and plan.threads == tiled.block_threads("flow_llin4", 4, 16, 24, 1)
    # the border fill's halo pixel: 16x24 takes a second pair a thread
    plan = tiled.make_plan(64, 64, "pde4", 4, 16, 24)
    assert plan.slots == 1 and plan.threads == tiled.block_threads("pde4", 4, 16, 24, 1) == 736
    for family in tiled.LAYOUTS:  # every family has the two-slot kernel
        plan = tiled.make_plan(64, 64, family, 4, 16, 24, double_buffer=True)
        slot = tiled.slot_bytes(family, 4, 16, 24)
        assert plan == tiled.make_plan(64, 64, family, 4, 16, 24)._replace(smem_bytes=2 * slot)
        assert plan.smem_bytes == 2 * slot <= tiled.SMEM_PER_BLOCK
    # two slots over a block's shared memory, where one fits
    slot = tiled.slot_bytes("flow_llin8", 4, 48, 64)
    assert slot <= tiled.SMEM_PER_BLOCK < 2 * slot
    assert tiled.make_plan(64, 64, "flow_llin8", 4, 48, 64, slots=4, double_buffer=True) is None
    # disp holds two blocks an SM at 3 and 4 pairs within 384 threads
    assert tiled.make_plan(64, 64, "disp_llin4", 4, 32, 32, slots=3) is None
    assert tiled.make_plan(64, 64, "disp_llin4", 4, 32, 32, slots=4).threads == 320


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
        got = tiled.tiled_relax(t, sweep, _n_mut(family), iters, prepare_fn=prepare,
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
    halo = tiled._halo_for(family, k)
    r0, r1 = max(0, R0 - halo), min(gh, R1 + halo)
    c0, c1 = max(0, C0 - halo), min(gw, C1 + halo)
    window = tiled.Window(r0, c0, gh, gw, (R0 - r0, R1 - r0, C0 - c0, C1 - c0))
    prepare, sweep = factory(1.9)
    kw = {} if tile is None else dict(plan_override=(k, tile))
    got = tiled.tiled_relax([x[r0:r1, c0:c1] for x in t], sweep, _n_mut(family), k,
                            prepare_fn=prepare, window=window, **kw)
    _assert_equal(tuple(got), tuple(x[R0:R1, C0:C1] for x in want))


@pytest.mark.parametrize("family", ["flow_llin4", "flow_elin4"])
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
