"""Temporally blocked tile engine, after ``pde_tpu/kernels/tiled.py``.

A chunk of ``k`` red-black sweeps runs tile by tile: each tile is read
with a halo of ``2k`` pixels on every side (clamped at the image edge),
relaxed ``k`` times on its own, and only its interior is kept. A sweep has
dependency radius 2 (colour 0 reads old neighbours, colour 1 the new
colour 0), so the kept interior is exactly what ``k`` global sweeps give.
The coefficient planes are then read once per ``k`` sweeps instead of once
per colour. Each chunk reads one state and writes another, since a
neighbouring tile's halo must see the state at the start of the chunk.

On the card, ``tiled_relax`` runs the kernel of ``csrc/tiled_sor.cu``
(``kernels/tiled_cuda.py``) for the six sweep families of
``kernels/sweeps.py``, ``LAYOUTS``: flow_llin4, flow_elin4, disp_llin4,
pde4, flow_llin8 and pde8. One launch a chunk, one block a tile (and
disp system; a pde4 or pde8 block relaxes every channel of its tile over
weights it reads once), serial, or double-buffered (persistent blocks that
copy the next tile's neighbour planes in under the current one's
sweeps). ``kernels/dispatch.py`` sends it every solve whose
shape has no resident plan and that ``plan_tiles`` plans at
``k_max = 4``. On CPU tensors, or under ``dispatch.plain_solvers()``, it
runs the same tile schedule in torch ops: the plain version, which
CPU-tests the tile and halo indexing as ``pde_tpu``'s Pallas kernels run
in interpret mode. A CUDA tensor goes to the kernel or raises.

The interior-update families (disp_llin4, pde4, pde8) fill the 1-px
border after every sweep from the pixel one step inward, so a tile's
border pixels need their sources relaxed as far as the tile: their halo
is ``2k + 1``, and every colour phase reaches one pixel further.

A ``Window`` runs one chunk over part of an image instead: the fields are
a shard of ``parallel/tiled.py`` and the 2k halo its neighbours gave it,
clipped to the image; colours, the interior and the edges come from the
image's coordinates, and only the tiles covering the shard (the window's
box) are relaxed and returned. On the card that is the windowed variant
of the same kernel.

The plan and the kernel agree on the layout (``LAYOUTS``): a block's
threads own fixed pairs of pixels of the slot (tile plus halo), ``slots``
pairs a thread, and keep their coefficients in registers; shared memory
holds only the fields neighbours read (dU, dV, U, V for llin4, U, V for
elin4, dU, U for disp, X for pde4 and pde8), one float32 plane per colour
each, two a colour for pde8's X (a diagonal neighbour has the pixel's own
colour). llin8 keeps dU, dV, U, V a plane a colour and, for the
neighbours, two a colour of each relaxed field's sum with its frozen field,
fl(dU + U) and fl(dV + V), which the plain sweep's neighbour terms start
from: a neighbour is one read, not two (``Layout.pre``). pde4
and pde8 keep a set of planes a channel, so a slot, and a plan's shared
memory, grow with the channels (``slot_bytes(..., batch)``), and a plan's
blocks are its tiles.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Sequence

import torch

from pde_tpu_torch.core.grid import replicate_border
from pde_tpu_torch.kernels import plain_mode, resident_cuda, tiled_cuda
from pde_tpu_torch.kernels.sweeps import TileAux

# dependency radius of one full red-black sweep
RB_RADIUS = 2
# dynamic shared memory one block of an H100 may take (227 KB)
SMEM_PER_BLOCK = 232_448
SM_COUNT = resident_cuda.SM_COUNT  # the plans' default; a card's own where it runs


class Layout(NamedTuple):
    """A family's layout in the tile kernel (``csrc/tiled_sor.cu``)."""

    index: int      # the kernel's family index
    fields: int     # fields, the relaxed first (``tiled_cuda.FIELD_NAMES``)
    n_mut: int      # relaxed fields
    nbr: int        # fields neighbours read (the relaxed first), in shared memory
    bufs: int       # buffers a colour of a relaxed field: 2 where a diagonal
    # neighbour has the pixel's own colour (the 8-neighbour families)
    fill: int       # 1 where the border is filled after each sweep: a halo pixel more
    max_batch: int  # systems (disp) or channels (pde4, pde8) a launch
    block_batch: bool = False  # a block holds every channel of its tile (pde4,
    # pde8, over weights the channels share), else one system (disp's along the grid)
    pre: bool = False  # neighbours read each relaxed field pre-added to its
    # frozen field, fl(dU + U) (llin8), kept beside the fields themselves

    @property
    def smem_planes(self) -> int:
        """Float planes of a slot for one system or channel: two colours of
        each neighbour field, the relaxed fields' ``bufs`` a colour; with
        ``pre``, two colours of every field and ``bufs`` a colour of each
        relaxed field's sum."""
        if self.pre:
            return 2 * (self.n_mut * self.bufs + self.nbr)
        return 2 * (self.n_mut * self.bufs + self.nbr - self.n_mut)

    def slot_sets(self, batch: int) -> int:
        """Sets of ``smem_planes`` a slot holds for a launch of ``batch``
        systems or channels: one a channel where a block holds them all."""
        return batch if self.block_batch else 1

    def blocks(self, tiles: int, batch: int) -> int:
        """Blocks of a launch of ``batch`` systems over ``tiles`` tiles
        (the items of the double-buffered form)."""
        return tiles if self.block_batch else tiles * batch

    @property
    def coef_planes(self) -> int:
        """Fields only the owning pixel reads (into registers)."""
        return self.fields - self.nbr


LAYOUTS = {
    "flow_llin4": Layout(0, 13, 2, 4, 1, 0, 1),
    "flow_elin4": Layout(1, 11, 2, 2, 1, 0, 1),
    "disp_llin4": Layout(2, 8, 1, 2, 1, 1, 2),
    "pde4": Layout(3, 7, 1, 1, 1, 1, 3, True),
    "flow_llin8": Layout(4, 17, 2, 4, 2, 0, 1, pre=True),
    "pde8": Layout(5, 11, 1, 1, 2, 1, 3, True),
}
# threads a block at most, by pairs of pixels a thread (the kernel's
# max_threads: llin4 and elin4 at 2 pairs are compiled for two blocks an SM,
# disp at 2 to 4 pairs, within 384 threads at 3 and 4 pairs)
MAX_THREADS = {1: 768, 2: 512, 3: 512, 4: 384}
FAMILY_MAX_THREADS = {"disp_llin4": {1: 768, 2: 512, 3: 384, 4: 384}}
# a slot's rows and half-columns at most (8 bits each in the kernel's word)
_MAX_ROWS = 254
_MAX_HALF_COLS = 255
# the tiles a plan takes (scripts/tiled_plan_sweep.py on the H100,
# PERF.md): 16x48 measured fastest at every swept shape for llin4 and
# elin4; the smaller ones give a small level or shard a block an SM.
# llin8, pde8 and pde4, whose kernels hold one block an SM at the plan's
# pairs a thread, measured fastest with taller tiles first, and so did disp
# at 4 pairs, two blocks an SM (PERF.md); a pde4 block of several channels
# with a taller one still
TILES = ((16, 48), (16, 24), (8, 24), (8, 16))
FIRST_TILES = {"flow_llin8": ((32, 48), (24, 32)), "disp_llin4": ((40, 32),),
               "pde8": ((40, 32),), "pde4": ((32, 32),)}
FIRST_TILES_CHANNELS = {"pde4": ((40, 32),)}
# the families planned among all their plans, not only those of a block an
# SM at least: llin8's blocks hold an SM each, so a 240x320 shard's 100
# tiles of 24x32 take one round of the card where 210 of 16x24 take two
# (measured 0.68x the time; PERF.md)
ANY_BLOCKS = {"flow_llin8"}
# the kernels that spill registers, by the compiler's report on the H100
# (scripts/tiled_plan_sweep.py prints it first): (family, channels a block,
# double-buffered, pairs a thread). A plan that chooses its pairs a thread
# takes more there; an explicit ``slots`` is taken as asked.
SPILLS = {("pde8", 3, True, 3)}
# threads a block at most in a plan, so that two blocks share an SM (at 64
# registers a thread): one block's loads and prepare overlap the other's
# sweeps
PLAN_THREADS = 512


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _fill(family) -> int:
    """1 for a family that fills the border after each sweep, else 0 (a
    sweep of no family: none)."""
    layout = LAYOUTS.get(family)
    return layout.fill if layout is not None else 0


def _halo_for(family: str, k: int) -> int:
    """Halo of a chunk of ``k`` sweeps of ``family``: 2k, and one pixel
    more where the border is filled. The kernel copies 4-byte words, so no
    alignment rounding is needed."""
    return RB_RADIUS * k + _fill(family)


def max_threads(family: str, slots: int) -> int | None:
    """Threads a block of ``family`` at ``slots`` pairs a thread at most;
    ``None`` for pairs the kernel does not take."""
    return FAMILY_MAX_THREADS.get(family, MAX_THREADS).get(slots)


def _pairs_to_choose(family: str, batch: int, double_buffer: bool) -> list[int]:
    """The pairs a thread a plan may choose: those whose kernel does not
    spill (``SPILLS``)."""
    channels = LAYOUTS[family].slot_sets(batch)
    return [s for s in sorted(MAX_THREADS) if (family, channels, double_buffer, s) not in SPILLS]


def _slot_dims(family: str, k: int, tile_h: int, tile_w: int) -> tuple[int, int]:
    """A slot's rows and half-columns (pairs a row)."""
    halo = _halo_for(family, k)
    return tile_h + 2 * halo, (tile_w + 2 * halo + 1) // 2


def slot_bytes(family: str, k: int, tile_h: int, tile_w: int, batch: int = 1) -> int:
    """Shared memory of one slot of a launch of ``batch`` systems or
    channels: the family's float32 planes (a colour each of every field
    neighbours read, two a colour of an 8-neighbour family's relaxed
    fields; pde4 and pde8 a set a channel) over the tile and its halo,
    rounded to 16 bytes (the kernel's ``slot_floats``)."""
    rows, hc = _slot_dims(family, k, tile_h, tile_w)
    layout = LAYOUTS[family]
    return 4 * _round_up(layout.smem_planes * layout.slot_sets(batch) * rows * hc, 4)


def block_threads(family: str, k: int, tile_h: int, tile_w: int, slots: int) -> int:
    """Threads a block: every pair of the slot owned, ``slots`` a thread,
    rounded up to a warp (the kernel's ``block_threads``)."""
    rows, hc = _slot_dims(family, k, tile_h, tile_w)
    return _round_up(-(-rows * hc // slots), 32)


class TilePlan(NamedTuple):
    k: int
    tile_h: int
    tile_w: int
    n_tiles_h: int
    n_tiles_w: int
    smem_bytes: int  # per block: one slot, or two when double-buffered
    slots: int    # pairs of pixels a thread
    threads: int  # a block's


def make_plan(h: int, w: int, family: str, k: int, tile_h: int, tile_w: int,
              slots: int | None = None, double_buffer: bool = False,
              batch: int = 1) -> TilePlan | None:
    """The plan of ``k`` sweeps of ``family`` a chunk over ``tile_h`` x
    ``tile_w`` tiles of an (h, w) box for ``batch`` systems or channels,
    ``slots`` pairs a thread (by default the fewest that keep a block within
    ``max_threads`` and whose kernel does not spill), one slot or, when
    ``double_buffer``, two; ``None`` if the kernel does not take it."""
    rows, hc = _slot_dims(family, k, tile_h, tile_w)
    if k < 1 or tile_h < 1 or tile_w < 1 or rows > _MAX_ROWS or hc > _MAX_HALF_COLS:
        return None
    smem = (2 if double_buffer else 1) * slot_bytes(family, k, tile_h, tile_w, batch)
    if smem > SMEM_PER_BLOCK:
        return None
    for s in [slots] if slots is not None else _pairs_to_choose(family, batch, double_buffer):
        limit = max_threads(family, s)
        threads = block_threads(family, k, tile_h, tile_w, s) if limit else None
        if threads is not None and threads <= limit:
            return TilePlan(k, tile_h, tile_w, math.ceil(h / tile_h), math.ceil(w / tile_w),
                            smem, s, threads)
    return None


@functools.lru_cache(maxsize=256)
def plan_tiles(h: int, w: int, family: str, sweeps: int, k_max: int = 4,
               double_buffer: bool = False, exact_k: bool = False,
               sm_count: int = SM_COUNT, batch: int = 1):
    """Choose the temporal block ``k`` and the 2-D tile for an (h, w)
    problem of ``family`` (``LAYOUTS``), ``batch`` systems or channels a
    launch, on a card of ``sm_count`` SMs; ``None`` when no plan fits.

    k is ``min(k_max, sweeps)`` (less only where no tile fits; ``exact_k``,
    a window's chunk, never less). Each tile of ``TILES`` (after the
    family's ``FIRST_TILES``, or for a batch of channels its
    ``FIRST_TILES_CHANNELS``; each cut to the image rounded up to 8) takes
    the fewest pairs a thread that keep a block within ``PLAN_THREADS``
    and the kernel's ``max_threads`` (and whose kernel does not spill,
    ``SPILLS``).
    Among the plans of at least ``sm_count`` blocks (``Layout.blocks``:
    tiles times ``batch`` for disp, the tiles for pde4 and pde8, whose block
    holds every channel), a block an SM (a 240x320 shard, a 1024x1024
    level), or among all where the image has too few pixels for that or the
    family is in ``ANY_BLOCKS``, the plan is the one whose SMs work through
    the fewest slot pixels (blocks an SM times a tile and its halo): 16x48
    at 1024x1024 and 768x768 (llin8 32x48, disp 40x32 at 4 pairs, pde8
    40x32, pde4 32x32, or 40x32 for 2 or 3 channels), 16x24 at a 240x320
    shard (llin8 24x32), 8x24 or 8x16 at the smaller shards of a mesh
    frame.
    """
    if family not in LAYOUTS:
        raise ValueError(f"no tile layout for {family!r}; there are {sorted(LAYOUTS)}")
    layout = LAYOUTS[family]
    k_top = max(1, min(k_max, sweeps))
    hi_h, hi_w = _round_up(h, 8), _round_up(w, 8)

    def blocks(p: TilePlan) -> int:
        return layout.blocks(p.n_tiles_h * p.n_tiles_w, batch)

    def slot_pixels_an_sm(p: TilePlan) -> int:
        rows, hc = _slot_dims(family, p.k, p.tile_h, p.tile_w)
        return math.ceil(blocks(p) / sm_count) * rows * 2 * hc

    for k in [k_top] if exact_k else range(k_top, 0, -1):
        plans = []
        first = FIRST_TILES_CHANNELS.get(family) if batch > 1 else None
        for th, tw in (first or FIRST_TILES.get(family, ())) + TILES:
            th, tw = min(th, hi_h), min(tw, hi_w)
            slots = next((s for s in _pairs_to_choose(family, batch, double_buffer)
                          if block_threads(family, k, th, tw, s)
                          <= min(PLAN_THREADS, max_threads(family, s))), None)
            plan = (make_plan(h, w, family, k, th, tw, slots, double_buffer, batch)
                    if slots is not None else None)
            if plan is not None:
                plans.append(plan)
        if plans:
            full = [p for p in plans if blocks(p) >= sm_count and family not in ANY_BLOCKS]
            return min(full or plans, key=lambda p: (slot_pixels_an_sm(p), -p.tile_h * p.tile_w))
    return None


def bytes_per_pixel_iter(plan: TilePlan, family: str) -> float:
    """Device-memory bytes a pixel-iteration of one system moves under
    ``plan``: the neighbour fields over the slot and the coefficient planes
    over the pixels the chunk relaxes (the halo re-read by the neighbouring
    tiles), and the relaxed fields of the interior written, once per k
    sweeps."""
    layout = LAYOUTS[family]
    halo = _halo_for(family, plan.k)
    slot = (plan.tile_h + 2 * halo) * (plan.tile_w + 2 * halo)
    live = (plan.tile_h + 2 * halo - 2) * (plan.tile_w + 2 * halo - 2)
    return ((layout.nbr * slot + layout.coef_planes * live) * 4 / (plan.tile_h * plan.tile_w)
            + layout.n_mut * 4) / plan.k


class Window(NamedTuple):
    """Where the array lies in an image, for a chunk over part of it: the
    array is the rectangle ``[r0, r0 + H) x [c0, c0 + W)`` of a ``gh`` x
    ``gw`` image (a shard and the halo it was given, clipped to the image),
    and only the tiles covering ``box = (i0, i1, j0, j1)``, in the array's
    coordinates, are relaxed and written. Colours, the interior and the
    edges come from the image's coordinates."""

    r0: int
    c0: int
    gh: int
    gw: int
    box: tuple


def whole(h: int, w: int) -> Window:
    """The window of an array that is the whole image."""
    return Window(0, 0, h, w, (0, h, 0, w))


def check_window(shape, window: Window, k: int, family=None) -> None:
    """Raise unless the box lies in the array, the array in the image, and
    the box keeps the halo of a chunk of ``k`` sweeps of ``family`` (2k, or
    2k + 1 with a border fill) of the array, or the image's edge, on each
    side (what such a chunk reads)."""
    h, w = shape
    i0, i1, j0, j1 = window.box
    halo = _halo_for(family, k)
    if not (0 <= i0 < i1 <= h and 0 <= j0 < j1 <= w):
        raise ValueError(f"window box {window.box} is not a non-empty box of the {h}x{w} array")
    if not (0 <= window.r0 and window.r0 + h <= window.gh
            and 0 <= window.c0 and window.c0 + w <= window.gw):
        raise ValueError(f"a {h}x{w} array at ({window.r0}, {window.c0}) does not lie in the "
                         f"{window.gh}x{window.gw} image")
    for gap, edge in ((i0, window.r0 + i0), (h - i1, window.gh - window.r0 - i1),
                      (j0, window.c0 + j0), (w - j1, window.gw - window.c0 - j1)):
        if gap < min(halo, edge):
            raise ValueError(f"window {window} of a {h}x{w} array: the box needs {halo} pixels "
                             f"of halo for k = {k}, or the image's edge, on each side")


def tile_origins(h: int, w: int, tile_h: int, tile_w: int, box=None):
    """(r0, c0) of every tile of ``box`` (default the whole h x w array),
    row by row; the last row and column of tiles may be ragged."""
    i0, i1, j0, j1 = box or (0, h, 0, w)
    return [(r0, c0) for r0 in range(i0, i1, tile_h) for c0 in range(j0, j1, tile_w)]


def _plain_chunk(mut, const, sweep_fn, prepare_fn, k: int, tile_h: int, tile_w: int,
                 window: Window | None = None):
    """One chunk of ``k`` sweeps, tile by tile, as the kernel runs it: the
    tile and its halo cut out (clamped at the array's edge), ``k`` sweeps
    over regions that shrink by 2 each sweep (reaching one pixel further
    for a family that fills the border), the interior kept. Returns the
    box's part of the relaxed fields."""
    h, w = mut[0].shape[-2:]
    r0_img, c0_img, gh, gw, box = window or whole(h, w)
    i0, i1, j0, j1 = box
    family = getattr(sweep_fn, "family", None)
    fill, halo = _fill(family), _halo_for(family, k)
    dev = mut[0].device
    out = [x.new_empty(x.shape[:-2] + (i1 - i0, j1 - j0)) for x in mut]
    for r0, c0 in tile_origins(h, w, tile_h, tile_w, box):
        r1, c1 = min(r0 + tile_h, i1), min(c0 + tile_w, j1)
        gr0, gr1 = max(r0 - halo, 0), min(r1 + halo, h)
        gc0, gc1 = max(c0 - halo, 0), min(c1 + halo, w)
        ii = torch.arange(gr0, gr1, device=dev)[:, None]
        jj = torch.arange(gc0, gc1, device=dev)[None, :]
        gi, gj = ii + r0_img, jj + c0_img
        colour = [(gi + gj) % 2 == c for c in (0, 1)]
        inner = (gi >= 1) & (gi <= gh - 2) & (gj >= 1) & (gj <= gw - 2)

        def region(reach):
            return ((ii >= r0 - reach) & (ii < r1 + reach)
                    & (jj >= c0 - reach) & (jj < c1 + reach))

        aux = TileAux(colour[0], colour[1], gj == 0, gi == 0, gj == gw - 1, gi == gh - 1)
        tm = [x[..., gr0:gr1, gc0:gc1] for x in mut]
        tc = [x[..., gr0:gr1, gc0:gc1] for x in const]
        if prepare_fn is not None:
            tc = prepare_fn(tc, aux)
        for s in range(k):
            # colour 0 reaches one pixel further than colour 1, which reads it
            reach = 2 * (k - 1 - s) + fill
            grown = [colour[0] & region(reach + 1), colour[1] & region(reach)]
            tm = sweep_fn(tm, tc, aux._replace(maskf0=grown[0], maskf1=grown[1],
                                               mask0=grown[0] & inner, mask1=grown[1] & inner))
        for o, t in zip(out, tm):
            o[..., r0 - i0:r1 - i0, c0 - j0:c1 - j0] = t[..., r0 - gr0:r1 - gr0, c0 - gc0:c1 - gc0]
    return out


def plain_tiled_relax(fields, sweep_fn, prepare_fn, n_mut: int, iters: int, k: int,
                      tile_h: int, tile_w: int, window: Window | None = None):
    """The tile schedule in torch ops: ``iters // k`` chunks of ``k``
    sweeps and one of the remainder, each with its own halo. With a
    ``window``, one chunk of ``iters <= k`` sweeps over its box, whose part
    of the fields it returns."""
    mut, const = list(fields[:n_mut]), list(fields[n_mut:])
    family = getattr(sweep_fn, "family", None)
    if window is not None:
        iters = max(int(iters), 0)
        if iters > k:
            raise ValueError(f"a window is one chunk: iters={iters} > k={k}")
        check_window(mut[0].shape[-2:], window, iters, family)
        if iters == 0:
            i0, i1, j0, j1 = window.box
            return tuple(x[..., i0:i1, j0:j1].clone() for x in mut)
        return tuple(_plain_chunk(mut, const, sweep_fn, prepare_fn, iters, tile_h, tile_w,
                                  window))
    n_full, rem = divmod(max(int(iters), 0), k)
    if n_full + rem and _fill(family) and min(mut[0].shape[-2:]) == 1:
        # W4: the plain solvers' border fill empties a 1-px image (as
        # pde_tpu's replicate_border); the stripe engine's does not
        return tuple(replicate_border(x) for x in mut)
    for kc in [k] * n_full + ([rem] if rem else []):
        mut = _plain_chunk(mut, const, sweep_fn, prepare_fn, kc, tile_h, tile_w)
    return tuple(mut)


def tiled_relax(fields: Sequence[torch.Tensor], sweep_fn, n_mut: int, iters: int,
                k_max: int = 4, prepare_fn=None, plan_override=None,
                double_buffer: bool = False, window: Window | None = None):
    """Run ``iters`` red-black sweeps of ``sweep_fn`` over ``fields``.

    fields[:n_mut] are the relaxed state; the rest are frozen coefficients,
    transformed once per tile by ``prepare_fn(const, aux)``. Returns the
    updated mutable fields, identical to running the same sweeps globally,
    or ``None`` when no plan fits.

    plan_override: ``(k, tile)`` or ``(k, tile, slots)`` forcing the
    temporal block, the tile (an int, square, or ``(tile_h, tile_w)``) and
    the kernel's pairs of pixels a thread (by default the fewest that fit).

    double_buffer=True runs the two-slot kernel on the card (the port of
    ``_stripe_kernel_db``, every family), planned with two slots a block:
    the same numbers, bit for bit. On CPU tensors both run the plain tile
    schedule.

    window: the fields are part of an image (``Window``, a shard and its
    exchanged halo); one chunk of ``iters`` sweeps relaxes the tiles of the
    window's box, planned over the box, and returns the box's part of the
    relaxed fields, as the same sweeps over the whole image give it. On the
    card the windowed variant of the kernel runs it.

    The fields of disp_llin4, pde4 and pde8 may be batched, (B, H, W), a
    field shared by the systems (H, W); the card takes up to
    ``LAYOUTS[family].max_batch`` systems in one launch.
    """
    family = getattr(sweep_fn, "family", None)
    h, w = fields[0].shape[-2:]
    if window is not None:
        i0, i1, j0, j1 = window.box
        h, w = i1 - i0, j1 - j0
        k_max = iters
    if plan_override is not None:
        k, tile, *slots = plan_override
        tile_h, tile_w = (tile, tile) if isinstance(tile, int) else tile
        slots = slots[0] if slots else None
    else:
        batch = max([x.shape[0] for x in fields if x.ndim == 3] or [1])
        plan = plan_tiles(h, w, family, iters, k_max, double_buffer=double_buffer,
                          exact_k=window is not None, sm_count=_sm_count(fields[0]), batch=batch)
        if plan is None:
            return None
        k, tile_h, tile_w, slots = plan.k, plan.tile_h, plan.tile_w, plan.slots
    if window is not None and k < iters:
        raise ValueError(f"a window is one chunk: the plan's k={k} < iters={iters}")
    if plain_mode.is_plain(fields[0]):
        if window is None:
            return plain_tiled_relax(fields, sweep_fn, prepare_fn, n_mut, iters, k, tile_h,
                                     tile_w)
        return plain_tiled_relax(fields, sweep_fn, prepare_fn, n_mut, iters, k, tile_h,
                                 tile_w, window)
    if (family not in LAYOUTS or n_mut != LAYOUTS[family].n_mut
            or getattr(prepare_fn, "family", None) != family
            or prepare_fn.omega != sweep_fn.omega):
        raise ValueError("the tile kernel runs the sweeps of kernels/sweeps.py (flow_llin4, "
                         "flow_elin4, disp_llin4, pde4, flow_llin8, pde8) with their own "
                         f"prepare; got {getattr(sweep_fn, '__qualname__', sweep_fn)!r}")
    if window is None:
        return tiled_cuda.tiled_sor(family, tuple(fields), iters, sweep_fn.omega, k, tile_h,
                                    tile_w, double_buffer, slots)
    return tiled_cuda.tiled_sor_window(family, tuple(fields), iters, sweep_fn.omega, window,
                                       tile_h, tile_w, double_buffer, slots)


def _sm_count(x: torch.Tensor) -> int:
    """SMs of the card ``x`` lies on; ``SM_COUNT`` off the card."""
    return resident_cuda.sm_count(x.device.index or 0) if x.device.type == "cuda" else SM_COUNT
