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
(``kernels/tiled_cuda.py``) for the two sweep families it has, llin4 and
elin4 (``kernels/sweeps.py``): one launch a chunk, 2-D tiles in shared
memory, serial (one block per tile) or double-buffered (persistent blocks
that copy the next tile in under the current one's sweeps). On CPU tensors,
or under ``dispatch.plain_solvers()``, it runs the same tile schedule in
torch ops: the plain version, which CPU-tests the tile and halo indexing
as ``pde_tpu``'s Pallas kernels run in interpret mode. A CUDA tensor goes
to the kernel or raises.

The plan and the kernel agree on the shared-memory layout: per pixel of a
slot (tile plus halo), one float32 plane per field and one flag byte.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Sequence

import torch

from pde_tpu_torch.kernels import dispatch, tiled_cuda
from pde_tpu_torch.kernels.sweeps import TileAux

# dependency radius of one full red-black sweep
RB_RADIUS = 2
# dynamic shared memory one block of an H100 may take (227 KB)
SMEM_PER_BLOCK = 232_448
_TILE_STEP = 8
_TILE_W = 64
_TILE_H_MAX = 128
_TILE_H_MIN = 16


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _halo_for(k: int) -> int:
    """Halo of a chunk of ``k`` sweeps. The kernel copies 4-byte words,
    so no alignment rounding is needed."""
    return RB_RADIUS * k


def slot_bytes(n_fields: int, k: int, tile_h: int, tile_w: int) -> int:
    """Shared memory of one slot: a float32 plane per field and a flag
    byte per pixel of the tile and its halo, rounded to 16 bytes (the
    kernel's ``slot_bytes``)."""
    halo = _halo_for(k)
    px = (tile_h + 2 * halo) * (tile_w + 2 * halo)
    return _round_up(n_fields * 4 * px + px, 16)


class TilePlan(NamedTuple):
    k: int
    tile_h: int
    tile_w: int
    n_tiles_h: int
    n_tiles_w: int
    smem_bytes: int  # per block: one slot, or two when double-buffered


@functools.lru_cache(maxsize=256)
def plan_tiles(h: int, w: int, n_fields: int, sweeps: int, k_max: int = 4,
               double_buffer: bool = False):
    """Choose the temporal block ``k`` and the 2-D tile for an (h, w)
    problem of ``n_fields`` fields; ``None`` when no plan fits.

    The tile is 64 columns wide (the image's width rounded up to 8 where
    that is less) and as tall, in steps of 8 up to 128, as one slot allows:
    a block's whole shared memory (one block an SM), or half of it when
    ``double_buffer`` (two slots). k is the largest up to
    ``min(k_max, sweeps)`` that leaves the tile at least 16 rows (the
    image's height rounded up to 8 where that is less).
    ``scripts/tiled_plan_sweep.py`` measured such wide tiles at one block
    an SM fastest on the H100 (PERF.md).
    """
    budget = SMEM_PER_BLOCK // (2 if double_buffer else 1)
    tile_w = min(_TILE_W, _round_up(w, _TILE_STEP))
    hi_h = min(_TILE_H_MAX, _round_up(h, _TILE_STEP))
    for k in range(max(1, min(k_max, sweeps)), 0, -1):
        fits = [th for th in range(_TILE_STEP, hi_h + 1, _TILE_STEP)
                if slot_bytes(n_fields, k, th, tile_w) <= budget]
        if fits and fits[-1] >= min(_TILE_H_MIN, hi_h):
            tile_h = fits[-1]
            return TilePlan(k, tile_h, tile_w, math.ceil(h / tile_h), math.ceil(w / tile_w),
                            (2 if double_buffer else 1) * slot_bytes(n_fields, k, tile_h, tile_w))
    return None


def bytes_per_pixel_iter(plan: TilePlan, n_fields: int, n_mut: int) -> float:
    """Device-memory bytes a pixel-iteration moves under ``plan``: every
    field of the slot read (the halo re-read by the neighbouring tiles)
    and the relaxed fields of the interior written, once per k sweeps."""
    halo = _halo_for(plan.k)
    slot = (plan.tile_h + 2 * halo) * (plan.tile_w + 2 * halo)
    return (n_fields * 4 * slot / (plan.tile_h * plan.tile_w) + n_mut * 4) / plan.k


def tile_origins(h: int, w: int, tile_h: int, tile_w: int):
    """(r0, c0) of every tile, row by row; the last row and column of
    tiles may be ragged."""
    return [(r0, c0) for r0 in range(0, h, tile_h) for c0 in range(0, w, tile_w)]


def _plain_chunk(mut, const, sweep_fn, prepare_fn, k: int, tile_h: int, tile_w: int):
    """One chunk of ``k`` sweeps, tile by tile, as the kernel runs it: the
    tile and its halo cut out (clamped at the image edge), ``k`` sweeps
    over regions that shrink by 2 each sweep, the interior kept."""
    h, w = mut[0].shape
    halo = _halo_for(k)
    dev = mut[0].device
    out = [torch.empty_like(x) for x in mut]
    for r0, c0 in tile_origins(h, w, tile_h, tile_w):
        r1, c1 = min(r0 + tile_h, h), min(c0 + tile_w, w)
        gr0, gr1 = max(r0 - halo, 0), min(r1 + halo, h)
        gc0, gc1 = max(c0 - halo, 0), min(c1 + halo, w)
        ii = torch.arange(gr0, gr1, device=dev)[:, None]
        jj = torch.arange(gc0, gc1, device=dev)[None, :]
        colour = [(ii + jj) % 2 == c for c in (0, 1)]

        def region(reach):
            return ((ii >= r0 - reach) & (ii < r1 + reach)
                    & (jj >= c0 - reach) & (jj < c1 + reach))

        aux = TileAux(colour[0], colour[1], jj == 0, ii == 0, jj == w - 1, ii == h - 1)
        tm = [x[gr0:gr1, gc0:gc1] for x in mut]
        tc = [x[gr0:gr1, gc0:gc1] for x in const]
        if prepare_fn is not None:
            tc = prepare_fn(tc, aux)
        for s in range(k):
            # colour 0 reaches one pixel further than colour 1, which reads it
            reach = 2 * (k - 1 - s)
            tm = sweep_fn(tm, tc, aux._replace(maskf0=colour[0] & region(reach + 1),
                                               maskf1=colour[1] & region(reach)))
        for o, t in zip(out, tm):
            o[r0:r1, c0:c1] = t[r0 - gr0:r1 - gr0, c0 - gc0:c1 - gc0]
    return out


def plain_tiled_relax(fields, sweep_fn, prepare_fn, n_mut: int, iters: int, k: int,
                      tile_h: int, tile_w: int):
    """The tile schedule in torch ops: ``iters // k`` chunks of ``k``
    sweeps and one of the remainder, each with its own halo."""
    mut, const = list(fields[:n_mut]), list(fields[n_mut:])
    n_full, rem = divmod(max(int(iters), 0), k)
    for kc in [k] * n_full + ([rem] if rem else []):
        mut = _plain_chunk(mut, const, sweep_fn, prepare_fn, kc, tile_h, tile_w)
    return tuple(mut)


def tiled_relax(fields: Sequence[torch.Tensor], sweep_fn, n_mut: int, iters: int,
                k_max: int = 4, prepare_fn=None, plan_override=None,
                double_buffer: bool = False):
    """Run ``iters`` red-black sweeps of ``sweep_fn`` over ``fields``.

    fields[:n_mut] are the relaxed state; the rest are frozen coefficients,
    transformed once per tile by ``prepare_fn(const, aux)``. Returns the
    updated mutable fields, identical to running the same sweeps globally,
    or ``None`` when no plan fits.

    plan_override: ``(k, tile)`` forcing the temporal block and the tile,
    ``tile`` an int (square) or ``(tile_h, tile_w)``.

    double_buffer=True runs the two-slot kernel on the card (the port of
    ``_stripe_kernel_db``): the same numbers, bit for bit. On CPU tensors
    both run the plain tile schedule.
    """
    h, w = fields[0].shape
    if plan_override is not None:
        k, tile = plan_override
        tile_h, tile_w = (tile, tile) if isinstance(tile, int) else tile
    else:
        plan = plan_tiles(h, w, len(fields), iters, k_max, double_buffer=double_buffer)
        if plan is None:
            return None
        k, tile_h, tile_w = plan.k, plan.tile_h, plan.tile_w
    if dispatch._plain(fields[0]):
        return plain_tiled_relax(fields, sweep_fn, prepare_fn, n_mut, iters, k, tile_h, tile_w)
    family = getattr(sweep_fn, "family", None)
    if (family not in tiled_cuda.FIELD_NAMES or n_mut != 2
            or getattr(prepare_fn, "family", None) != family
            or prepare_fn.omega != sweep_fn.omega):
        raise ValueError("the tile kernel runs the flow_llin4 and flow_elin4 sweeps of "
                         "kernels/sweeps.py with their own prepare; got "
                         f"{getattr(sweep_fn, '__qualname__', sweep_fn)!r}")
    return tiled_cuda.tiled_flow_sor(family, tuple(fields), iters, sweep_fn.omega, k,
                                     tile_h, tile_w, double_buffer)
