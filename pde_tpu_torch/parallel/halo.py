"""Halo exchange between the tiles of a mesh, after ``pde_tpu/parallel/halo.py``.

``pde_tpu`` runs its exchange inside ``shard_map``: each tile sends its
border strips one step along each mesh axis (``lax.ppermute``). Here one
process holds the whole grid of tiles (``mesh.shard``), so a tile's halo is
its neighbours' strips copied onto its device (``Tensor.to``, which orders
the copy after the work queued on both devices' current streams): rows
first, then columns from the row-extended tiles, so that the corners come
from the diagonal neighbours, as in ``pde_tpu``. No tile is computed on a
device other than its own.

* ``halo_exchange``: ``pde_tpu``'s layout, (..., h + 2 halo, w + 2 halo) a
  tile, the tile's own border strips at the mesh edges.
* ``halo_window``: the layout of the sharded solvers (``parallel/tiled.py``):
  the rectangle of the image a tile and its halo cover, clipped to the image
  (nothing outside it); a halo wider than a tile takes strips from tiles
  further away.
* ``halo_local``: the communication-free stand-in of ``halo_exchange``,
  benchmark-only: the same shapes and arithmetic, but every tile pads
  itself with its OWN strips, so the values at interior seams are wrong.
"""

from __future__ import annotations

import torch


def _extend_line(line, halo: int, mode: str, dim: int):
    """Each tile of ``line`` (the tiles along one mesh axis, which splits
    ``dim``) extended by ``halo`` along ``dim``, as ``mode`` says:
    ``"exchange"``, ``"local"``, ``"window"`` or ``"window_local"`` (own
    strips at interior seams, nothing at the image's edges)."""
    n = line[0].shape[dim]
    last = len(line) - 1
    if mode != "window" and halo > n:
        raise ValueError(f"a halo of {halo} from tiles of {n} along dim {dim}: a tile's "
                         "neighbours give at most its own size")
    out = []
    for i, x in enumerate(line):
        if mode == "window":
            lo, hi = max(0, i * n - halo), min(len(line) * n, (i + 1) * n + halo)
            parts = [line[a].narrow(dim, max(lo, a * n) - a * n, min(hi, (a + 1) * n) - max(lo, a * n))
                     for a in range(lo // n, -(-hi // n))]
        else:
            own_before = mode in ("local", "window_local") or i == 0
            own_after = mode in ("local", "window_local") or i == last
            before = (x if own_before else line[i - 1]).narrow(dim, 0 if own_before else n - halo,
                                                                halo)
            after = (x if own_after else line[i + 1]).narrow(dim, n - halo if own_after else 0,
                                                             halo)
            if mode == "window_local":
                parts = ([before] if i > 0 else []) + [x] + ([after] if i < last else [])
            else:
                parts = [before, x, after]
        out.append(torch.cat([p.to(x.device) for p in parts], dim=dim))
    return out


def _extend(tiles, halo: int, mode: str):
    nty, ntx = len(tiles), len(tiles[0])
    cols = [_extend_line([tiles[i][j] for i in range(nty)], halo, mode, -2) for j in range(ntx)]
    rows = [[cols[j][i] for j in range(ntx)] for i in range(nty)]
    return [_extend_line(row, halo, mode, -1) for row in rows]


def halo_exchange(tiles, halo: int = 1):
    """Pad every (..., h, w) tile of the grid ``tiles`` with ``halo`` rows
    and columns from its mesh neighbours: (..., h + 2 halo, w + 2 halo).
    Edge tiles replicate their own border strips (the reference's
    replicated border, so a tiled sweep matches the single-device one)."""
    return _extend(tiles, halo, "exchange")


def halo_local(tiles, halo: int = 1):
    """Communication-free stand-in for :func:`halo_exchange`: identical
    extended shape and arithmetic, but every tile replicates its OWN
    boundary strips, so interior tile seams get wrong values. Benchmarking
    only: timing a sweep with this in place of the real exchange isolates
    the copies' cost."""
    return _extend(tiles, halo, "local")


def halo_window(tiles, halo: int, comm: bool = True):
    """Every tile of the grid with the ``halo`` pixels of the image around
    it, clipped to the image: tile (i, j) of (h, w) becomes the image's rows
    ``[max(0, i h - halo), min(H, (i + 1) h + halo))`` and likewise columns.
    ``comm=False`` pads interior seams with the tile's own strips instead
    (``halo_local``'s benchmark floor, wrong at the seams)."""
    return _extend(tiles, halo, "window" if comm else "window_local")
