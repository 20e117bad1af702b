"""Per-tile sweep bodies of the tile engine (``kernels/tiled.py``), after
``pde_tpu/kernels/sweeps.py``.

Each factory returns ``(prepare, sweep)`` for ``tiled_relax`` and the
sharded solvers of ``parallel/tiled.py``: ``prepare`` folds the NaN
missing-data protocol into the coefficients once per tile (the flow
families also zero the out-facing weights at the *global* image edge);
``sweep`` is one full red-black sweep over a tile. Both are built from the
helpers of the plain global solvers (``solvers/sor.py``:
``flow_coefficients``/``flow_half_sweep`` for the coupled flow families,
llin4, elin4 and llin8; ``disp_coefficients``/``disp_half_sweep`` and
``pde_coefficients``/``pde_half_sweep`` for the interior-update families,
disp llin4, pde4 and pde8, which relax the interior and fill the 1-px
border after each sweep), so a tile rounds exactly as the global plain
version does. Colours, the interior and the edges come from the tile's
``TileAux``, which holds them in global coordinates.

On CUDA tensors ``tiled_relax`` runs every family on the kernel of
``csrc/tiled_sor.cu``: each factory's ``prepare`` and ``sweep`` carry the
family's name (``tiled.LAYOUTS``) and ``omega`` as attributes for that.
The factories are cached, so a family's functions are one object per
``omega``, as in ``pde_tpu``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from pde_tpu_torch.core.grid import shift_e, shift_n, shift_s, shift_w
from pde_tpu_torch.solvers.sor import (disp_coefficients, disp_half_sweep, flow_coefficients,
                                       flow_half_sweep, pde_coefficients, pde_half_sweep)


class TileAux(NamedTuple):
    """A tile's masks, from global coordinates: the two colours (restricted
    to the pixels the current sweep updates), the four global image edges,
    and the two colours of the image's interior (restricted alike)."""

    maskf0: torch.Tensor
    maskf1: torch.Tensor
    edge_w: torch.Tensor
    edge_n: torch.Tensor
    edge_e: torch.Tensor
    edge_s: torch.Tensor
    mask0: torch.Tensor = None
    mask1: torch.Tensor = None


def _zero_edges4(ww, wn, we, ws, aux: TileAux):
    return (torch.where(aux.edge_w, 0.0, ww), torch.where(aux.edge_n, 0.0, wn),
            torch.where(aux.edge_e, 0.0, we), torch.where(aux.edge_s, 0.0, ws))


def _zero_edges8(ww, wnw, wn, wne, we, wse, ws, wsw, aux: TileAux):
    """Every weight whose neighbour is off the image zeroed, as the global
    solver's ``_edge_zeroed8``."""
    ww, wn, we, ws = _zero_edges4(ww, wn, we, ws, aux)
    return (ww, torch.where(aux.edge_n | aux.edge_w, 0.0, wnw), wn,
            torch.where(aux.edge_n | aux.edge_e, 0.0, wne), we,
            torch.where(aux.edge_s | aux.edge_e, 0.0, wse), ws,
            torch.where(aux.edge_s | aux.edge_w, 0.0, wsw))


def _border(x, aux: TileAux):
    """The 1-px border fill at the global image edges, rows first, then
    columns (``core/grid.replicate_border``); the shifts are the tile's
    own, which reach the inner neighbour of every edge pixel on it."""
    x = torch.where(aux.edge_n, shift_s(x), torch.where(aux.edge_s, shift_n(x), x))
    return torch.where(aux.edge_w, shift_e(x), torch.where(aux.edge_e, shift_w(x), x))


def _named(prepare, sweep, family: str, omega: float):
    """``(prepare, sweep)`` with the family and ``omega`` the tile kernel
    reads."""
    sweep.family = prepare.family = family
    sweep.omega = prepare.omega = float(omega)
    return prepare, sweep


def _flow_sweep(omega: float, late: bool, eight: bool = False):
    zero_edges = _zero_edges8 if eight else _zero_edges4

    def prepare(const, aux):
        if late:
            u, v, m, cu, cv, duc, dvc, *weights = const
        else:
            (m, cu, cv, duc, dvc, *weights), u, v = const, None, None
        # border-solving convention: out-facing weights zeroed at the
        # GLOBAL image edges, every real pixel relaxed
        return u, v, flow_coefficients(m, cu, cv, duc, dvc, zero_edges(*weights, aux))

    def sweep(mut, const, aux):
        fu, fv = mut
        u, v, co = const
        fu, fv = flow_half_sweep(fu, fv, u, v, aux.maskf0, co, omega)
        fu, fv = flow_half_sweep(fu, fv, u, v, aux.maskf1, co, omega)
        return [fu, fv]

    return _named(prepare, sweep, "flow_llin8" if eight else "flow_llin4" if late else "flow_elin4",
                  omega)


@lru_cache(maxsize=None)
def flow_llin4_sweep(omega: float):
    """Coupled (dU, dV) late-linearisation 4-neighbour flow sweep.

    fields = [du, dv | u, v, m, cu, cv, duc, dvc, ww, wn, we, ws].
    """
    return _flow_sweep(omega, late=True)


@lru_cache(maxsize=None)
def flow_elin4_sweep(omega: float):
    """Early-linearisation coupled (U, V) 4-neighbour flow sweep.

    fields = [u, v | m, cu, cv, duc, dvc, ww, wn, we, ws].
    """
    return _flow_sweep(omega, late=False)


@lru_cache(maxsize=None)
def flow_llin8_sweep(omega: float):
    """Coupled (dU, dV) 8-neighbour (anisotropic tensor) flow sweep.

    fields = [du, dv | u, v, m, cu, cv, duc, dvc,
              ww, wnw, wn, wne, we, wse, ws, wsw].
    """
    return _flow_sweep(omega, late=True, eight=True)


@lru_cache(maxsize=None)
def disp_llin4_sweep(omega: float):
    """Scalar late-linearisation disparity sweep: interior only, the border
    filled after each sweep.

    fields = [du | u, cu, duc, ww, wn, we, ws].
    """

    def prepare(const, aux):
        u, cu, duc, *weights = const
        return u, disp_coefficients(cu, duc, weights)

    def sweep(mut, const, aux):
        (du,) = mut
        u, co = const
        du = disp_half_sweep(du, u, aux.mask0, co, omega)
        du = disp_half_sweep(du, u, aux.mask1, co, omega)
        return [_border(du, aux)]

    return _named(prepare, sweep, "disp_llin4", omega)


def _pde_sweep(omega: float, family: str):
    def prepare(const, aux):
        trace, b, *weights = const
        return pde_coefficients(trace, b, weights)

    def sweep(mut, co, aux):
        (x,) = mut
        x = pde_half_sweep(x, aux.mask0, co, omega)
        x = pde_half_sweep(x, aux.mask1, co, omega)
        return [_border(x, aux)]

    return _named(prepare, sweep, family, omega)


@lru_cache(maxsize=None)
def pde4_sweep(omega: float):
    """Diagonal-form 4-neighbour sweep X+ = (B + Σ wX)/TRACE: interior
    only, the border filled after each sweep.

    fields = [x | trace, b, ww, wn, we, ws].
    """
    return _pde_sweep(omega, "pde4")


@lru_cache(maxsize=None)
def pde8_sweep(omega: float):
    """Diagonal-form 8-neighbour sweep.

    fields = [x | trace, b, ww, wnw, wn, wne, we, wse, ws, wsw].
    """
    return _pde_sweep(omega, "pde8")
