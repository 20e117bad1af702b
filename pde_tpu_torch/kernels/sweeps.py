"""Per-tile sweep bodies of the tile engine (``kernels/tiled.py``), after
``pde_tpu/kernels/sweeps.py``.

Each factory returns ``(prepare, sweep)`` for ``tiled_relax``: ``prepare``
zeroes the out-facing weights at the *global* image edge and folds the NaN
missing-data protocol into the coefficients once per tile; ``sweep`` is
one full red-black sweep over a tile. Both are built from the helpers of
the plain global solver (``solvers/sor.py``: ``flow_coefficients`` and
``flow_half_sweep``), so a tile rounds exactly as the global plain
version does. Colours and edges come from the tile's ``TileAux``, which
holds them in global coordinates.

On CUDA tensors ``tiled_relax`` runs these two families on the kernel of
``csrc/tiled_sor.cu``; each sweep carries its family and ``omega`` as
attributes for that. The factories are cached, so a family's functions
are one object per ``omega``, as in ``pde_tpu``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from pde_tpu_torch.solvers.sor import flow_coefficients, flow_half_sweep


class TileAux(NamedTuple):
    """A tile's masks, from global coordinates: the two colours (restricted
    to the pixels the current sweep updates) and the four global image
    edges."""

    maskf0: torch.Tensor
    maskf1: torch.Tensor
    edge_w: torch.Tensor
    edge_n: torch.Tensor
    edge_e: torch.Tensor
    edge_s: torch.Tensor


def _zero_edges4(ww, wn, we, ws, aux: TileAux):
    return (torch.where(aux.edge_w, 0.0, ww), torch.where(aux.edge_n, 0.0, wn),
            torch.where(aux.edge_e, 0.0, we), torch.where(aux.edge_s, 0.0, ws))


def _flow_sweep(omega: float, late: bool):
    def prepare(const, aux):
        if late:
            u, v, m, cu, cv, duc, dvc, *weights = const
        else:
            (m, cu, cv, duc, dvc, *weights), u, v = const, None, None
        # border-solving convention: out-facing weights zeroed at the
        # GLOBAL image edges, every real pixel relaxed
        return u, v, flow_coefficients(m, cu, cv, duc, dvc, _zero_edges4(*weights, aux))

    def sweep(mut, const, aux):
        fu, fv = mut
        u, v, co = const
        fu, fv = flow_half_sweep(fu, fv, u, v, aux.maskf0, co, omega)
        fu, fv = flow_half_sweep(fu, fv, u, v, aux.maskf1, co, omega)
        return [fu, fv]

    sweep.family = prepare.family = "flow_llin4" if late else "flow_elin4"
    sweep.omega = prepare.omega = float(omega)
    return prepare, sweep


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
