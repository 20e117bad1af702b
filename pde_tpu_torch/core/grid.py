"""Grid primitives: neighbour shifts, border handling, checkerboards.

Arrays are row-major ``(..., H, W)`` float32. W is column ``j-1``, E
``j+1``, N row ``i-1``, S ``i+1``. ``shift_*`` return the array whose
element at (i, j) is the value of that neighbour, replicated (clamped)
at the image edge, as in ``pde_tpu/core/grid.py``.
"""

from __future__ import annotations

import torch


def shift_w(x: torch.Tensor) -> torch.Tensor:
    """value of the west (left, j-1) neighbour; replicate at j=0."""
    return torch.cat([x[..., :, :1], x[..., :, :-1]], dim=-1)


def shift_e(x: torch.Tensor) -> torch.Tensor:
    """value of the east (right, j+1) neighbour; replicate at j=W-1."""
    return torch.cat([x[..., :, 1:], x[..., :, -1:]], dim=-1)


def shift_n(x: torch.Tensor) -> torch.Tensor:
    """value of the north (up, i-1) neighbour; replicate at i=0."""
    return torch.cat([x[..., :1, :], x[..., :-1, :]], dim=-2)


def shift_s(x: torch.Tensor) -> torch.Tensor:
    """value of the south (down, i+1) neighbour; replicate at i=H-1."""
    return torch.cat([x[..., 1:, :], x[..., -1:, :]], dim=-2)


def replicate_border(x: torch.Tensor) -> torch.Tensor:
    """Overwrite the 1-px border with its interior neighbour: rows first,
    then columns, so the corners come from the column pass (the reference's
    per-sweep border fill)."""
    x = torch.cat([x[..., 1:2, :], x[..., 1:-1, :], x[..., -2:-1, :]], dim=-2)
    return torch.cat([x[..., :, 1:2], x[..., :, 1:-1], x[..., :, -2:-1]], dim=-1)


def interior_mask(h: int, w: int, dtype=torch.bool, device=None) -> torch.Tensor:
    """True on pixels with all 4 neighbours in-bounds (the solver's update set)."""
    m = torch.zeros((h, w), dtype=torch.bool, device=device)
    m[1:-1, 1:-1] = True
    return m.to(dtype)


def checkerboard(h: int, w: int, parity: int = 0, device=None) -> torch.Tensor:
    """Boolean mask of pixels with (i + j) % 2 == parity (red/black ordering)."""
    ii = torch.arange(h, device=device)[:, None]
    jj = torch.arange(w, device=device)[None, :]
    return ((ii + jj) % 2) == parity
