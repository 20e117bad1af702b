"""Bilinear warping with NaN out-of-domain semantics (``pde_tpu/ops/warp.py``).

1-based sample coordinates, corner fetches clamped to the image edge, and
NaN exactly where the base cell ``floor(coord-1)`` falls outside
``[0, size-1]``: the missing-data sentinel every solver understands.
``warp_window`` and ``warp_x_window`` are the windowed shift-and-add
forms that ``flow_nd`` and ``disparity_nd`` expose as their
``warp_window`` parameter, ported as plain ops.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def identity_grid(h: int, w: int, device=None):
    """1-based (X, Y) meshgrid matching MATLAB ``meshgrid(1:cols,1:rows)``."""
    y, x = torch.meshgrid(
        torch.arange(1, h + 1, device=device, dtype=torch.float32),
        torch.arange(1, w + 1, device=device, dtype=torch.float32),
        indexing="ij",
    )
    return x, y


def bilinear_warp(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` (..., H, W) at 1-based coords (x, y), NaN outside.

    x, y: (H, W) float tensors shared across leading channel dims.
    """
    h, w = img.shape[-2:]
    x0f = torch.floor(x - 1.0)
    y0f = torch.floor(y - 1.0)
    valid = (x0f >= 0) & (x0f <= w - 1) & (y0f >= 0) & (y0f <= h - 1)

    xf = x - 1.0 - x0f
    yf = y - 1.0 - y0f
    # a NaN coordinate is invalid anyway; map it to 0 so that the index
    # stays in range (torch raises on, or the card faults at, a wild index)
    x0 = torch.clamp(torch.nan_to_num(x0f), 0, w - 1).long()
    y0 = torch.clamp(torch.nan_to_num(y0f), 0, h - 1).long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)

    w00 = (1.0 - xf) * (1.0 - yf)
    w10 = xf * (1.0 - yf)
    w01 = (1.0 - xf) * yf
    w11 = xf * yf

    out = (
        w00 * img[..., y0, x0]
        + w10 * img[..., y0, x1]
        + w01 * img[..., y1, x0]
        + w11 * img[..., y1, x1]
    )
    return torch.where(valid, out, torch.full_like(out, float("nan")))


def warp_by_flow(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Warp ``img`` by flow (u, v): sample at (X+u, Y+v), NaN outside."""
    h, w = img.shape[-2:]
    x, y = identity_grid(h, w, device=img.device)
    return bilinear_warp(img, x + u, y + v)


def warp_x_window(img: torch.Tensor, u: torch.Tensor, r: int) -> torch.Tensor:
    """x-only windowed warp (disparity): sample (..., H, W) ``img`` at
    (X+u, Y). Equals ``bilinear_warp(img, X+u, Y)`` where
    ``floor(u) in [-r, r-1]``; NaN outside the window or the image."""
    w = img.shape[-1]
    ui = torch.floor(u)
    uf = u - ui
    x0 = torch.arange(w, dtype=torch.float32, device=img.device)[None, :] + ui
    valid = (x0 >= 0) & (x0 <= w - 1)
    win = (ui >= -r) & (ui <= r - 1)
    # edge pad by r and r+1 columns: it reproduces the clamped corner
    # fetch x1 = min(x0+1, w-1)
    cols = torch.arange(-r, w + r + 1, device=img.device).clamp(0, w - 1)
    p = img[..., cols]
    acc = torch.zeros(torch.broadcast_shapes(img.shape, u.shape), dtype=img.dtype,
                      device=img.device)
    for k in range(-r, r):
        s0 = p[..., :, k + r:k + r + w]
        s1 = p[..., :, k + r + 1:k + r + 1 + w]
        acc = torch.where(ui == k, (1.0 - uf) * s0 + uf * s1, acc)
    return torch.where(valid & win, acc, torch.full_like(acc, float("nan")))


def warp_window(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor, r: int) -> torch.Tensor:
    """2D windowed warp: sample at (X+u, Y+v) as a select-sum over the
    (2r)^2 shifted copies of the image. Equals ``warp_by_flow`` where
    ``floor(u), floor(v) in [-r, r-1]``; NaN outside the window or the
    image."""
    h, w = img.shape[-2:]
    ui = torch.floor(u)
    vi = torch.floor(v)
    uf = u - ui
    vf = v - vi
    jj = torch.arange(w, dtype=torch.float32, device=img.device)[None, :]
    ii = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    x0 = jj + ui
    y0 = ii + vi
    valid = (x0 >= 0) & (x0 <= w - 1) & (y0 >= 0) & (y0 <= h - 1)
    win = (ui >= -r) & (ui <= r - 1) & (vi >= -r) & (vi <= r - 1)
    lead = img.shape[:-2]
    p = F.pad(img.reshape(-1, h, w), (r, r + 1, r, r + 1), mode="replicate")
    p = p.reshape(*lead, h + 2 * r + 1, w + 2 * r + 1)
    acc = torch.zeros(torch.broadcast_shapes(img.shape, u.shape), dtype=img.dtype,
                      device=img.device)
    for ky in range(-r, r):
        sel_y = vi == ky
        r0 = p[..., ky + r:ky + r + h, :]
        r1 = p[..., ky + r + 1:ky + r + 1 + h, :]
        for kx in range(-r, r):
            p00 = r0[..., :, kx + r:kx + r + w]
            p01 = r0[..., :, kx + r + 1:kx + r + 1 + w]
            p10 = r1[..., :, kx + r:kx + r + w]
            p11 = r1[..., :, kx + r + 1:kx + r + 1 + w]
            val = (1.0 - vf) * ((1.0 - uf) * p00 + uf * p01) \
                + vf * ((1.0 - uf) * p10 + uf * p11)
            acc = torch.where(sel_y & (ui == kx), val, acc)
    return torch.where(valid & win, acc, torch.full_like(acc, float("nan")))
