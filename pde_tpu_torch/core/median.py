"""Median filters: 3x3 symmetric-padded (``medfilt2``) and the k x k NaN-median.

``medfilt2(X, [3 3], 'symmetric')`` post-smooths every flow increment in
the reference. ``symmetric`` mirrors *including* the edge pixel
(``x[1], x[0] | x[0], x[1], ...``); ``F.pad(mode="reflect")`` would skip
it, so the pad is built by hand. The median is the 5th of the sorted
9-neighbourhood, as in ``pde_tpu/core/median.py``.

``nanmedfilt2`` is the segmentation's prefilter (DispSegmentation.m:659-665:
``colfilt(A, [5 5], 'sliding', @nanmedian)``): zero-padded borders (colfilt
semantics), the median over the window's non-NaN entries.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pad_symmetric1(x: torch.Tensor) -> torch.Tensor:
    x = torch.cat([x[..., :1, :], x, x[..., -1:, :]], dim=-2)
    return torch.cat([x[..., :, :1], x, x[..., :, -1:]], dim=-1)


def medfilt2_3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 median with mirror ('symmetric') padding, as in medfilt2."""
    h, w = x.shape[-2:]
    xp = _pad_symmetric1(x)
    n = torch.stack([xp[..., di:di + h, dj:dj + w] for di in range(3) for dj in range(3)])
    return torch.sort(n, dim=0).values[4]


def nanmedfilt2(x: torch.Tensor, k: int = 5) -> torch.Tensor:
    """k*k sliding NaN-median of (..., H, W) with zero padding (MATLAB colfilt
    semantics). NaNs are excluded from the median; an all-NaN window gives NaN.
    """
    kk = k * k
    p = k // 2
    h, w = x.shape[-2:]
    # colfilt zero-pads, so border windows see real zeros: pad with 0 and count
    # only the data's NaNs. NaN -> +inf is an explicit where: nan_to_num with
    # nan=inf would pass its own substitute through the posinf rule and give
    # finite 3.4e38 values that spoil the count (and overflow the midpoint)
    xi = torch.where(torch.isnan(x), torch.inf, x)
    lead = xi.shape[:-2]
    xp = F.pad(xi.reshape(-1, h, w), (p, p, p, p)).reshape(*lead, h + 2 * p, w + 2 * p)
    n = torch.stack([xp[..., di:di + h, dj:dj + w] for di in range(k) for dj in range(k)])
    s = torch.sort(n, dim=0).values  # the data's NaNs (+inf) sort last; the pad takes part
    cnt = torch.isfinite(s).sum(dim=0)
    lo = torch.clamp(torch.div(cnt - 1, 2, rounding_mode="floor"), 0, kk - 1)
    hi = torch.clamp(torch.div(cnt, 2, rounding_mode="floor"), 0, kk - 1)
    med = 0.5 * (torch.gather(s, 0, lo[None])[0] + torch.gather(s, 0, hi[None])[0])
    return torch.where(cnt == 0, torch.nan, med)
