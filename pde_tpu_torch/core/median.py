"""3x3 median filter with symmetric padding (``medfilt2(X, [3 3], 'symmetric')``).

The reference post-smooths every flow increment with it. ``symmetric``
mirrors *including* the edge pixel (``x[1], x[0] | x[0], x[1], ...``);
``F.pad(mode="reflect")`` would skip it, so the pad is built by hand. The
median is the 5th of the sorted 9-neighbourhood, as in
``pde_tpu/core/median.py``.
"""

from __future__ import annotations

import torch


def _pad_symmetric1(x: torch.Tensor) -> torch.Tensor:
    x = torch.cat([x[..., :1, :], x, x[..., -1:, :]], dim=-2)
    return torch.cat([x[..., :, :1], x, x[..., :, -1:]], dim=-1)


def medfilt2_3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 median with mirror ('symmetric') padding, as in medfilt2."""
    h, w = x.shape[-2:]
    xp = _pad_symmetric1(x)
    n = torch.stack([xp[..., di:di + h, dj:dj + w] for di in range(3) for dj in range(3)])
    return torch.sort(n, dim=0).values[4]
