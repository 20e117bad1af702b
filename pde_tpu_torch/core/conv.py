"""Replicate-border filtering (MATLAB ``imfilter(..., 'replicate')`` semantics).

Correlations (no kernel flip) with replicate (clamp) padding, as in
``pde_tpu/core/conv.py``. Kernels are host-side constants, unrolled into
shift-and-add taps that **skip zero taps**: the derivators have a zero
centre tap, so a NaN at the centre pixel (an out-of-image warp) does not
reach the output. ``conv2d`` would spread it (``0 * NaN = NaN``) and move
the solver's pure-diffusion pixels; it would also run in TF32 through
cuDNN by default on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _pad_edge(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    *lead, h, w = x.shape
    xp = F.pad(x.reshape(-1, h, w), (pw, pw, ph, ph), mode="replicate")
    return xp.reshape(*lead, h + 2 * ph, w + 2 * pw)


def imfilter_replicate(x: torch.Tensor, kernel) -> torch.Tensor:
    """Correlate ``x`` (..., H, W) with a host-side 2-D ``kernel`` (a 1-D
    kernel acts along W), replicate borders. Odd-sized kernels only."""
    kval = np.asarray(kernel, dtype=np.float32)
    if kval.ndim == 1:
        kval = kval[None, :]
    kh, kw = kval.shape
    if kh % 2 != 1 or kw % 2 != 1:
        raise ValueError(f"only odd kernels supported, got {kval.shape}")
    h, w = x.shape[-2:]
    xp = _pad_edge(x, kh // 2, kw // 2)
    out = None
    for i in range(kh):
        for j in range(kw):
            kv = float(kval[i, j])
            if kv == 0.0:
                continue
            term = xp[..., i:i + h, j:j + w] * kv
            out = term if out is None else out + term
    return torch.zeros_like(x) if out is None else out


def separable_filter(x: torch.Tensor, kv, kh) -> torch.Tensor:
    """Vertical then horizontal 1-D correlation, replicate borders.

    ``kv`` acts along H (rows), ``kh`` along W (cols). Either may be None.
    """
    if kv is not None:
        x = imfilter_replicate(x, np.asarray(kv, dtype=np.float32)[:, None])
    if kh is not None:
        x = imfilter_replicate(x, np.asarray(kh, dtype=np.float32)[None, :])
    return x


@functools.lru_cache(maxsize=None)
def gaussian_kernel_1d(size: int, sigma: float) -> np.ndarray:
    """Unnormalised 1-D Gaussian samples on a centered window."""
    r = (size - 1) / 2.0
    xs = np.arange(size) - r
    return np.exp(-(xs**2) / (2.0 * sigma**2))


@functools.lru_cache(maxsize=None)
def gaussian_kernel_2d(size: int, sigma: float) -> np.ndarray:
    """MATLAB ``fspecial('gaussian', [size size], sigma)`` (sum == 1)."""
    k1 = gaussian_kernel_1d(size, sigma)
    k2 = np.outer(k1, k1)
    return (k2 / k2.sum()).astype(np.float32)


#: 1-4-6-4-1 binomial low-pass of the FMG pyramid
#: (FlowEminNDFASFMG_elin_2D_v10.m:98-110)
binomial5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0
