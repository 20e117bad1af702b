"""Coarse-to-fine image pyramids (reference pyramid-build semantics).

Level k is the bilinear resize of the *unsmoothed* level k-1 by
``scl_factor``; every retained level, the coarsest included, is
Gaussian-smoothed after its child has been built; the loop stops once a
level's H or W drops to <= ``stop`` (``pde_tpu/core/pyramid.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from pde_tpu_torch.core.conv import imfilter_replicate, gaussian_kernel_2d
from pde_tpu_torch.core.resize import imresize_scale


def pyramid_scales(
    h: int, w: int, scl_factor: float, stop: int, max_scales: int = 10**9
) -> list[tuple[int, int]]:
    """Static list of (H, W) per level, finest first, reference stop rule."""
    sizes = [(h, w)]
    while len(sizes) < max_scales:
        ph, pw = sizes[-1]
        nh, nw = int(np.ceil(ph * scl_factor)), int(np.ceil(pw * scl_factor))
        sizes.append((nh, nw))
        if nh <= stop or nw <= stop:
            break
    return sizes


def build_pyramid(
    imgs: list[torch.Tensor],
    scl_factor: float,
    stop: int,
    smooth_size: int = 5,
    smooth_sigma: float = 1.25,
    max_scales: int = 10**9,
) -> list[list[torch.Tensor]]:
    """Build pyramids for several (..., H, W) images simultaneously.

    Returns ``levels[k][i]``: level k (finest k=0) of image i. All images
    share the level geometry of the first one.
    """
    g = gaussian_kernel_2d(smooth_size, smooth_sigma)
    h, w = imgs[0].shape[-2:]
    sizes = pyramid_scales(h, w, scl_factor, stop, max_scales)
    raw = [list(imgs)]
    for _ in sizes[1:]:
        raw.append([imresize_scale(x, scl_factor, "bilinear") for x in raw[-1]])
    # smooth every retained level (incl. the coarsest) after its child is built
    return [[imfilter_replicate(x, g) for x in lvl] for lvl in raw]
