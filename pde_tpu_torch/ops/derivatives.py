"""Simoncelli-style image derivative stacks (``pde_tpu/ops/derivatives.py``).

* first-order: ``Idt = 0.5*(It0 - It1w)``; ``Idx``/``Idy`` are
  smooth-then-derive of the *warped* second frame only,
* second-order: ``Idxt``/``Idyt`` are temporal differences of per-frame
  first derivatives; ``Idxx``/``Idyy`` use the 2nd-derivative kernel,
  ``Idxy`` applies the 1st-derivative kernel along both axes.

Correlations with replicate borders; zero taps are skipped
(``core/conv.py``), so NaNs from out-of-image warps propagate exactly as
in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from pde_tpu_torch.core.conv import separable_filter, imfilter_replicate

SMOOTHER5 = np.array(
    [0.037659, 0.249724, 0.439911, 0.249724, 0.037659], dtype=np.float32
)
FST_DERIVATOR5 = np.array(
    [-0.104550, -0.292315, 0.0, 0.292315, 0.104550], dtype=np.float32
)
SND_DERIVATOR5 = np.array(
    [0.232905, 0.002668, -0.471147, 0.002668, 0.232905], dtype=np.float32
)


def fst_derivatives5(it0: torch.Tensor, it1: torch.Tensor, scale: float = 1.0):
    """First-order (Idt, Idx, Idy) of an image pair, (..., H, W) tensors.

    ``scale`` rescales the spatial derivator.
    """
    d = FST_DERIVATOR5 * scale
    idt = 0.5 * (it0 - it1)
    idx = separable_filter(separable_filter(it1, SMOOTHER5, None), None, d)
    idy = separable_filter(separable_filter(it1, None, SMOOTHER5), d, None)
    return idt, idx, idy


def snd_derivatives5(it0: torch.Tensor, it1: torch.Tensor):
    """Second-order (Idxt, Idyt, Idxx, Idyy, Idxy) of an image pair."""

    def dx(img):
        return separable_filter(separable_filter(img, SMOOTHER5, None), None, FST_DERIVATOR5)

    def dy(img):
        return separable_filter(separable_filter(img, None, SMOOTHER5), FST_DERIVATOR5, None)

    idxt = 0.5 * (dx(it0) - dx(it1))
    idyt = 0.5 * (dy(it0) - dy(it1))
    idxx = separable_filter(separable_filter(it1, SMOOTHER5, None), None, SND_DERIVATOR5)
    idyy = separable_filter(separable_filter(it1, None, SMOOTHER5), SND_DERIVATOR5, None)
    idxy = separable_filter(separable_filter(it1, None, FST_DERIVATOR5), FST_DERIVATOR5, None)
    return idxt, idyt, idxx, idyy, idxy


def rgb2grad(img: torch.Tensor) -> torch.Tensor:
    """Per-channel [1 0 -1] gradients, interleaved (dx, dy) per channel:
    (C, H, W) -> (2C, H, W) ordered [c0_dx, c0_dy, c1_dx, ...]."""
    if img.ndim == 2:
        img = img[None]
    odx = np.array([1.0, 0.0, -1.0], dtype=np.float32)
    gx = imfilter_replicate(img, odx[None, :])
    gy = imfilter_replicate(img, odx[:, None])
    c, h, w = img.shape
    return torch.stack([gx, gy], dim=1).reshape(2 * c, h, w)
