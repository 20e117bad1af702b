"""Signed-distance reinitialisation of a level-set function, ported from
``pde_tpu/solvers/reinit.py``.

PDE ``PHI_t + S(PHI_0)(|grad PHI| - 1) = 0`` integrated with explicit
Euler steps of dt = 0.25 (levelsetSolvers.c:969-1118):

* central differences with replicate borders for the sign function's
  gradient,
* Peng et al. blurred sign ``S = PHI / sqrt(PHI^2 + |grad PHI| + eps)``
  (the C adds the gradient *norm*, not its square, kept verbatim),
* Godunov/Rouy-Tourin upwind squared gradients with one-sided differences
  zeroed at the image edge.

Plain torch ops on any device (a few elementwise kernels a step); no
hand-written kernel. Arrays are ``(..., H, W)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pde_tpu_torch.core.grid import shift_e, shift_n, shift_s, shift_w

_FLT_EPS = float(np.finfo(np.float32).eps)


def _central(phi):
    gx = 0.5 * (shift_e(phi) - shift_w(phi))
    gy = 0.5 * (shift_s(phi) - shift_n(phi))
    return gx, gy


def blurred_sign(phi):
    gx, gy = _central(phi)
    return phi / torch.sqrt(phi * phi + torch.sqrt(gx * gx + gy * gy) + _FLT_EPS)


def godunov_upwind_sq(phi, s):
    """Squared upwind gradient components (Rouy-Tourin switch on the sign
    of s). The replicate shifts give the one-sided zeros at the edges."""
    fd_x = shift_e(phi) - phi
    bd_x = phi - shift_w(phi)
    fd_y = shift_s(phi) - phi
    bd_y = phi - shift_n(phi)

    def maxp2(x):
        return torch.square(torch.clamp(x, min=0.0))

    def minp2(x):
        return torch.square(torch.clamp(x, max=0.0))

    pos = s > 0.0
    gx2 = torch.where(pos, torch.maximum(maxp2(bd_x), minp2(fd_x)),
                      torch.maximum(minp2(bd_x), maxp2(fd_x)))
    gy2 = torch.where(pos, torch.maximum(maxp2(bd_y), minp2(fd_y)),
                      torch.maximum(minp2(bd_y), maxp2(fd_y)))
    return gx2, gy2


def reinit(phi, steps: int = 40):
    """``steps`` explicit Euler steps of dt = 0.25 (the reference's T = 10
    is 40 steps; the reinit after each AOS step, T = 0.25, is 1)."""
    for _ in range(steps):
        s = blurred_sign(phi)
        gx2, gy2 = godunov_upwind_sq(phi, s)
        phi = phi + 0.25 * (s - s * torch.sqrt(gx2 + gy2))
    return phi


def reinit_t(phi, t: float):
    """The reference's call: integrate from 0 to T in dt = 0.25 steps."""
    steps = int(math.ceil(t / 0.25 - 1e-6))
    return reinit(phi, steps=max(steps, 0))
