"""Additive-operator-splitting (AOS) semi-implicit level-set steps, ported
from ``pde_tpu/solvers/aos.py`` (CV_AOSOMP_4_2d / AC_AOS_4_2d,
levelsetSolvers.c:57-868): two batched tridiagonal solves (vertical and
horizontal), summed:

    u+ = x_v + x_h,  where each solves
    (2 + nu*(Dp + Dn)) x_i - nu*Dp x_{i-1} - nu*Dn x_{i+1} = rhs
    Dn = 2*tau*G_c / (Diff_c + Diff_next)  (harmonic average; 0 if the sum <= 0)

* Chan-Vese: rhs = PHI + tau*G*DATA; clamped to [-5, 5] after each pass.
* Active contour: rhs = PHI + tau*DATA, no clamping; the caller reinits.
* Zero-diffusivity freeze: pixels with Diff == 0 keep their input value.

The two solves go through ``kernels/dispatch.thomas_solve``: on the card
the ``tridiag_thomas`` entry of ``csrc/tridiag.cu``, one launch each (the
global-rows variant for lines longer than ~28,000 elements). Arrays are
``(..., H, W)``: leading dimensions are level-set functions solved
together.
"""

from __future__ import annotations

import torch

from pde_tpu_torch.core.grid import shift_e, shift_n, shift_s, shift_w
from pde_tpu_torch.kernels.dispatch import thomas_solve
from pde_tpu_torch.solvers.tdma import _edge_zero

PHI_MIN = -5.0
PHI_MAX = 5.0


def _harmonic(diff, grad, tau, shift):
    s = diff + shift(diff)
    pos = s > 0.0
    return torch.where(pos, 2.0 * tau * grad / torch.where(pos, s, 1.0), 0.0)


def _aos_pair(phi_rhs, grad, diff, tau, nu):
    """The vertical and horizontal implicit half-solutions."""
    # vertical (along rows, axis -2): next = S (i+1), prev = N (i-1)
    dn = _edge_zero(_harmonic(diff, grad, tau, shift_s), -2, "last")
    dp = _edge_zero(_harmonic(diff, grad, tau, shift_n), -2, "first")
    xv = thomas_solve(-nu * dp, 2.0 + nu * (dn + dp), -nu * dn, phi_rhs, axis=-2)
    # horizontal (along columns, axis -1): next = E, prev = W
    dn = _edge_zero(_harmonic(diff, grad, tau, shift_e), -1, "last")
    dp = _edge_zero(_harmonic(diff, grad, tau, shift_w), -1, "first")
    xh = thomas_solve(-nu * dp, 2.0 + nu * (dn + dp), -nu * dn, phi_rhs, axis=-1)
    return xv, xh


def cv_aos_step(phi, data, grad, diff, tau, nu):
    """One Chan-Vese AOS step with clamping and the zero-diffusivity freeze."""
    rhs = phi + tau * grad * data
    xv, xh = _aos_pair(rhs, grad, diff, tau, nu)
    out = torch.clamp(torch.clamp(xv, PHI_MIN, PHI_MAX) + xh, PHI_MIN, PHI_MAX)
    return torch.where(diff == 0.0, phi, out)


def ac_aos_step(phi, data, grad, diff, tau, nu):
    """One geodesic-active-contour AOS step (no clamp; the caller reinits)."""
    rhs = phi + tau * data
    xv, xh = _aos_pair(rhs, grad, diff, tau, nu)
    return torch.where(diff == 0.0, phi, xv + xh)
