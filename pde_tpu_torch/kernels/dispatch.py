"""Solver dispatch: the hand-written kernel for CUDA tensors, the plain
PyTorch version for CPU tensors.

A CUDA tensor goes to the kernel or raises; it never falls back, whatever
its size. ``plain_solvers()`` runs the plain version on any device, so
that a check can hold the kernel against it on the card; the package
itself never enters it.

Every tridiagonal line solve of the package comes through here
(``thomas_solve``, ``tridiag_factor``/``tridiag_solve`` and the zebra
helpers ``line_factors``/``line_solve``). On the card, one factor of the
full field serves both zebra parities (the kernel's per-line arithmetic is
the same); in the plain version each parity's lines have their own, as in
``pde_tpu``.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from pde_tpu_torch.kernels import interior_cuda, sor_cuda, tdma_cuda
from pde_tpu_torch.solvers import sor as _sor
from pde_tpu_torch.solvers import tdma as _tdma

_FORCE_PLAIN = contextvars.ContextVar("pde_tpu_torch_force_plain", default=False)


@contextlib.contextmanager
def plain_solvers():
    """Within this context, dispatch the plain PyTorch solvers instead of
    the CUDA kernels, whatever the device."""
    tok = _FORCE_PLAIN.set(True)
    try:
        yield
    finally:
        _FORCE_PLAIN.reset(tok)


def _plain(x) -> bool:
    return x.device.type == "cpu" or _FORCE_PLAIN.get()


def sor_flow_llin4(u, v, du, dv, m, cu, cv, duc, dvc, ww, wn, we, ws,
                   iters: int, omega: float):
    args = (u, v, du, dv, m, cu, cv, duc, dvc, ww, wn, we, ws, iters, omega)
    if _plain(u):
        return _sor.sor_flow_llin4(*args)
    return sor_cuda.flow_llin4_sor(*args)


def sor_flow_elin4(u, v, m, cu, cv, duc, dvc, ww, wn, we, ws, iters: int, omega: float):
    args = (u, v, m, cu, cv, duc, dvc, ww, wn, we, ws, iters, omega)
    if _plain(u):
        return _sor.sor_flow_elin4(*args)
    return sor_cuda.flow_elin4_sor(*args)


def sor_flow_llin8(u, v, du, dv, m, cu, cv, duc, dvc,
                   ww, wnw, wn, wne, we, wse, ws, wsw, iters: int, omega: float):
    args = (u, v, du, dv, m, cu, cv, duc, dvc, ww, wnw, wn, wne, we, wse, ws, wsw,
            iters, omega)
    if _plain(u):
        return _sor.sor_flow_llin8(*args)
    return sor_cuda.flow_llin8_sor(*args)


def sor_disp_llin4(u, du, cu, duc, ww, wn, we, ws, iters: int, omega: float):
    args = (u, du, cu, duc, ww, wn, we, ws, iters, omega)
    if _plain(u):
        return _sor.sor_disp_llin4(*args)
    return interior_cuda.disp_llin4_sor(*args)


def sor_disp_llin_sym4(u0, du0, cu0, duc0, ww0, wn0, we0, ws0,
                       u1, du1, cu1, duc1, ww1, wn1, we1, ws1,
                       iters: int, omega: float):
    """The symmetric pair as one kernel call with a batch of 2."""
    if _plain(u0):
        return _sor.sor_disp_llin_sym4(u0, du0, cu0, duc0, ww0, wn0, we0, ws0,
                                       u1, du1, cu1, duc1, ww1, wn1, we1, ws1, iters, omega)
    pairs = ((u0, u1), (du0, du1), (cu0, cu1), (duc0, duc1),
             (ww0, ww1), (wn0, wn1), (we0, we1), (ws0, ws1))
    out = interior_cuda.disp_llin4_sor(*(torch.stack(pair) for pair in pairs), iters, omega)
    return out[0], out[1]


def sor_pde4(x, trace, b, ww, wn, we, ws, iters: int, omega: float):
    args = (x, trace, b, ww, wn, we, ws, iters, omega)
    if _plain(x):
        return _sor.sor_pde4(*args)
    return interior_cuda.pde4_sor(*args)


def sor_pde8(x, trace, b, ww, wnw, wn, wne, we, wse, ws, wsw, iters: int, omega: float):
    """(H, W) or (C, H, W) unknowns alike: on the card both run the kernel."""
    args = (x, trace, b, ww, wnw, wn, wne, we, wse, ws, wsw, iters, omega)
    if _plain(x):
        return _sor.sor_pde8(*args)
    return interior_cuda.pde8_sor(*args)


def thomas_solve(a, b, c, d, axis: int = -2):
    """Tridiagonal systems along ``axis`` (a[0] and c[-1] ignored)."""
    if _plain(d):
        return _tdma.thomas_solve(a, b, c, d, axis)
    return tdma_cuda.thomas_solve(a, b, c, d, axis)


def tridiag_factor(a, b, c, axis: int = -2):
    """The elimination of the systems along ``axis``, for ``tridiag_solve``."""
    if _plain(b):
        return _tdma.tridiag_factor(a, b, c, axis)
    return tdma_cuda.tridiag_factor(a, b, c, axis)


def tridiag_solve(fac, d, axis: int = -2):
    """Solve with a factor of ``tridiag_factor`` for a new RHS."""
    if _plain(d):
        return _tdma.tridiag_solve(fac, d, axis)
    return tdma_cuda.tridiag_solve(fac, d)


def line_factors(a, b, c, vertical: bool):
    """Factors for the zebra line solves of ``line_solve``: columns
    (``vertical``) or rows."""
    if _plain(b):
        return _tdma.line_factors(a, b, c, vertical)
    fac = tdma_cuda.tridiag_factor(a, b, c, -2 if vertical else -1)
    return fac, fac


def line_solve(facs, d_full, parity: int, vertical: bool):
    """The lines ``parity::2`` (columns if ``vertical``, else rows) of the
    solve with RHS ``d_full``, compactly."""
    if _plain(d_full):
        return _tdma.line_solve(facs, d_full, parity, vertical)
    return tdma_cuda.tridiag_solve(facs[parity], d_full, parity)
