"""Solver dispatch: the hand-written kernel for CUDA tensors, the plain
PyTorch version for CPU tensors.

A CUDA tensor goes to the kernel or raises; it never falls back.
``plain_solvers()`` runs the plain version on any device, so that a check
can hold the kernel against it on the card; the package itself never
enters it.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from pde_tpu_torch.kernels import interior_cuda, sor_cuda
from pde_tpu_torch.solvers import sor as _sor

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
