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

from pde_tpu_torch.kernels import sor_cuda
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


def sor_flow_llin4(u, v, du, dv, m, cu, cv, duc, dvc, ww, wn, we, ws,
                   iters: int, omega: float):
    args = (u, v, du, dv, m, cu, cv, duc, dvc, ww, wn, we, ws, iters, omega)
    if u.device.type == "cpu" or _FORCE_PLAIN.get():
        return _sor.sor_flow_llin4(*args)
    return sor_cuda.flow_llin4_sor(*args)
