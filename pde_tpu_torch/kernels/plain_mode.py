"""Which version a call runs: the plain PyTorch one for CPU tensors or
inside ``plain_solvers()``, else the CUDA kernel. A module of its own, so
that ``kernels/dispatch.py`` and the tile engine it routes to
(``kernels/tiled.py``) share it without importing each other."""

from __future__ import annotations

import contextlib
import contextvars

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


def is_plain(x) -> bool:
    return x.is_cpu or _FORCE_PLAIN.get()
