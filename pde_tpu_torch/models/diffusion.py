"""Semi-implicit nonlinear diffusion (Diffusion4_v10.m), ported from
``pde_tpu/models/diffusion.py``.

Additive vertical + horizontal split: each of ``outer_iter + 1``
iterations recomputes the Brox weights from the current image (max over
channels, zeroed borders), then

    ver solves (2 + alpha (wN + wS)) x - alpha wN x_N - alpha wS x_S = u
    hor solves the transposed system;  u <- ver + hor

(Diffusion4_v10.m:45-61, its TDMA :70-92). Each solve is one tridiagonal
line solve over all channels through ``kernels/dispatch.py::thomas_solve``
(the CUDA kernel on the card, the shared (H, W) coefficients read by every
channel). Runs eagerly on the card unless the caller asks for the CPU
(``models/_device.py``).
"""

from __future__ import annotations

import dataclasses

from pde_tpu_torch.config import with_overrides
from pde_tpu_torch.kernels.dispatch import diffusion_weights_4, thomas_solve
from pde_tpu_torch.models._device import as_tensor, input_device


@dataclasses.dataclass(frozen=True)
class Diffusion4Params:
    """Defaults from Diffusion4_v10.m:36-37 (as ``pde_tpu``'s)."""

    alpha: float = 25.0
    outer_iter: int = 5


def params_from_reference(obj) -> Diffusion4Params:
    """This package's ``Diffusion4Params`` from any dataclass instance or
    dict with its field names. Unknown names raise ``TypeError``."""
    values = dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) else dict(obj)
    return with_overrides(Diffusion4Params(), **values)


def _diffuse(x, alpha: float, outer_iter: int):
    """``outer_iter + 1`` split iterations of a (C, H, W) image."""
    u = x
    for _ in range(outer_iter + 1):
        ww, wn, we, ws = diffusion_weights_4(u, eps=1e-5, combine="max", zero_borders=True)
        ver = thomas_solve(-alpha * wn, 2.0 + alpha * (wn + ws), -alpha * ws, u, axis=-2)
        hor = thomas_solve(-alpha * ww, 2.0 + alpha * (ww + we), -alpha * we, u, axis=-1)
        u = ver + hor
    return u


def diffusion4(img, params: Diffusion4Params | None = None, device=None, **overrides):
    """img: (C, H, W) or (H, W) float32 in the 0-255 domain, as a numpy
    array or a tensor. Returns the same shape on the device of ``img`` if
    it is a tensor, else on ``device``, else on the CUDA card (raises where
    there is none)."""
    p = with_overrides(params or Diffusion4Params(), **overrides)
    x = as_tensor(img, input_device(img, device))
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    out = _diffuse(x, p.alpha, p.outer_iter)
    return out[0] if squeeze else out
