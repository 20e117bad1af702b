"""Brox 6-point isotropic diffusion weights (``pde_tpu/ops/weights.py``).

Neighbour averaging uses MATLAB ``circshift`` wrap-around semantics
(``torch.roll``): the wrapped values land only on the 1-px border ring,
which the flow solvers relax as unknowns, so wrap-vs-replicate there is a
measurable difference.
"""

from __future__ import annotations

import numpy as np
import torch

from pde_tpu_torch.core.conv import imfilter_replicate


def _cs_w(x):  # value of the west neighbour, wrapping (circshift [0 1])
    return torch.roll(x, 1, dims=-1)


def _cs_e(x):
    return torch.roll(x, -1, dims=-1)


def _cs_n(x):
    return torch.roll(x, 1, dims=-2)


def _cs_s(x):
    return torch.roll(x, -1, dims=-2)


_CDIFF = np.array([0.25, 0.0, -0.25], dtype=np.float32)


def _central_diffs(f: torch.Tensor):
    """0.25*(prev - next) central differences, replicate borders."""
    fver = imfilter_replicate(f, _CDIFF[:, None])  # along rows (vertical)
    fhor = imfilter_replicate(f, _CDIFF[None, :])  # along cols (horizontal)
    return fver, fhor


def diffusion_weights_4(
    fields: torch.Tensor,
    eps: float = 1e-5,
    combine: str = "sum",
    zero_borders: bool = False,
):
    """Brox 6-pt diffusion weights (wW, wN, wE, wS) from (C, H, W) fields.

    combine='sum': add squared differences over the field axis (flow U,V).
    combine='max': max over the field axis (denoise / disparity channels).
    zero_borders: zero the out-facing edge of each directional weight.
    Returns four (H, W) tensors.
    """
    if fields.ndim == 2:
        fields = fields[None]
    fver, fhor = _central_diffs(fields)

    def sq(d, g):
        return d * d + g * g

    ww = sq(_cs_w(fields) - fields, fver + _cs_w(fver))
    we = sq(_cs_e(fields) - fields, fver + _cs_e(fver))
    wn = sq(_cs_n(fields) - fields, fhor + _cs_n(fhor))
    ws = sq(_cs_s(fields) - fields, fhor + _cs_s(fhor))

    if combine == "sum":
        ww, we, wn, ws = (w.sum(dim=0) for w in (ww, we, wn, ws))
    else:
        ww, we, wn, ws = (w.amax(dim=0) for w in (ww, we, wn, ws))

    ww, we, wn, ws = (1.0 / torch.sqrt(w + eps) for w in (ww, we, wn, ws))

    if zero_borders:
        ww[:, 0] = 0.0
        we[:, -1] = 0.0
        wn[0, :] = 0.0
        ws[-1, :] = 0.0
    return ww, wn, we, ws
