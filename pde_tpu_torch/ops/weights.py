"""Diffusion weights (``pde_tpu/ops/weights.py``): the Brox 6-point
isotropic ``diffusion_weights_4`` and the 8-neighbour anisotropic
``tensor_diffusion_weights_8`` with its quantile-adaptive lambda
(FlowEminAD_llin_2D_v10.m:416-488, TVdenoise8.m:119-231).

Neighbour averaging uses MATLAB ``circshift`` wrap-around semantics
(``torch.roll``): the wrapped values land only on the 1-px border ring,
which the flow solvers relax as unknowns, so wrap-vs-replicate there is a
measurable difference.
"""

from __future__ import annotations

import math

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


_S2 = math.sqrt(2.0)
# Alvarez derivative operators; the reference applies them with
# imfilter(..., 'conv'), i.e. flipped, so the rot180'd kernels are stored
# and correlated (FlowEminAD_llin_2D_v10.m:430-445)
ALVAREZ_DX = np.array(
    [[-1.0, 0.0, 1.0], [-_S2, 0.0, _S2], [-1.0, 0.0, 1.0]], dtype=np.float32
) / (4.0 + math.sqrt(8.0))
ALVAREZ_DY = np.array(
    [[-1.0, -_S2, -1.0], [0.0, 0.0, 0.0], [1.0, _S2, 1.0]], dtype=np.float32
) / (4.0 + math.sqrt(8.0))
SOBEL_DX = np.array(
    [[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], dtype=np.float32
) / 8.0
SOBEL_DY = SOBEL_DX.T


def _quantile_nonzero(nrm: torch.Tensor, quantile: float) -> torch.Tensor:
    """MATLAB-style adaptive lambda: the ``round(nnz*q)``-th smallest of
    the non-zero entries (FlowEminAD_llin_2D_v10.m:462-471), an exact
    order statistic from a sort on every device; 1.0 when no entry is
    non-zero. ``nnz*q`` is taken in float32 and rounded half to even, as
    ``pde_tpu`` does. A 0-d tensor on ``nrm``'s device (no host sync)."""
    flat = nrm.reshape(-1)
    n = flat.numel()
    nz = (flat > 0).sum()
    # 0-based rank among all entries (the zeros take the first n - nz)
    k = (n - nz) + torch.round(nz.to(torch.float32) * quantile).to(torch.int64) - 1
    # a gather, not ``values[k]``: a 0-d index tensor is read on the host
    val = torch.sort(flat).values.gather(0, k.clamp(0, n - 1).reshape(1)).reshape(())
    return torch.where(nz > 0, val, torch.ones_like(val))


def tensor_diffusion_weights_8(
    fields: torch.Tensor,
    quantile: float = 0.9,
    operator: str = "alvarez",
    zero_borders: bool = False,
):
    """Anisotropic 8-neighbour stencil weights (W, NW, N, NE, E, SE, S, SW)
    from (C, H, W) or (H, W) fields: the diffusion tensor
    ``1/(|dI|^2 + 2 lambda) [[dy^2 + lambda, -dx dy], [-dx dy, dx^2 + lambda]]``
    of the channel with the largest gradient norm at each pixel (the first
    on ties), its entries averaged with each neighbour's. ``operator`` is
    "alvarez" or "sobel"; ``zero_borders`` zeroes every weight whose
    neighbour is off the image. Returns eight (H, W) tensors."""
    if fields.ndim == 2:
        fields = fields[None]
    dx = imfilter_replicate(fields, ALVAREZ_DX if operator == "alvarez" else SOBEL_DX)
    dy = imfilter_replicate(fields, ALVAREZ_DY if operator == "alvarez" else SOBEL_DY)

    norm = dx * dx + dy * dy
    amax = torch.argmax(norm, dim=0, keepdim=True)
    max_dx = torch.gather(dx, 0, amax)[0]
    max_dy = torch.gather(dy, 0, amax)[0]
    nrm = max_dx * max_dx + max_dy * max_dy

    lam = _quantile_nonzero(nrm, quantile)

    multip = 1.0 / (nrm + 2.0 * lam)
    dyy = multip * (max_dy * max_dy + lam)
    dxx = multip * (max_dx * max_dx + lam)
    dxy = -multip * (max_dx * max_dy)

    w_ = 0.5 * (dyy + _cs_w(dyy))
    nw = 0.25 * (dxy + _cs_n(_cs_w(dxy)))
    n_ = 0.5 * (dxx + _cs_n(dxx))
    ne = -0.25 * (dxy + _cs_n(_cs_e(dxy)))
    e_ = 0.5 * (dyy + _cs_e(dyy))
    se = 0.25 * (dxy + _cs_s(_cs_e(dxy)))
    s_ = 0.5 * (dxx + _cs_s(dxx))
    sw = -0.25 * (dxy + _cs_s(_cs_w(dxy)))

    if zero_borders:
        w_[:, 0] = 0.0
        e_[:, -1] = 0.0
        n_[0, :] = 0.0
        s_[-1, :] = 0.0
        for wt, col in ((nw, 0), (ne, -1), (sw, 0), (se, -1)):
            wt[:, col] = 0.0
        for wt, row in ((nw, 0), (ne, 0), (sw, -1), (se, -1)):
            wt[row, :] = 0.0
    return w_, nw, n_, ne, e_, se, s_, sw
