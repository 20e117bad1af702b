"""RANSAC polynomial-surface fitting, batched, ported from ``pde_tpu/ops/ransac.py``.

The reference's sequential RANSAC (SurfaceEquation.c:223-423 builds the
models, ransac.c:31-220 searches, sgels fits, :376-386) as one batch:

* all ``iters`` hypotheses are drawn at once, k+1 pixels each, uniformly
  with replacement over the mask, from a draw source (``draws.categorical``,
  or ``idx=`` given by the caller);
* each minimal sample is solved by the least squares ``jnp.linalg.lstsq``
  computes: an SVD pseudo-inverse that drops singular values below
  ``eps * max(m, n) * s[0]``, in float32, over the whole batch at once;
* inliers are counted and their errors summed over the full grid under the
  mask, so shapes stay static;
* selection as the reference: a model is licit when its inlier count is at
  least ``floor(cset * n_data + 0.5)``; the licit model with the smallest
  error sum wins, and with no licit model the largest count wins, the first
  index on a tie. A warm model competes as hypothesis 0 (ransac.c:109-144).

Leading dimensions of ``mask`` (and ``model_in``, ``idx``) are independent
fits over one ``data`` field: ``pde_tpu``'s ``vmap`` over segments.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_EPS32 = float(np.finfo(np.float32).eps)  # times max(m, n): jnp.linalg.lstsq's rcond


def surface_features(h: int, w: int, order: int, device=None) -> torch.Tensor:
    """(H, W, k) design features; 1-based coordinates as MATLAB's meshgrid.

    order 1: [X, Y, 1]; order 2: [X^2, Y^2, XY, X, Y, 1]
    (DispSegmentation.m:341-359).
    """
    y, x = torch.meshgrid(torch.arange(1, h + 1, dtype=torch.float32, device=device),
                          torch.arange(1, w + 1, dtype=torch.float32, device=device),
                          indexing="ij")
    one = torch.ones_like(x)
    if order == 1:
        return torch.stack([x, y, one], dim=-1)
    return torch.stack([x * x, y * y, x * y, x, y, one], dim=-1)


def surface_eval(features: torch.Tensor, model: torch.Tensor) -> torch.Tensor:
    """(H, W, k) @ (k,) -> (H, W) surface height."""
    return features @ model


def _norm_params(h: int, w: int):
    """Map 1-based pixel coordinates onto [-1, 1] (cx, sx, cy, sy)."""
    cx = (w + 1) / 2.0
    sx = max((w - 1) / 2.0, 1.0)
    cy = (h + 1) / 2.0
    sy = max((h - 1) / 2.0, 1.0)
    return cx, sx, cy, sy


def _model_to_norm(m, cx, sx, cy, sy, k: int):
    """Coefficients (..., k) in the original coordinates -> the normalized
    ones (substitute x = sx*u + cx, y = sy*v + cy)."""
    if k == 3:
        a, b, c = m.unbind(-1)
        return torch.stack([a * sx, b * sy, a * cx + b * cy + c], dim=-1)
    a, b, c, d, e, f = m.unbind(-1)
    return torch.stack([
        a * sx * sx,
        b * sy * sy,
        c * sx * sy,
        2.0 * a * sx * cx + c * sx * cy + d * sx,
        2.0 * b * sy * cy + c * sy * cx + e * sy,
        a * cx * cx + b * cy * cy + c * cx * cy + d * cx + e * cy + f,
    ], dim=-1)


def _model_from_norm(m, cx, sx, cy, sy, k: int):
    """Normalized-coordinate coefficients (..., k) -> 1-based pixel ones."""
    if k == 3:
        a, b, c = m.unbind(-1)
        return torch.stack([a / sx, b / sy, c - a * cx / sx - b * cy / sy], dim=-1)
    a, b, c, d, e, f = m.unbind(-1)
    axx = a / (sx * sx)
    byy = b / (sy * sy)
    cxy = c / (sx * sy)
    dx = -2.0 * a * cx / (sx * sx) - c * cy / (sx * sy) + d / sx
    ey = -2.0 * b * cy / (sy * sy) - c * cx / (sx * sy) + e / sy
    f0 = (a * cx * cx / (sx * sx) + b * cy * cy / (sy * sy)
          + c * cx * cy / (sx * sy) - d * cx / sx - e * cy / sy + f)
    return torch.stack([axx, byy, cxy, dx, ey, f0], dim=-1)


@functools.lru_cache(maxsize=64)
def _norm_features(h: int, w: int, k: int, device: torch.device) -> torch.Tensor:
    """(H*W, k) features in normalized coordinates, on ``device``."""
    cx, sx, cy, sy = _norm_params(h, w)
    y, x = torch.meshgrid(torch.arange(1, h + 1, dtype=torch.float32, device=device),
                          torch.arange(1, w + 1, dtype=torch.float32, device=device),
                          indexing="ij")
    u = ((x - cx) / sx).reshape(-1)
    v = ((y - cy) / sy).reshape(-1)
    one = torch.ones_like(u)
    if k == 3:
        return torch.stack([u, v, one], dim=-1)
    return torch.stack([u * u, v * v, u * v, u, v, one], dim=-1)


def lstsq_pinv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Least squares of the batch ``a`` (..., m, n), ``b`` (..., m) as
    ``jnp.linalg.lstsq`` computes it: the SVD pseudo-inverse without the
    singular values below ``eps * max(m, n) * s[0]``. Rank-deficient systems
    (collinear or repeated points) get the minimum-norm solution.

    ``torch.linalg.lstsq`` is not used: its drivers differ between the CPU
    and the card, and ``gels`` assumes full rank."""
    m, n = a.shape[-2:]
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    # rcond rounded to float32 first, as jnp.array(rcond, s.dtype); a Python
    # scalar costs no host-to-device copy
    cut = s[..., :1] * float(np.float32(_EPS32 * max(m, n)))
    keep = (s > 0) & (s >= cut)
    s_inv = torch.where(keep, 1 / torch.where(keep, s, 1.0), 0.0)
    utb = (u.mT @ b[..., None])[..., 0]
    return (vh.mT @ (s_inv * utb)[..., None])[..., 0]


def ransac_surface(key, data, mask, features, err_thr, cset, iters: int, model_in=None,
                   idx=None):
    """Fit ``surface_eval(features, model) ~= data`` on the ``mask`` pixels.

    key: the draw source (an object with ``categorical(mask, iters, ns)``,
    such as ``models.segmentation.TorchDraws``), unused when ``idx`` is
    given; data: (H, W) float32; mask: (..., H, W) bool (the segment H1;
    leading dimensions are independent fits); features: (H, W, k) from
    :func:`surface_features` (only its shape is read); err_thr: inlier
    threshold on the squared residual as err_thr^2 (ransac.c:60); cset:
    consensus fraction of the masked pixel count; model_in: optional (..., k)
    warm start (NaN or zeros: none, the reference's empty-model convention);
    idx: optional (..., iters, k+1) linear pixel indices of the hypotheses'
    samples, in place of drawing them.

    Returns (model (..., k), err (..., H, W) squared residuals of the winner).
    """
    h, w, k = features.shape[-3:]
    batch = mask.shape[:-2]
    dev = data.device
    # fit in coordinates mapped onto [-1, 1] (pde_tpu's reason: raw quadric
    # features make the float32 least squares of clustered samples
    # ill-conditioned); models go back to 1-based pixel coordinates on return
    cx, sx, cy, sy = _norm_params(h, w)
    feats = _norm_features(h, w, k, dev)
    d = data.reshape(-1)
    m = mask.reshape(*batch, h * w)
    n_data = m.sum(dim=-1)
    min_set = torch.floor(cset * n_data.to(torch.float32) + 0.5)
    err_thr2 = err_thr * err_thr

    # k+1 points a hypothesis as the reference (SurfaceEquation.c:218): one
    # point over the minimum resists degenerate draws
    ns = k + 1
    if idx is None:
        idx = key.categorical(mask, iters, ns)
    idx = idx.to(device=dev, dtype=torch.int64)
    models = lstsq_pinv(feats[idx], d[idx])  # (..., iters, k)

    if model_in is not None:
        warm = torch.as_tensor(model_in, dtype=torch.float32, device=dev)
        has_warm = torch.isfinite(warm).all(dim=-1) & (warm != 0.0).any(dim=-1)
        warm_n = _model_to_norm(warm, cx, sx, cy, sy, k)
        first = torch.where(has_warm[..., None], warm_n, models[..., 0, :])
        models = torch.cat([first[..., None, :], models], dim=-2)

    # score every hypothesis over the whole grid: (..., hypotheses, H*W)
    err = models @ feats.T
    err.sub_(d).square_()
    inlier = (err <= err_thr2) & m[..., None, :]
    counts = inlier.sum(dim=-1)
    err_sums = err.masked_fill_(~inlier, 0.0).sum(dim=-1)
    del err, inlier

    licit = counts >= min_set[..., None]
    licit_cost = torch.where(licit, err_sums, torch.inf)
    winner = torch.where(licit.any(dim=-1), torch.argmin(licit_cost, dim=-1),
                         torch.argmax(counts, dim=-1))
    model_n = torch.gather(models, -2, winner[..., None, None].expand(*batch, 1, k))[..., 0, :]
    err = ((feats @ model_n[..., None])[..., 0] - d) ** 2
    return _model_from_norm(model_n, cx, sx, cy, sy, k), err.reshape(*batch, h, w)
