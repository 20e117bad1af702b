"""Flow visualisation (HSV direction/magnitude coding, flow2color.m), a NumPy
copy of ``pde_tpu/utils/viz.py``: tensors go through the host."""

from __future__ import annotations

import numpy as np


def _hsv2rgb(hue, sat, val):
    h6 = (hue % 1.0) * 6.0
    i = np.floor(h6).astype(int) % 6
    f = h6 - np.floor(h6)
    p = val * (1 - sat)
    q = val * (1 - sat * f)
    t = val * (1 - sat * (1 - f))
    rgb = np.zeros(hue.shape + (3,))
    conds = [
        (val, t, p), (q, val, p), (p, val, t),
        (p, q, val), (t, p, val), (val, p, q),
    ]
    for k, (r, g, b) in enumerate(conds):
        m = i == k
        rgb[m, 0], rgb[m, 1], rgb[m, 2] = r[m], g[m], b[m]
    return rgb.astype(np.float32)


def flow2color(u: np.ndarray, v: np.ndarray, max_mag: float | None = None,
               border: int = 0) -> np.ndarray:
    """(H, W) flow -> (H', W', 3) float RGB in [0,1].

    Hue encodes direction, value magnitude (saturation 1); non-finite or
    over-max pixels render white (hue=1, sat=0, val=1), as in
    matlab/optical_flow/flow2color.m:36-57. ``border > 0`` frames the
    image with the directional color-code legend (a synthetic radial
    flow field spanning [-5, 5], :25-34,61-66); output grows by
    2*border per side, the flow image pasted at offset border-1
    (1-based :64).
    """
    u = np.asarray(u.cpu() if hasattr(u, "cpu") else u, dtype=np.float64)
    v = np.asarray(v.cpu() if hasattr(v, "cpu") else v, dtype=np.float64)
    rows, cols = u.shape
    direction = np.arctan2(-v, -u)
    direction = np.where(direction < 0, direction + 2 * np.pi, direction)
    direction = direction / (2 * np.pi)
    mag = np.sqrt(u * u + v * v)
    if max_mag is None:
        max_mag = np.nanmax(mag) or 1.0
    mag = np.minimum(mag / max_mag, 1.0)
    valid = np.isfinite(u) & np.isfinite(v) & (mag <= 1)

    hue = np.where(valid, np.nan_to_num(direction), 1.0)
    sat = np.where(valid, 1.0, 0.0)
    val = np.where(valid, np.nan_to_num(mag), 1.0)
    img = _hsv2rgb(hue, sat, val)

    if border > 0:
        brows, bcols = rows + 2 * border, cols + 2 * border
        yy, xx = np.mgrid[1:brows + 1, 1:bcols + 1].astype(np.float64)
        bx = (xx / bcols - 0.5) * 10.0
        by = (yy / brows - 0.5) * 10.0
        out = flow2color(bx, by)
        out[border - 1:border - 1 + rows, border - 1:border - 1 + cols] = img
        img = out
    return img
