"""MATLAB-compatible ``imresize`` as two dense float32 matrix products.

``resize_matrix`` is the NumPy construction of ``pde_tpu/core/resize.py``
(output mapping ``u = x/scale + 0.5*(1 - 1/scale)``, triangle or cubic
kernel, antialiasing on downscale, mirror-folded edge taps). The JAX package
contracts at ``Precision.HIGHEST``; here the products stay in full
float32 as long as ``torch.backends.cuda.matmul.allow_tf32`` is False,
its default, which callers must not change.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _triangle(t):
    return np.maximum(0.0, 1.0 - np.abs(t))


def _cubic(t):
    """MATLAB imresize 'bicubic' kernel (Keys, a = -0.5), support [-2, 2]."""
    a = np.abs(t)
    a2, a3 = a * a, a * a * a
    return np.where(
        a <= 1.0,
        1.5 * a3 - 2.5 * a2 + 1.0,
        np.where(a <= 2.0, -0.5 * a3 + 2.5 * a2 - 4.0 * a + 2.0, 0.0),
    )


@functools.lru_cache(maxsize=None)
def resize_matrix(
    in_size: int, out_size: int, antialias: bool = True, kernel: str = "triangle"
) -> np.ndarray:
    """(out_size, in_size) row-stochastic resampling matrix, MATLAB imresize rules."""
    scale = out_size / in_size
    use_aa = antialias and scale < 1.0
    kscale = scale if use_aa else 1.0
    kern, base_radius = (_cubic, 2.0) if kernel == "cubic" else (_triangle, 1.0)
    radius = base_radius / kscale  # kernel radius after antialias stretching

    x = np.arange(1, out_size + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1.0 - 1.0 / scale)  # 1-based input-space centers

    left = np.floor(u - radius)
    kwidth = int(np.ceil(radius) * 2 + 2)
    idx = left[:, None] + np.arange(kwidth)[None, :]  # candidate taps (1-based)
    dist = u[:, None] - idx
    # antialias: kscale * h(kscale * t)
    w = kscale * kern(kscale * dist)
    wsum = w.sum(axis=1, keepdims=True)
    w = w / np.where(wsum == 0, 1.0, wsum)

    # fold out-of-range taps with symmetric (mirror) boundary, as MATLAB's
    # imresize does: aux = [1:n, n:-1:1]; idx = aux(mod(idx-1, 2n)+1)
    aux = np.concatenate([np.arange(in_size), np.arange(in_size - 1, -1, -1)])
    idx_fold = aux[np.mod(idx.astype(np.int64) - 1, 2 * in_size)]
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.repeat(np.arange(out_size), kwidth)
    np.add.at(mat, (rows, idx_fold.ravel()), w.ravel())
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _device_matrix(in_size: int, out_size: int, kernel: str, device: torch.device) -> torch.Tensor:
    """``resize_matrix`` on ``device``, copied there once (a copy from the
    host waits for the card, and cannot be captured into a CUDA graph).
    Never evicted: a captured frame (``models/_graph.py``) reads these
    tensors at every replay."""
    return torch.from_numpy(resize_matrix(in_size, out_size, True, kernel)).to(device)


def imresize(x: torch.Tensor, out_size: tuple[int, int], method: str = "bilinear") -> torch.Tensor:
    """Resize (..., H, W) to (..., out_h, out_w) with MATLAB imresize semantics.

    method: 'bilinear'/'triangle' (the same triangle kernel; antialias
    iff downscaling) or 'bicubic' (MATLAB's Keys cubic, likewise); any
    other name takes the triangle kernel, as in ``pde_tpu``.
    """
    out_h, out_w = out_size
    h, w = x.shape[-2:]
    kernel = "cubic" if method == "bicubic" else "triangle"
    r = _device_matrix(h, out_h, kernel, x.device)
    c = _device_matrix(w, out_w, kernel, x.device)
    y = torch.matmul(r, x.to(torch.float32))
    return torch.matmul(y, c.T)


def imresize_scale(x: torch.Tensor, scale: float, method: str = "bilinear") -> torch.Tensor:
    """MATLAB ``imresize(x, scale)``: output size = ceil(in * scale)."""
    h, w = x.shape[-2:]
    return imresize(x, (int(np.ceil(h * scale)), int(np.ceil(w * scale))), method)


def imresize_nan(x: torch.Tensor, out_size: tuple[int, int], method: str = "bilinear") -> torch.Tensor:
    """NaN-propagating resize with MATLAB locality.

    :func:`imresize` is a dense matmul, where ``0 * NaN = NaN`` would spread
    one NaN across the whole axis; MATLAB propagates NaN only to outputs whose
    kernel support touches it. So the zero-filled values and the NaN
    indicator are resized apart, and an output is NaN where the indicator
    picked up any weight.
    """
    nanmask = torch.isnan(x)
    vals = imresize(torch.where(nanmask, 0.0, x), out_size, method)
    touch = imresize(nanmask.to(torch.float32), out_size, method)
    return torch.where(torch.abs(touch) > 1e-6, torch.nan, vals)
