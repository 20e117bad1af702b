"""The plain PyTorch arithmetic that the references of the warping
pipelines share (``bench_gpu/reference/<configuration>.py``):

- the pyramid (bilinear resize of the unsmoothed level by the scale
  factor, each kept level Gaussian-smoothed, MATLAB ``imresize`` as two
  matrix products in float32);
- the bilinear warp (1-based coordinates, NaN outside the image);
- the 5-tap derivative tensors and the [1 0 -1] gradient images;
- the robust weights and Brox's 6-point diffusion weights;
- the red-black SOR solves in torch ops;
- the 3x3 median.

A frozen, self-contained copy of the arithmetic: it imports nothing of
the program under test, and it takes nothing the program made, only the
uint8 images.

``precision="tf32"`` runs the resize products in TF32: on a CUDA tensor
with ``torch.backends.cuda.matmul.allow_tf32`` on, on a CPU tensor by
rounding both operands to TF32's 10-bit mantissa. It is the comparison's
control, one step below the configurations' float32 with TF32 off.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F

PRECISIONS = ("float32", "tf32")

# --------------------------------------------------------------------------
# resize and filters
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) MATLAB ``imresize`` matrix, triangle kernel,
    antialiased on downscale, mirror-folded edge taps."""
    scale = out_size / in_size
    kscale = scale if scale < 1.0 else 1.0
    radius = 1.0 / kscale
    u = np.arange(1, out_size + 1, dtype=np.float64) / scale + 0.5 * (1.0 - 1.0 / scale)
    left = np.floor(u - radius)
    kwidth = int(np.ceil(radius) * 2 + 2)
    idx = left[:, None] + np.arange(kwidth)[None, :]
    w = kscale * np.maximum(0.0, 1.0 - np.abs(kscale * (u[:, None] - idx)))
    wsum = w.sum(axis=1, keepdims=True)
    w = w / np.where(wsum == 0, 1.0, wsum)
    aux = np.concatenate([np.arange(in_size), np.arange(in_size - 1, -1, -1)])
    folded = aux[np.mod(idx.astype(np.int64) - 1, 2 * in_size)]
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    np.add.at(mat, (np.repeat(np.arange(out_size), kwidth), folded.ravel()), w.ravel())
    return mat.astype(np.float32)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Resizer:
    """``imresize`` on one device at one precision, its matrices copied
    there once."""

    def __init__(self, device, precision: str = "float32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
        self.device = torch.device(device)
        self.precision = precision
        self._mats: dict = {}

    def _mat(self, n_in: int, n_out: int) -> torch.Tensor:
        key = (n_in, n_out)
        if key not in self._mats:
            self._mats[key] = torch.from_numpy(resize_matrix(n_in, n_out)).to(self.device)
        return self._mats[key]

    def _matmul(self, a, b):
        if self.precision == "tf32" and a.device.type == "cpu":
            return torch.matmul(_tf32(a), _tf32(b))
        return torch.matmul(a, b)

    def __call__(self, x: torch.Tensor, out_size) -> torch.Tensor:
        out_h, out_w = out_size
        h, w = x.shape[-2:]
        y = self._matmul(self._mat(h, out_h), x)
        return self._matmul(y, self._mat(w, out_w).T)


@contextlib.contextmanager
def matmul_precision(precision: str):
    """TF32 matrix products on the card within the block for "tf32", full
    float32 for "float32"; the previous setting is restored."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def pyramid_scales(h: int, w: int, scl_factor: float, stop: int, max_scales: int = 10**9):
    """(H, W) of each level, finest first: shrink by ``scl_factor`` (ceil)
    until a side is at most ``stop``."""
    sizes = [(h, w)]
    while len(sizes) < max_scales:
        ph, pw = sizes[-1]
        nh, nw = int(np.ceil(ph * scl_factor)), int(np.ceil(pw * scl_factor))
        sizes.append((nh, nw))
        if nh <= stop or nw <= stop:
            break
    return sizes


def imfilter(x: torch.Tensor, kernel) -> torch.Tensor:
    """Correlation with a 2-D (a 1-D acts along W) odd kernel, replicate
    borders, zero taps skipped (a NaN under a zero tap stays out)."""
    k = np.asarray(kernel, dtype=np.float32)
    if k.ndim == 1:
        k = k[None, :]
    kh, kw = k.shape
    *lead, h, w = x.shape
    xp = F.pad(x.reshape(-1, h, w), (kw // 2, kw // 2, kh // 2, kh // 2), mode="replicate")
    xp = xp.reshape(*lead, h + kh - 1, w + kw - 1)
    out = None
    for i in range(kh):
        for j in range(kw):
            if float(k[i, j]) == 0.0:
                continue
            term = xp[..., i:i + h, j:j + w] * float(k[i, j])
            out = term if out is None else out + term
    return out


def _sep(x, kv=None, kh=None):
    if kv is not None:
        x = imfilter(x, np.asarray(kv, dtype=np.float32)[:, None])
    if kh is not None:
        x = imfilter(x, np.asarray(kh, dtype=np.float32)[None, :])
    return x


def _gaussian(size: int, sigma: float) -> np.ndarray:
    xs = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(xs**2) / (2.0 * sigma**2))
    g2 = np.outer(g, g)
    return (g2 / g2.sum()).astype(np.float32)


def build_pyramid(images, scl_factor: float, stop: int, resize, max_scales: int):
    """``levels[k][i]``: level k (finest 0) of image i, smoothed 5x5, σ 1.25."""
    h, w = images[0].shape[-2:]
    sizes = pyramid_scales(h, w, scl_factor, stop, max_scales)
    raw = [list(images)]
    for nh, nw in sizes[1:]:
        raw.append([resize(x, (nh, nw)) for x in raw[-1]])
    g = _gaussian(5, 1.25)
    return [[imfilter(x, g) for x in lvl] for lvl in raw]


# --------------------------------------------------------------------------
# data terms, warp, weights, median
# --------------------------------------------------------------------------

SMOOTH5 = np.array([0.037659, 0.249724, 0.439911, 0.249724, 0.037659], dtype=np.float32)
FST5 = np.array([-0.104550, -0.292315, 0.0, 0.292315, 0.104550], dtype=np.float32)
SND5 = np.array([0.232905, 0.002668, -0.471147, 0.002668, 0.232905], dtype=np.float32)
CDIFF = np.array([0.25, 0.0, -0.25], dtype=np.float32)


def fst_derivatives(i0, i1w):
    """(Idt, Idx, Idy): temporal half-difference, derivatives of the warped frame."""
    return (0.5 * (i0 - i1w), _sep(_sep(i1w, SMOOTH5), None, FST5),
            _sep(_sep(i1w, None, SMOOTH5), FST5))


def snd_derivatives(i0, i1w):
    """(Idxt, Idyt, Idxx, Idyy, Idxy)."""
    def dx(img):
        return _sep(_sep(img, SMOOTH5), None, FST5)

    def dy(img):
        return _sep(_sep(img, None, SMOOTH5), FST5)

    return (0.5 * (dx(i0) - dx(i1w)), 0.5 * (dy(i0) - dy(i1w)),
            _sep(_sep(i1w, SMOOTH5), None, SND5), _sep(_sep(i1w, None, SMOOTH5), SND5),
            _sep(_sep(i1w, None, FST5), FST5))


def rgb2grad(img):
    """(C, H, W) -> (2C, H, W): [1 0 -1] x and y gradients, interleaved."""
    k = np.array([1.0, 0.0, -1.0], dtype=np.float32)
    c, h, w = img.shape
    return torch.stack([imfilter(img, k[None, :]), imfilter(img, k[:, None])],
                       dim=1).reshape(2 * c, h, w)


def warp(img, dx, dy):
    """Sample (..., H, W) ``img`` at (X + dx, Y + dy), 1-based, bilinear,
    NaN where the base cell leaves the image."""
    h, w = img.shape[-2:]
    yy, xx = torch.meshgrid(torch.arange(1, h + 1, device=img.device, dtype=torch.float32),
                            torch.arange(1, w + 1, device=img.device, dtype=torch.float32),
                            indexing="ij")
    x = xx + dx
    y = yy + dy
    x0f, y0f = torch.floor(x - 1.0), torch.floor(y - 1.0)
    valid = (x0f >= 0) & (x0f <= w - 1) & (y0f >= 0) & (y0f <= h - 1)
    xf, yf = x - 1.0 - x0f, y - 1.0 - y0f
    x0 = torch.clamp(torch.nan_to_num(x0f), 0, w - 1).long()
    y0 = torch.clamp(torch.nan_to_num(y0f), 0, h - 1).long()
    x1, y1 = torch.clamp(x0 + 1, max=w - 1), torch.clamp(y0 + 1, max=h - 1)
    out = ((1.0 - xf) * (1.0 - yf) * img[..., y0, x0] + xf * (1.0 - yf) * img[..., y0, x1]
           + (1.0 - xf) * yf * img[..., y1, x0] + xf * yf * img[..., y1, x1])
    return torch.where(valid, out, torch.full_like(out, float("nan")))


def diffusion_weights(fields, combine: str, zero_borders: bool):
    """Brox's 6-point weights (wW, wN, wE, wS) of (C, H, W) ``fields``:
    squared differences summed or maxed over C, ``1/sqrt(. + 1e-5)``;
    neighbours by wrap-around shifts (MATLAB ``circshift``)."""
    if fields.ndim == 2:
        fields = fields[None]
    fver = imfilter(fields, CDIFF[:, None])
    fhor = imfilter(fields, CDIFF[None, :])

    def weight(dim, step, g):
        d = torch.roll(fields, step, dims=dim) - fields
        g2 = g + torch.roll(g, step, dims=dim)
        s = d * d + g2 * g2
        s = s.sum(dim=0) if combine == "sum" else s.amax(dim=0)
        return 1.0 / torch.sqrt(s + 1e-5)

    ww, we = weight(-1, 1, fver), weight(-1, -1, fver)
    wn, ws = weight(-2, 1, fhor), weight(-2, -1, fhor)
    if zero_borders:
        ww[:, 0] = 0.0
        we[:, -1] = 0.0
        wn[0, :] = 0.0
        ws[-1, :] = 0.0
    return ww, wn, we, ws


def medfilt3(x):
    """3x3 median, symmetric padding (the edge pixel mirrored in)."""
    h, w = x.shape[-2:]
    xp = torch.cat([x[..., :1, :], x, x[..., -1:, :]], dim=-2)
    xp = torch.cat([xp[..., :, :1], xp, xp[..., :, -1:]], dim=-1)
    stack = torch.stack([xp[..., i:i + h, j:j + w] for i in range(3) for j in range(3)])
    return torch.sort(stack, dim=0).values[4]


# --------------------------------------------------------------------------
# red-black SOR
# --------------------------------------------------------------------------


def _shift(x, dim, step):
    """The neighbour's value (``step`` -1: the previous index), clamped at the edge."""
    n = x.shape[dim]
    if step < 0:
        return torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim=dim)
    return torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim=dim)


def _nbr(x, ww, wn, we, ws):
    return (_shift(x, -1, -1) * ww + _shift(x, -1, 1) * we + _shift(x, -2, -1) * wn
            + _shift(x, -2, 1) * ws)


def _colours(h, w, device, interior: bool):
    ii = torch.arange(h, device=device)[:, None]
    jj = torch.arange(w, device=device)[None, :]
    red = ((ii + jj) % 2) == 0
    if interior:
        inner = (ii > 0) & (ii < h - 1) & (jj > 0) & (jj < w - 1)
        return red & inner, ~red & inner
    return red, ~red


def sor_flow(u, v, du, dv, m, cu, cv, duc, dvc, ww, wn, we, ws, iters, omega):
    """Late-linearisation flow SOR: out-facing weights zeroed, every pixel
    relaxed; u first in a colour, then v from the refreshed u; NaN Cu/Cv
    drops the data term, NaN Du/Dv drops it from the divisor."""
    ww, wn, we, ws = (x.clone() for x in (ww, wn, we, ws))
    ww[:, 0] = 0.0
    wn[0, :] = 0.0
    we[:, -1] = 0.0
    ws[-1, :] = 0.0
    wsum = ww + wn + we + ws
    cu_nan, cv_nan = torch.isnan(cu), torch.isnan(cv)
    cu0, cv0, m0 = torch.nan_to_num(cu), torch.nan_to_num(cv), torch.nan_to_num(m)
    inv_u = 1.0 / (wsum + torch.nan_to_num(duc))
    inv_v = 1.0 / (wsum + torch.nan_to_num(dvc))
    for _ in range(iters):
        for mask in _colours(*m.shape, m.device, interior=False):
            su = _nbr(du + u, ww, wn, we, ws) - u * wsum
            sv = _nbr(dv + v, ww, wn, we, ws) - v * wsum
            num_u = torch.where(cu_nan, su, su + cu0 - m0 * dv)
            du = torch.where(mask, (1.0 - omega) * du + omega * num_u * inv_u, du)
            num_v = torch.where(cv_nan, sv, sv + cv0 - m0 * du)
            dv = torch.where(mask, (1.0 - omega) * dv + omega * num_v * inv_v, dv)
    return du, dv


def _fill_border(x):
    x = torch.cat([x[..., 1:2, :], x[..., 1:-1, :], x[..., -2:-1, :]], dim=-2)
    return torch.cat([x[..., :, 1:2], x[..., :, 1:-1], x[..., :, -2:-1]], dim=-1)


def sor_disp(u, du, cu, duc, ww, wn, we, ws, iters, omega):
    """Scalar late-linearisation SOR: interior pixels only, colour 0 then 1,
    the border replicated after every sweep; NaN Cu is pure diffusion."""
    wsum = ww + wn + we + ws
    cu_nan, cu0 = torch.isnan(cu), torch.nan_to_num(cu)
    inv = 1.0 / (wsum + torch.nan_to_num(duc))
    for _ in range(iters):
        for mask in _colours(*u.shape, u.device, interior=True):
            s = _nbr(du + u, ww, wn, we, ws) - u * wsum
            num = torch.where(cu_nan, s, s + cu0)
            du = torch.where(mask, (1.0 - omega) * du + omega * num * inv, du)
        du = _fill_border(du)
    return du


# --------------------------------------------------------------------------
# the pipelines


# --------------------------------------------------------------------------
# what the pipelines share
# --------------------------------------------------------------------------


def check_options(params: dict, **allowed):
    """Raise unless each option of ``allowed`` has its value in ``params``
    (an option left out of ``params`` takes that value)."""
    for key, value in allowed.items():
        if params.get(key, value) != value:
            raise ValueError(f"this reference has {key} = {value!r} only, not "
                             f"{params[key]!r}")


def images(a, b, device, fst_term, snd_term, scl_factor, stop, resize, scales):
    """Each level (finest first) of the uint8-range pair ``a``, ``b`` as
    (first term of a, of b, second term's image of a, of b)."""
    a = torch.as_tensor(np.asarray(a, dtype=np.float32), device=device) / 255.0
    b = torch.as_tensor(np.asarray(b, dtype=np.float32), device=device) / 255.0
    if a.ndim == 2:
        a, b = a[None], b[None]
    levels = build_pyramid([a, b], scl_factor, stop, resize, scales)

    def fst(img):
        return rgb2grad(img) if fst_term == "grad" else img

    return [(fst(l0), fst(l1), None if snd_term == "none" else l0,
             None if snd_term == "none" else l1) for l0, l1 in levels]


def robust(b, alpha, op):
    """The robust data weight b / (alpha sqrt(op + 1e-5))."""
    return b / (alpha * torch.sqrt(op + 1e-5))
