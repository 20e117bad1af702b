"""Geodesic / geometric active contours (GAC_v10a.m, GAC_v10b.m), ported from
``pde_tpu/models/gac.py``.

Two Caselles models evolved with semi-implicit AOS steps:

* model "a" (1993, balloon force):
      PHI_t = |grad PHI| div(g grad PHI / |grad PHI|) + c * g * |grad PHI|
  its data term the upwinded balloon force ``c * g * |grad PHI|_UW``, with
  the Rouy-Tourin switch on the sign of c (GAC_v10a.m:93-99);
* model "b" (1997, convection):
      PHI_t = ... + grad g . grad PHI
  its data term the upwinded convection ``max(0,gdx)*D+x + min(0,gdx)*D-x
  + ...`` (GAC_v10b.m:85-92), whose differences wrap around the image
  border (the reference's ``circshift``).

Both share: an initial signed-distance reinit (T = 10: 40 Euler steps), a
7x7 sigma = 2.5 Gaussian smoothing of the image, the stopping function
``g = 1/(1 + |grad I|^2 / lambda)`` with lambda by default the 0.7 quantile
of the squared gradient (:69-75), the harmonic-average diffusivity
``Diff = |grad PHI| / g`` (:108), and one reinit(0.25) step after every AOS
update (AC_AOS_4_2d, levelsetSolvers.c:179).

Runs eagerly on the card unless the caller asks for the CPU
(``models/_device.py``). Each AOS step solves its two line sets with the
CUDA tridiagonal kernel (``tridiag_thomas``, two launches a step); the
rest is elementwise torch ops.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pde_tpu_torch.config import with_overrides
from pde_tpu_torch.core.conv import gaussian_kernel_2d, imfilter_replicate
from pde_tpu_torch.core.grid import shift_e, shift_n, shift_s, shift_w
from pde_tpu_torch.models._device import as_tensor, input_device
from pde_tpu_torch.models._graph import replay
from pde_tpu_torch.solvers.aos import ac_aos_step
from pde_tpu_torch.solvers.reinit import reinit

_EPS_D = float(np.finfo(np.float64).eps)  # MATLAB's `eps`, added in float32
_CDX = np.array([-0.5, 0.0, 0.5], dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class GACParams:
    """Defaults from GAC_v10a.m:35-44 / GAC_v10b.m:36-43 (as ``pde_tpu``'s)."""

    tau: float = 0.25
    c: float = -0.1  # balloon force (model "a" only)
    lam: float = -1.0  # lambda; negative: the 0.7 quantile of |grad I|^2
    ITER: int = 100
    SMOOTH: float = 100.0


def params_from_reference(obj) -> GACParams:
    """This package's ``GACParams`` from any dataclass instance or dict with
    its field names (such as a ``pde_tpu`` ``GACParams``). Unknown names
    raise ``TypeError``."""
    values = dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) else dict(obj)
    return with_overrides(GACParams(), **values)


def _quantile_index(n: int) -> int:
    """The 0-based index of Y(round(0.7 numel)) (GAC_v10a.m:71-74), as
    ``pde_tpu`` computes it: 0.7 N rounded in float32, half to even."""
    return max(int(np.round(np.float32(0.7 * n))) - 1, 0)


def _stopping_function(img, lam):
    """g = 1/(1 + |grad I|^2 / lambda), the derivatives the max over the
    channels."""
    if img.ndim == 2:
        img = img[None]
    smooth = imfilter_replicate(img, gaussian_kernel_2d(7, 2.5))
    idx = torch.amax(imfilter_replicate(smooth, _CDX[None, :]), dim=0)
    idy = torch.amax(imfilter_replicate(smooth, _CDX[:, None]), dim=0)
    igrad = idx * idx + idy * idy
    if lam < 0:
        flat = torch.sort(igrad.reshape(-1)).values
        lam = flat[_quantile_index(flat.numel())]
        # beyond the reference: a mostly flat image puts the 0.7 quantile at
        # 0, where the reference's g = 1/(1 + Igrad/0) is NaN; floored,
        # flat regions get g = 1 (no edge, free propagation)
        lam = torch.clamp(lam, min=_EPS_D)
    return 1.0 / (1.0 + igrad / lam)


def _phi_grad(phi):
    pdx = 0.5 * (shift_e(phi) - shift_w(phi))
    pdy = 0.5 * (shift_s(phi) - shift_n(phi))
    return torch.sqrt(pdx * pdx + pdy * pdy + _EPS_D)


def _ac_update(phi, data, g, tau, nu):
    grad_phi = _phi_grad(phi)
    diff = grad_phi / g
    phi = ac_aos_step(phi, data, grad_phi, diff, tau, nu)
    return reinit(phi, steps=1)  # the embedded reinit(PHI, 0.25)


def _pos(x):
    return torch.clamp(x, min=0.0)


def _neg(x):
    return torch.clamp(x, max=0.0)


def _gac_a_evolve(phi, g, c, tau, nu, iters: int):
    for _ in range(iters):
        fx = shift_e(phi) - phi  # forward differences ([0 -1 1])
        bx = phi - shift_w(phi)  # backward differences ([-1 1 0])
        fy = shift_s(phi) - phi
        by = phi - shift_n(phi)
        if c <= 0.0:  # shrink
            grad_uw = torch.sqrt(_pos(bx) ** 2 + _neg(fx) ** 2 + _pos(by) ** 2 + _neg(fy) ** 2)
        else:  # grow
            grad_uw = torch.sqrt(_neg(bx) ** 2 + _pos(fx) ** 2 + _neg(by) ** 2 + _pos(fy) ** 2)
        data = c * g * grad_uw
        phi = _ac_update(phi, data, g, tau, nu)
    return phi


def _gac_b_evolve(phi, g, tau, nu, iters: int):
    gdx = imfilter_replicate(g, _CDX[None, :])
    gdy = imfilter_replicate(g, _CDX[:, None])
    gdx_p, gdx_n, gdy_p, gdy_n = _pos(gdx), _neg(gdx), _pos(gdy), _neg(gdy)
    for _ in range(iters):
        # the reference builds these differences with circshift
        # (GAC_v10b.m:89-92): they WRAP around the image border, unlike
        # every other stencil of the library; kept for parity
        data = (
            gdx_p * (torch.roll(phi, -1, dims=-1) - phi)
            + gdx_n * (phi - torch.roll(phi, 1, dims=-1))
            + gdy_p * (torch.roll(phi, -1, dims=-2) - phi)
            + gdy_n * (phi - torch.roll(phi, 1, dims=-2))
        )
        phi = _ac_update(phi, data, g, tau, nu)
    return phi


def _chunked_evolve(evolve, phi, total: int, collect, collect_every: int):
    """Run ``total`` AOS steps; with ``collect``, in ``collect_every``-step
    chunks, the level set after each appended (the reference's
    per-iteration ``imagesc``/``drawnow``, GAC_v10a.m:117)."""
    if collect is None:
        return evolve(phi, iters=total)
    done = 0
    while done < total:
        k = min(collect_every, total - done)
        phi = evolve(phi, iters=k)
        collect.append(phi)
        done += k
    return phi


def _prepare(img, phi, p: GACParams, device):
    """The initial reinit of phi and the stopping function, on the device
    rule of the image."""
    device = input_device(img, device)
    phi = reinit(as_tensor(phi, device), steps=40)
    return phi, _stopping_function(as_tensor(img, device), p.lam)


def gac_a(img, phi, params: GACParams | None = None, collect=None, collect_every: int = 10,
          device=None, **overrides):
    """Caselles-1993 GAC with balloon force. img: (C, H, W) or (H, W);
    phi: initial level set (H, W), > 0 inside; numpy arrays or tensors.
    Returns the evolved PHI, a float32 (H, W) tensor on the device of
    ``img`` if it is a tensor, else on ``device``, else on the CUDA card
    (raises where there is none).

    collect: optional list; PHI after every ``collect_every`` steps is
    appended."""
    p = with_overrides(params or GACParams(), **overrides)
    phi, g = _prepare(img, phi, p, device)
    return _chunked_evolve(
        lambda x, iters: _gac_a_evolve(x, g, p.c, p.tau, p.SMOOTH, iters),
        phi, p.ITER, collect, collect_every)


def gac_b(img, phi, params: GACParams | None = None, collect=None, collect_every: int = 10,
          device=None, **overrides):
    """Caselles-1997 GAC with the convection term grad(g).grad(PHI); as
    ``gac_a`` otherwise."""
    p = with_overrides(params or GACParams(), **overrides)
    phi, g = _prepare(img, phi, p, device)
    return _chunked_evolve(
        lambda x, iters: _gac_b_evolve(x, g, p.tau, p.SMOOTH, iters),
        phi, p.ITER, collect, collect_every)


def gac_a_fused(img, phi, params: GACParams | None = None, device=None):
    """``gac_a`` (the initial reinit, the stopping function and every AOS
    step) as one replayed CUDA graph on the card, as ``flow_nd_fused``
    (``models/_graph.py``), with ``img`` and ``phi`` its inputs; on the
    CPU it is ``gac_a``."""
    return replay(gac_a, (params,), (img, phi), device)


def gac_b_fused(img, phi, params: GACParams | None = None, device=None):
    """As ``gac_a_fused``, for model "b"."""
    return replay(gac_b, (params,), (img, phi), device)
