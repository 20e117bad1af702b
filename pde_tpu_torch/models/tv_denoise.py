"""Total-variation denoising, 4- and 8-neighbour (TVdenoise4.m,
TVdenoise8.m), ported from ``pde_tpu/models/tv_denoise.py``.

Lagged-diffusivity TV restoration with an L1 data term:

    PsiData = 1/sqrt((u - f)^2 + eps)
    TRACE   = PsiData + alpha * Σ w_k
    B       = PsiData * f
    u      <- SOR sweeps of  u+ = (B + Σ w_k u_k) / TRACE

run coarse-to-fine over a partial pyramid (down to ``scl`` of the original
size). ``tv_denoise4`` uses Brox weights, max over channels and zeroed
borders; ``tv_denoise8`` the anisotropic diffusion tensor stencil of the
current estimate (``ops/weights.tensor_diffusion_weights_8``, zeroed
borders) and a coarsest level left unsmoothed (the TVdenoise8.m:72
quirk). The channels are one batch of the solver, the (H, W) weights
shared: one red-black kernel call on the card (``solver=1``: the resident
pde4 or pde8 kernel, ``csrc/resident_sor.cu`` or ``resident8_sor.cu``, where
the level has a plan, else ``csrc/interior_sor.cu``), or one line-implicit
PCG over all channels jointly (``solver=2``, its line solves the CUDA
tridiagonal kernel). Runs eagerly on the card unless the caller asks for
the CPU (``models/_device.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pde_tpu_torch.config import with_overrides
from pde_tpu_torch.core.conv import gaussian_kernel_2d, imfilter_replicate
from pde_tpu_torch.core.resize import imresize, imresize_scale
from pde_tpu_torch.kernels.dispatch import diffusion_weights_4, sor_pde4, sor_pde8
from pde_tpu_torch.models._device import as_tensor, input_device
from pde_tpu_torch.models._graph import replay
from pde_tpu_torch.models.flow_nd import check_solver
from pde_tpu_torch.ops.weights import tensor_diffusion_weights_8
from pde_tpu_torch.solvers.krylov import pcg_pde4, pcg_pde8

_EPS_D = float(np.finfo(np.float64).eps)  # MATLAB `eps`, added to a float32 square


@dataclasses.dataclass(frozen=True)
class TVDenoise4Params:
    """Defaults from TVdenoise4.m:36-44 (as ``pde_tpu``'s)."""

    alpha: float = 5.0
    omega: float = 1.75
    outer_iter: int = 10
    inner_iter: int = 5
    # 1: red-black SOR (the CUDA interior-update kernel); 2: line-implicit
    # PCG (the CUDA tridiagonal kernel)
    solver: int = 1
    scl: float = 0.5
    scl_factor: float = 0.75


@dataclasses.dataclass(frozen=True)
class TVDenoise8Params:
    """Defaults from TVdenoise8.m:36-44 (as ``pde_tpu``'s)."""

    alpha: float = 500.0
    omega: float = 1.75
    outer_iter: int = 20
    inner_iter: int = 4
    # 1: red-black SOR (the CUDA interior-update kernel, pde8); 2:
    # line-implicit PCG (the CUDA tridiagonal kernel)
    solver: int = 1
    scl: float = 0.75
    scl_factor: float = 0.75
    quantile: float = 0.5  # ADdiffWeights default (TVdenoise8.m:147)
    operator: str = "alvarez"


def _params_from(default, obj):
    values = dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) else dict(obj)
    return with_overrides(default, **values)


def params_from_reference(obj) -> TVDenoise4Params:
    """This package's ``TVDenoise4Params`` from any dataclass instance or
    dict with its field names. Unknown names raise ``TypeError``."""
    return _params_from(TVDenoise4Params(), obj)


def params8_from_reference(obj) -> TVDenoise8Params:
    """This package's ``TVDenoise8Params`` from any dataclass instance or
    dict with its field names (such as a ``pde_tpu`` ``TVDenoise8Params``).
    Unknown names raise ``TypeError``."""
    return _params_from(TVDenoise8Params(), obj)


def _partial_pyramid(img, scl, scl_factor, gsize, gsigma, smooth_last=True):
    """Pyramid that stops once a level is <= ceil(orig * scl) in either dim.

    Each retained level is smoothed after its child is created from the
    unsmoothed parent; ``smooth_last=False`` keeps the coarsest level
    unsmoothed (the TVdenoise8.m:72 quirk).
    """
    g = gaussian_kernel_2d(gsize, gsigma)
    h, w = img.shape[-2:]
    ds_h, ds_w = int(np.ceil(h * scl)), int(np.ceil(w * scl))
    raw = [img]
    while True:
        nxt = imresize_scale(raw[-1], scl_factor, "bilinear")
        raw.append(nxt)
        if nxt.shape[-2] <= ds_h or nxt.shape[-1] <= ds_w:
            break
    out = [imfilter_replicate(x, g) for x in raw]
    if not smooth_last:
        out[-1] = raw[-1]
    return out


def _tv4_level(iout, f, alpha, omega, outer_iter, inner_iter, solver=1):
    """``outer_iter + 1`` lagged-diffusivity iterations at one level; iout
    and f are (C, H, W)."""
    u = iout
    for _ in range(outer_iter + 1):
        psi = 1.0 / torch.sqrt((u - f) ** 2 + _EPS_D)
        ww, wn, we, ws = diffusion_weights_4(u, eps=1e-5, combine="max", zero_borders=True)
        trace = psi + alpha * (ww + wn + we + ws)
        b = psi * f
        solve = pcg_pde4 if solver == 2 else sor_pde4
        u = solve(u, trace, b, alpha * ww, alpha * wn, alpha * we, alpha * ws,
                  inner_iter, omega)
    return u


def tv_denoise4(img, params: TVDenoise4Params | None = None, device=None, **overrides):
    """TV denoise (4-neighbour). img: (C, H, W) or (H, W) float32, as a
    numpy array or a tensor. Returns the same shape on the device of
    ``img`` if it is a tensor, else on ``device``, else on the CUDA card
    (raises where there is none)."""
    p = with_overrides(params or TVDenoise4Params(), **overrides)
    check_solver("tv_denoise4", p.solver)
    x = as_tensor(img, input_device(img, device))
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    levels = _partial_pyramid(x, p.scl, p.scl_factor, 7, 2.0)
    iout = levels[-1]
    for lvl in range(len(levels) - 1, -1, -1):
        iout = _tv4_level(iout, levels[lvl], p.alpha, p.omega, p.outer_iter, p.inner_iter,
                          p.solver)
        if lvl > 0:
            iout = imresize(iout, levels[lvl - 1].shape[-2:], "bilinear")
    return iout[0] if squeeze else iout


def tv_denoise4_fused(img, params: TVDenoise4Params | None = None, device=None):
    """``tv_denoise4`` as one replayed CUDA graph an image on the card, as
    ``flow_nd_fused`` (``models/_graph.py``); on the CPU it is
    ``tv_denoise4``."""
    return replay(tv_denoise4, (params,), (img,), device)


def _tv8_level(iout, f, alpha, omega, quantile, outer_iter, inner_iter, solver=1,
               operator="alvarez"):
    """``outer_iter + 1`` lagged-diffusivity iterations of the 8-neighbour
    form at one level; iout and f are (C, H, W)."""
    u = iout
    for _ in range(outer_iter + 1):
        w8 = tensor_diffusion_weights_8(u, quantile=quantile, operator=operator,
                                        zero_borders=True)
        psi = 1.0 / torch.sqrt((u - f) ** 2 + _EPS_D)
        trace = psi + alpha * (w8[0] + w8[1] + w8[2] + w8[3] + w8[4] + w8[5] + w8[6] + w8[7])
        b = psi * f
        solve = pcg_pde8 if solver == 2 else sor_pde8
        u = solve(u, trace, b, *(alpha * wt for wt in w8), inner_iter, omega)
    return u


def tv_denoise8(img, params: TVDenoise8Params | None = None, device=None, **overrides):
    """TV denoise (8-neighbour anisotropic). img: (C, H, W) or (H, W)
    float32, as a numpy array or a tensor; the device rule of
    ``tv_denoise4``. Returns the same shape."""
    p = with_overrides(params or TVDenoise8Params(), **overrides)
    check_solver("tv_denoise8", p.solver)
    x = as_tensor(img, input_device(img, device))
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    levels = _partial_pyramid(x, p.scl, p.scl_factor, 5, 1.25, smooth_last=False)
    iout = levels[-1]
    for lvl in range(len(levels) - 1, -1, -1):
        iout = _tv8_level(iout, levels[lvl], p.alpha, p.omega, p.quantile, p.outer_iter,
                          p.inner_iter, p.solver, p.operator)
        if lvl > 0:
            iout = imresize(iout, levels[lvl - 1].shape[-2:], "bilinear")
    return iout[0] if squeeze else iout


def tv_denoise8_fused(img, params: TVDenoise8Params | None = None, device=None):
    """``tv_denoise8`` as one replayed CUDA graph an image on the card, as
    ``flow_nd_fused`` (``models/_graph.py``); on the CPU it is
    ``tv_denoise8``."""
    return replay(tv_denoise8, (params,), (img,), device)
