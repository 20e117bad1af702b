"""Stereo disparity, late linearisation with horizontal-only warping
(DispEminND_llin_2D.m), ported from ``pde_tpu/models/disparity.py``.

The warping flow's robust two-term scheme restricted to a scalar
horizontal field: the warp is x-only, the constancy tensors keep only the
u-components, channel tensors combine with a plain ``sum`` so NaN
(out-of-domain) pixels stay NaN and make the solver diffuse purely there,
the spatial prior uses ``gS = γ/α·exp(-APnorm/ASdiff²)``, and the
diffusion weights come from the disparity field itself with zeroed
borders.

Runs eagerly on the card unless the caller asks for the CPU
(``models/_device.py``). The solve is red-black SOR through
``kernels/dispatch.py`` (``solver=1``, the interior-update CUDA kernel for
CUDA tensors) or the line-implicit PCG of ``solvers/krylov.py``
(``solver=2``, its line solves the CUDA tridiagonal kernel).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import torch

from pde_tpu_torch.config import with_overrides
from pde_tpu_torch.core.median import medfilt2_3x3
from pde_tpu_torch.core.pyramid import build_pyramid
from pde_tpu_torch.core.resize import imresize
from pde_tpu_torch.kernels.dispatch import sor_disp_llin4
from pde_tpu_torch.models._device import as_tensor, input_device
from pde_tpu_torch.models._graph import replay
from pde_tpu_torch.models.flow_nd import check_solver
from pde_tpu_torch.ops.derivatives import fst_derivatives5, snd_derivatives5, rgb2grad
from pde_tpu_torch.ops.warp import bilinear_warp, identity_grid, warp_x_window
from pde_tpu_torch.ops.weights import diffusion_weights_4
from pde_tpu_torch.solvers.krylov import pcg_disp_llin4
from pde_tpu_torch.utils.observe import span


@dataclasses.dataclass(frozen=True)
class DisparityParams:
    """Defaults from DispEminND_llin_2D.m:52-67 (as ``pde_tpu``'s)."""

    alpha: float = 0.042
    gammaS: float = 0.005
    omega: float = 1.9
    firstLoop: int = 4
    secondLoop: int = 6
    iter: int = 4
    b1: float = 1.48
    b2: float = 0.29
    scales: int = 10**9
    scl_factor: float = 0.75
    # 1: red-black SOR (the CUDA interior-update kernel); 2: line-implicit
    # PCG (the CUDA tridiagonal kernel)
    solver: int = 1
    # windowed shift-add warp radius (ops/warp.warp_x_window); 0 = exact
    # gather warp. With radius r the warp is exact for |disparity| < r;
    # beyond it the sample becomes NaN (missing data).
    warp_window: int = 0
    # accepted so that parameters round-trip with pde_tpu; no effect here
    # (it picks a loop form for the JAX trace)
    fori: bool = False


def params_from_reference(obj) -> DisparityParams:
    """This package's ``DisparityParams`` from any dataclass instance or
    dict with its field names (such as a ``pde_tpu`` ``DisparityParams``).
    Unknown names raise ``TypeError``."""
    values = dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) else dict(obj)
    return with_overrides(DisparityParams(), **values)


def warp_x(img, u, window: int = 0):
    """Sample (..., H, W) ``img`` at (X+u, Y), NaN outside the image."""
    if window > 0:
        return warp_x_window(img, u, window)
    h, w = img.shape[-2:]
    x, y = identity_grid(h, w, device=img.device)
    return bilinear_warp(img, x + u, y)


def _disp_first_iter(u, i1t0, i1t1, i2t0, i2t1, us_ap, as_diff,
                     p: DisparityParams, snd_is_gradmag: bool):
    """One warping (firstLoop) iteration: warp, derivative tensors, the
    robust-weight secondLoop fixed point, median."""
    has_snd = i2t1 is not None
    has_us = us_ap is not None

    with span("warp"):
        i1t1w = warp_x(i1t1, u, p.warp_window)
        i1dt, i1dx, _ = fst_derivatives5(i1t0, i1t1w)
        cu1 = i1dt * i1dx
        du1 = i1dx * i1dx
        if has_snd:
            i2t1w = warp_x(i2t1, u, p.warp_window)
            if snd_is_gradmag:
                i2dxt, i2dyt, i2dxx, _, i2dxy = snd_derivatives5(i2t0, i2t1w)
                cu2 = i2dxt * i2dxx + i2dyt * i2dxy
                du2 = i2dxx * i2dxx + i2dxy * i2dxy
            else:
                i2dt, i2dx, _ = fst_derivatives5(i2t0, i2t1w)
                cu2 = i2dt * i2dx
                du2 = i2dx * i2dx

        du_f = torch.zeros_like(u)
    for _second in range(p.secondLoop):
        with span("robust"):
            op1 = (i1dt - i1dx * du_f) ** 2
            gd1 = p.b1 / (p.alpha * torch.sqrt(op1 + 1e-5))
            cu_parts = [cu1 * gd1]
            du_parts = [du1 * gd1]
            if has_snd:
                if snd_is_gradmag:
                    op2 = (i2dxt - i2dxx * du_f) ** 2 + (i2dyt - i2dxy * du_f) ** 2
                else:
                    op2 = (i2dt - i2dx * du_f) ** 2
                gd2 = p.b2 / (p.alpha * torch.sqrt(op2 + 1e-5))
                cu_parts.append(cu2 * gd2)
                du_parts.append(du2 * gd2)
            if has_us:
                ap_norm = (us_ap - u - du_f) ** 2
                gs = (p.gammaS / p.alpha) * torch.exp(-ap_norm / as_diff**2)
                cu_parts.append(((us_ap - u) * gs)[None])
                du_parts.append(gs[None])

            # plain sum over channels: NaN propagates (reference :289-293)
            cu_gd = sum(torch.sum(x, dim=0) for x in cu_parts)
            du_gd = sum(torch.sum(x, dim=0) for x in du_parts)

        with span("weights"):
            ww, wn, we, ws = diffusion_weights_4(u + du_f, eps=1e-5, combine="max",
                                                 zero_borders=True)
        solve = pcg_disp_llin4 if p.solver == 2 else sor_disp_llin4
        with span("solve"):
            du_f = solve(u, du_f, cu_gd, du_gd, ww, wn, we, ws, p.iter, p.omega)
    with span("median"):
        return medfilt2_3x3(u + du_f)


def _disp_level(u, i1t0, i1t1, i2t0, i2t1, us_ap, as_diff, p: DisparityParams,
                snd_is_gradmag: bool):
    step = partial(_disp_first_iter, i1t0=i1t0, i1t1=i1t1, i2t0=i2t0, i2t1=i2t1,
                   us_ap=us_ap, as_diff=as_diff, p=p, snd_is_gradmag=snd_is_gradmag)
    for _first in range(p.firstLoop):
        u = step(u)
    return u


def disparity_nd(il, ir, fst_term: str = "grad", snd_term: str = "gradmag",
                 params: DisparityParams | None = None, us=None,
                 collect: list | None = None, device=None, **overrides):
    """il, ir: (C, H, W) or (H, W) uint8-range stereo pair, as numpy arrays
    or tensors. Returns U (H, W) float32 on the device of ``il`` if it is a
    tensor, else on ``device``, else on the CUDA card (raises where there
    is none).

    us: optional (H, W) disparity prior (NaN read as 0). collect: optional
    list; the per-level U field (coarsest first, before upscaling) is
    appended."""
    p = with_overrides(params or DisparityParams(), **overrides)
    check_solver("disparity_nd", p.solver)
    fst_term = fst_term.lower()
    snd_term = snd_term.lower()
    device = input_device(il, device)

    def fst_img(img):
        return rgb2grad(img) if fst_term == "grad" else img

    def snd_img(img):
        return None if snd_term == "none" else img

    with span("pyramid"):
        a = as_tensor(il, device) / 255.0
        b = as_tensor(ir, device) / 255.0
        if a.ndim == 2:
            a, b = a[None], b[None]

        levels = build_pyramid([a, b], p.scl_factor, 10, 5, 1.25, p.scales)
        n = len(levels)

        us_lv = [None] * n
        if us is not None:
            cur = torch.nan_to_num(as_tensor(us, device))
            us_lv = [cur]
            for lvl in range(1, n):
                cur = imresize(cur * p.scl_factor, levels[lvl][0].shape[-2:], "bilinear")
                us_lv.append(cur)

    u = None
    for lvl in range(n - 1, -1, -1):
        l0, l1 = levels[lvl]
        h, w = l0.shape[-2:]
        with span("level", index=lvl, shape=(h, w)):
            with span("pyramid"):
                if u is None:
                    u = torch.zeros((h, w), dtype=torch.float32, device=device)
                i1t0, i1t1 = fst_img(l0), fst_img(l1)
            as_diff = 1.75 * p.scl_factor**lvl  # DispEminND_llin_2D.m:186
            u = _disp_level(u, i1t0, i1t1, snd_img(l0), snd_img(l1),
                            us_lv[lvl], as_diff, p, snd_term == "gradmag")
            if collect is not None:
                collect.append(u)
            if lvl > 0:
                nh, nw = levels[lvl - 1][0].shape[-2:]
                with span("pyramid"):
                    u = imresize(u / p.scl_factor, (nh, nw), "bilinear")
    return u


def disparity_nd_fused(il, ir, fst_term: str = "grad", snd_term: str = "gradmag",
                       params: DisparityParams | None = None, device=None):
    """``disparity_nd`` as one replayed CUDA graph a frame on the card,
    as ``flow_nd_fused`` (``models/_graph.py``); on the CPU it is
    ``disparity_nd``. ``pde_tpu``'s TPU workaround here (its XLA solvers
    and warning) has no counterpart: the graph runs the CUDA kernels."""
    return replay(disparity_nd, (fst_term, snd_term, params), (il, ir), device)


def disparity_nd_split(il, ir, fst_term: str = "grad", snd_term: str = "gradmag",
                       params: DisparityParams | None = None, n_parts: int = 2,
                       xla: bool = True, device=None, **overrides):
    """``pde_tpu``'s level-range partitioning of the frame into programs, a
    TPU workaround; here ``disparity_nd`` (``n_parts`` and ``xla`` have no
    effect)."""
    return disparity_nd(il, ir, fst_term, snd_term, params, device=device, **overrides)


def disparity_nd_chunked(il, ir, fst_term: str = "grad", snd_term: str = "gradmag",
                         params: DisparityParams | None = None, chunk: int = 4,
                         xla: bool = True, device=None, **overrides):
    """``pde_tpu``'s chunked partitioning (a TPU workaround); here
    ``disparity_nd`` (``chunk`` and ``xla`` have no effect)."""
    return disparity_nd(il, ir, fst_term, snd_term, params, device=device, **overrides)


def disparity_nd_hybrid(il, ir, fst_term: str = "grad", snd_term: str = "gradmag",
                        params: DisparityParams | None = None, fused_finest: int = 5,
                        xla: bool = True, device=None, **overrides):
    """``pde_tpu``'s hybrid partitioning (a TPU workaround); here
    ``disparity_nd`` (``fused_finest`` and ``xla`` have no effect)."""
    return disparity_nd(il, ir, fst_term, snd_term, params, device=device, **overrides)
