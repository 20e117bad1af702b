"""Horn & Schunck flow with gradient constancy, early linearisation
(FlowEminHS_elin_2D_v10.m), ported from ``pde_tpu/models/flow_hs.py``.

Coarse to fine over a pyramid (factor 0.75, stop <= 20 px). Per level,
brightness and gradient constancy tensors from 5-tap Simoncelli kernels
applied to the temporal average ``0.55 (It0 + It1)``, summed over the
channels; one solve of the early-linearised system with the constant
diffusion weight ``alpha * channels``; then a 3x3 median and a bicubic
upscale (MATLAB's default ``imresize`` method) to the next level.

``solver=2`` (the default) solves each level with the line-implicit PCG
(``solvers/krylov.py::pcg_flow_elin4``, whose line solves are the CUDA
tridiagonal kernel on the card); ``solver=1`` with red-black SOR
(``kernels/dispatch.py::sor_flow_elin4``: on the card the resident elin4
kernel of ``csrc/resident_sor.cu``, one launch a level, where the level has
a plan, else the tile kernel of ``csrc/tiled_sor.cu``, one launch a chunk of
4 sweeps). Runs eagerly on the card unless the caller
asks for the CPU (``models/_device.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from pde_tpu_torch.config import with_overrides
from pde_tpu_torch.core.conv import separable_filter
from pde_tpu_torch.core.median import medfilt2_3x3
from pde_tpu_torch.core.pyramid import build_pyramid
from pde_tpu_torch.core.resize import imresize
from pde_tpu_torch.kernels.dispatch import sor_flow_elin4
from pde_tpu_torch.models._device import as_tensor, input_device
from pde_tpu_torch.models.flow_nd import check_solver
from pde_tpu_torch.ops.derivatives import FST_DERIVATOR5, SMOOTHER5, SND_DERIVATOR5
from pde_tpu_torch.solvers.krylov import pcg_flow_elin4


@dataclasses.dataclass(frozen=True)
class FlowHSParams:
    """Defaults from FlowEminHS_elin_2D_v10.m:53-62 (as ``pde_tpu``'s)."""

    alpha: float = 0.2
    omega: float = 1.9
    iter: int = 20
    b1: float = 0.25
    b2: float = 0.75
    scl_factor: float = 0.75
    # 2: line-implicit PCG (the CUDA tridiagonal kernel); 1: red-black SOR
    # (the CUDA elin4 kernels), which converges slowly on this
    # diffusion-dominated system
    solver: int = 2
    scales: int = 10**9


def params_from_reference(obj) -> FlowHSParams:
    """This package's ``FlowHSParams`` from any dataclass instance or dict
    with its field names (such as a ``pde_tpu`` ``FlowHSParams``).
    Unknown names raise ``TypeError``."""
    values = dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) else dict(obj)
    return with_overrides(FlowHSParams(), **values)


def _hs_level(u, v, it0, it1, alpha_w, b1, b2, omega, iters, solver):
    """One level: the channel-summed constancy tensors of (C, H, W) images
    and one early-linearised solve from (u, v)."""
    ist = (it0 + it1) * 0.55
    idt = it0 - it1

    def dx(img, der):
        return separable_filter(separable_filter(img, SMOOTHER5, None), None, der)

    def dy(img, der):
        return separable_filter(separable_filter(img, None, SMOOTHER5), der, None)

    idx = dx(ist, FST_DERIVATOR5)
    idy = dy(ist, FST_DERIVATOR5)
    idxx = dx(ist, SND_DERIVATOR5)
    idyy = dy(ist, SND_DERIVATOR5)
    idxy = separable_filter(separable_filter(ist, None, FST_DERIVATOR5), FST_DERIVATOR5, None)
    idxt = dx(it0, FST_DERIVATOR5) - dx(it1, FST_DERIVATOR5)
    idyt = dy(it0, FST_DERIVATOR5) - dy(it1, FST_DERIVATOR5)

    m = b1 * idy * idx + b2 * idxy * (idxx + idyy)
    cu = b1 * idt * idx + b2 * (idxt * idxx + idyt * idxy)
    cv = b1 * idt * idy + b2 * (idxt * idxy + idyt * idyy)
    du = b1 * idx * idx + b2 * (idxx * idxx + idxy * idxy)
    dv = b1 * idy * idy + b2 * (idxy * idxy + idyy * idyy)
    m, cu, cv, du, dv = (torch.sum(t, dim=0) for t in (m, cu, cv, du, dv))

    w = torch.full(u.shape, alpha_w, dtype=u.dtype, device=u.device)
    solve = pcg_flow_elin4 if solver == 2 else sor_flow_elin4
    return solve(u, v, m, cu, cv, du, dv, w, w, w, w, iters, omega)


def flow_hs(it0, it1, params: FlowHSParams | None = None, device=None, **overrides):
    """it0, it1: (C, H, W) or (H, W) uint8-range images, as numpy arrays or
    tensors. Returns (U, V) float32 (H, W) tensors on the device of ``it0``
    if it is a tensor, else on ``device``, else on the CUDA card (raises
    where there is none)."""
    p = with_overrides(params or FlowHSParams(), **overrides)
    check_solver("flow_hs", p.solver)
    device = input_device(it0, device)
    a = as_tensor(it0, device) / 255.0
    b = as_tensor(it1, device) / 255.0
    if a.ndim == 2:
        a, b = a[None], b[None]
    channels = a.shape[0]

    levels = build_pyramid([a, b], p.scl_factor, 20, 5, 1.25, p.scales)
    u = v = None
    for lvl in range(len(levels) - 1, -1, -1):
        l0, l1 = levels[lvl]
        if u is None:
            u = torch.zeros(l0.shape[-2:], dtype=torch.float32, device=device)
            v = torch.zeros_like(u)
        u, v = _hs_level(u, v, l0, l1, p.alpha * channels, p.b1, p.b2, p.omega, p.iter,
                         p.solver)
        if lvl > 0:
            nh, nw = levels[lvl - 1][0].shape[-2:]
            u = imresize(medfilt2_3x3(u / p.scl_factor), (nh, nw), "bicubic")
            v = imresize(medfilt2_3x3(v / p.scl_factor), (nh, nw), "bicubic")
    return u, v
