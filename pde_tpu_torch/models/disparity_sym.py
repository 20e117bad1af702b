"""Symmetric (left<->right coupled) stereo disparity
(DispEminND_llin_sym_2D.m), ported from ``pde_tpu/models/disparity_sym.py``.

Estimates both disparity fields at once: each firstLoop iteration warps
both images and both disparity fields (NaN outside the domain), builds
brightness+gradient data tensors in both directions and a robust
symmetry term

    Snorm_k = (dU_k + Udt_k + Udx_j * dU_k)^2
    gSYM_k  = (channels*beta/alpha) / (1 + Snorm_k / srDiff^2)

whose contributions subtract from Cu and add to Du, then relaxes the pair.
The two fields decouple inside the solve, so they go to the solver as one
batch of 2: one red-black kernel call on the card (``solver=1``), or one
line-implicit PCG whose CG scalars are per field, as ``pde_tpu``'s
``vmap`` of it (``solver=2``, its line solves the CUDA tridiagonal kernel).

Works on the raw 0-255 image domain (no /255) with a 3x3 σ=1 Gaussian
pyramid, as the reference. Runs eagerly on the card unless the caller
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
from pde_tpu_torch.kernels.dispatch import sor_disp_llin_sym4
from pde_tpu_torch.models._device import as_tensor, input_device
from pde_tpu_torch.models._graph import replay
from pde_tpu_torch.models.disparity import warp_x
from pde_tpu_torch.models.flow_nd import check_solver
from pde_tpu_torch.ops.derivatives import (
    FST_DERIVATOR5,
    SMOOTHER5,
    fst_derivatives5,
    snd_derivatives5,
)
from pde_tpu_torch.ops.weights import diffusion_weights_4
from pde_tpu_torch.solvers.krylov import pcg_disp_llin4


@dataclasses.dataclass(frozen=True)
class DisparitySymParams:
    """Defaults from DispEminND_llin_sym_2D.m:50-64 (as ``pde_tpu``'s)."""

    alpha: float = 0.035
    beta: float = 0.4
    omega: float = 1.9
    firstLoop: int = 3
    secondLoop: int = 4
    iter: int = 4
    b1: float = 0.25
    b2: float = 0.72
    scales: int = 10**9
    scl_factor: float = 0.75
    # 1: red-black SOR (the CUDA interior-update kernel); 2: line-implicit
    # PCG (the CUDA tridiagonal kernel)
    solver: int = 1


def params_from_reference(obj) -> DisparitySymParams:
    """This package's ``DisparitySymParams`` from any dataclass instance or
    dict with its field names. Unknown names raise ``TypeError``."""
    values = dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) else dict(obj)
    return with_overrides(DisparitySymParams(), **values)


def _flow_dx(u):
    """Simoncelli x-derivative of a disparity field (vertical prefilter,
    horizontal derivator)."""
    return separable_filter(u, SMOOTHER5, FST_DERIVATOR5)


def _data_tensors(it0, it1w, p: DisparitySymParams):
    """CuD/DuD in one warp direction, per channel, and the derivatives the
    robust weights need."""
    idt, idx, _ = fst_derivatives5(it0, it1w)
    idxt, idyt, idxx, _, idxy = snd_derivatives5(it0, it1w)
    cud = p.b1 * idt * idx + p.b2 * (idxt * idxx + idyt * idxy)
    dud = p.b1 * idx * idx + p.b2 * (idxx * idxx + idxy * idxy)
    return cud, dud, dict(dt=idt, dx=idx, dxt=idxt, dyt=idyt, dxx=idxx, dxy=idxy)


def _robust_weight(t, du, p: DisparitySymParams):
    opn = p.b1 * (t["dt"] - t["dx"] * du) ** 2 + p.b2 * (
        (t["dxt"] - t["dxx"] * du) ** 2 + (t["dyt"] - t["dxy"] * du) ** 2
    )
    return 1.0 / (p.alpha * torch.sqrt(opn + 1e-5))


def _sym_level(u0, u1, it0, it1, sr_diff, p: DisparitySymParams):
    nch = it0.shape[0]
    for _first in range(p.firstLoop):
        it0w = warp_x(it0, u1)
        it1w = warp_x(it1, u0)
        u0w = warp_x(u0, u1)
        u1w = warp_x(u1, u0)

        cud0, dud0, t0 = _data_tensors(it0, it1w, p)
        cud1, dud1, t1 = _data_tensors(it1, it0w, p)

        udt0 = 0.5 * (u0 + u1w)
        udx1 = _flow_dx(u1w)
        udt1 = 0.5 * (u1 + u0w)
        udx0 = _flow_dx(u0w)
        cus0 = udt0 * (1.0 + udx1)
        dus0 = 1.0 + 2.0 * udx1 + udx1 * udx1
        cus1 = udt1 * (1.0 + udx0)
        dus1 = 1.0 + 2.0 * udx0 + udx0 * udx0

        du0 = torch.zeros_like(u0)
        du1 = torch.zeros_like(u1)
        for _second in range(p.secondLoop):
            gd0 = _robust_weight(t0, du0, p)
            gd1 = _robust_weight(t1, du1, p)

            snorm0 = (du0 + udt0 + udx1 * du0) ** 2
            snorm1 = (du1 + udt1 + udx0 * du1) ** 2
            gsym0 = (nch * p.beta / p.alpha) / (1.0 + snorm0 / sr_diff**2)
            gsym1 = (nch * p.beta / p.alpha) / (1.0 + snorm1 / sr_diff**2)

            # plain sums: NaN (out-of-domain) propagates -> pure diffusion
            cug0 = torch.sum(gd0 * cud0, dim=0) - gsym0 * cus0
            dug0 = torch.sum(gd0 * dud0, dim=0) + gsym0 * dus0
            cug1 = torch.sum(gd1 * cud1, dim=0) - gsym1 * cus1
            dug1 = torch.sum(gd1 * dud1, dim=0) + gsym1 * dus1

            w0 = diffusion_weights_4(u0 + du0, eps=1e-5, combine="max", zero_borders=True)
            w1 = diffusion_weights_4(u1 + du1, eps=1e-5, combine="max", zero_borders=True)
            if p.solver == 2:
                pairs = ((u0, u1), (du0, du1), (cug0, cug1), (dug0, dug1), *zip(w0, w1))
                du0, du1 = pcg_disp_llin4(*(torch.stack(pair) for pair in pairs),
                                          p.iter, p.omega)
            else:
                du0, du1 = sor_disp_llin_sym4(u0, du0, cug0, dug0, *w0,
                                              u1, du1, cug1, dug1, *w1, p.iter, p.omega)

        u0 = medfilt2_3x3(u0 + du0)
        u1 = medfilt2_3x3(u1 + du1)
    return u0, u1


def disparity_sym(il, ir, params: DisparitySymParams | None = None,
                  collect: list | None = None, device=None, **overrides):
    """Symmetric disparity. il/ir: (C, H, W) or (H, W) uint8-range images,
    as numpy arrays or tensors, on the device rule of ``disparity_nd``.

    Returns U of shape (2, H, W): U[0] left->right, U[1] right->left.
    collect: optional list of per-level (U0, U1), coarsest first.
    """
    p = with_overrides(params or DisparitySymParams(), **overrides)
    check_solver("disparity_sym", p.solver)
    device = input_device(il, device)
    a = as_tensor(il, device)
    b = as_tensor(ir, device)
    if a.ndim == 2:
        a, b = a[None], b[None]

    # 3x3 sigma=1 Gaussian inter-level smoothing, stop <= 10 px (:81-104)
    levels = build_pyramid([a, b], p.scl_factor, 10, 3, 1.0, p.scales)
    n = len(levels)

    u0 = u1 = None
    for lvl in range(n - 1, -1, -1):
        l0, l1 = levels[lvl]
        h, w = l0.shape[-2:]
        if u0 is None:
            u0 = torch.zeros((h, w), dtype=torch.float32, device=device)
            u1 = torch.zeros((h, w), dtype=torch.float32, device=device)
        sr_diff = 2.0 * (1.0 / p.scl_factor) ** (-(lvl))  # srDiff (:126)
        u0, u1 = _sym_level(u0, u1, l0, l1, sr_diff, p)
        if collect is not None:
            collect.append((u0, u1))
        if lvl > 0:
            nh, nw = levels[lvl - 1][0].shape[-2:]
            u0 = imresize(u0 / p.scl_factor, (nh, nw), "bilinear")
            u1 = imresize(u1 / p.scl_factor, (nh, nw), "bilinear")
    return torch.stack([u0, u1])


def disparity_sym_fused(il, ir, params: DisparitySymParams | None = None, device=None):
    """``disparity_sym`` as one replayed CUDA graph a frame on the card,
    as ``flow_nd_fused`` (``models/_graph.py``); on the CPU it is
    ``disparity_sym``."""
    return replay(disparity_sym, (params,), (il, ir), device)
