"""Early-linearisation optical flow solved by FAS full multigrid
(FlowEminNDFASFMG_elin_2D_v10.m), ported from ``pde_tpu/models/flow_fmg.py``.

* factor-2 pyramid: the separable ``[1 4 6 4 1]/16`` binomial low-pass and
  decimation, stopping once a side is <= 10 px, after an initial 5x5
  sigma=1 Gaussian;
* per-level constancy tensors, computed once, from ``Ist = 0.55 (It0 +
  It1)/255`` and the temporal, first and second Simoncelli-kernel
  derivatives, weighted by b1 (brightness) and b2 (gradient);
* FMG coarse to fine; at each level ``_fas_cycle`` recurses (cycle_index 1
  = V-cycle, 2 = W-cycle): presmooth (firstLoop x {gd, Brox weights, `iter`
  solver sweeps}) and a residual-only pass, restrict the residual and the
  solution (full weighting x scl_factor, decimate), the coarse RHS
  ``fu = (RUres + A(Ures))/gd``, recurse, the coarse-grid correction
  ``U += bilinear_upsample((Uc - Ures)/scl_factor)``, postsmooth;
* the flow upscaled between levels by ``1/scl_factor`` (bicubic, MATLAB's
  default ``imresize`` method).

The input stays in the 0-255 domain; the temporal and mixed derivative
kernels carry the /255 instead.

Runs eagerly on the card unless the caller asks for the CPU
(``models/_device.py``). ``solver=2`` (the default) smooths with the
line-implicit PCG (``solvers/krylov.py::pcg_flow_elin4``: on the card one
``tridiag_factor`` a field and direction and one fused
``tridiag_zebra_pass`` a line set and preconditioner step);
``solver=1`` with red-black SOR (``kernels/dispatch.py::sor_flow_elin4``:
on the card the resident elin4 kernel, one launch a smoothing solve, where
the level has a plan). ``mesh=``/``shard_min=`` run the call over a
("ty", "tx") mesh of devices (``parallel/``): the fine FAS levels, while
``min(H, W) >= shard_min`` and the level divides over the mesh, smooth with
``solver=1`` through the sharded elin4 solve
(``parallel/tiled.py::tiled_sor_flow_elin4``); coarser levels, and every
level with ``solver=2``, solve whole on the mesh's first device, where the
rest of the cycle runs (``parallel/model.py``). The numbers are the
unsharded call's.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch

from pde_tpu_torch.config import with_overrides
from pde_tpu_torch.core.conv import (
    binomial5,
    gaussian_kernel_2d,
    imfilter_replicate,
    separable_filter,
)
from pde_tpu_torch.core.resize import imresize
from pde_tpu_torch.kernels.dispatch import diffusion_weights_4, sor_flow_elin4
from pde_tpu_torch.models._device import as_tensor, input_device
from pde_tpu_torch.models._graph import replay
from pde_tpu_torch.models.flow_nd import check_solver
from pde_tpu_torch.ops.derivatives import FST_DERIVATOR5, SMOOTHER5, SND_DERIVATOR5
from pde_tpu_torch.parallel.mesh import mesh_device
from pde_tpu_torch.parallel.model import constrain_level
from pde_tpu_torch.parallel.tiled import tiled_sor_flow_elin4
from pde_tpu_torch.solvers.krylov import pcg_flow_elin4
from pde_tpu_torch.solvers.sor import lhs_elin4, residuals_elin4

# full-weighting restriction stencil (FlowEminNDFASFMG_elin_2D_v10.m:198)
_FW = np.array([[1.0, 2.0, 1.0], [2.0, 4.0, 2.0], [1.0, 2.0, 1.0]], dtype=np.float32) / 16.0


@dataclasses.dataclass(frozen=True)
class FlowFMGParams:
    """Defaults from FlowEminNDFASFMG_elin_2D_v10.m:53-66 (as ``pde_tpu``'s)."""

    alpha: float = 0.035
    omega: float = 1.9
    firstLoop: int = 4
    iter: int = 4
    b1: float = 0.03
    b2: float = 0.97
    scl_factor: float = 0.5
    # 2: line-implicit PCG (the CUDA tridiagonal kernel); 1: red-black SOR
    # (the resident elin4 kernel). The FAS trajectory is smoother-sensitive.
    solver: int = 2
    cycle_index: int = 1
    scales: int = 10**9


def params_from_reference(obj) -> FlowFMGParams:
    """This package's ``FlowFMGParams`` from any dataclass instance or dict
    with its field names (such as a ``pde_tpu`` ``FlowFMGParams``).
    Unknown names raise ``TypeError``."""
    values = dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) else dict(obj)
    return with_overrides(FlowFMGParams(), **values)


def _decimate(x):
    """Every second row and column, as a contiguous tensor (the kernels
    take contiguous fields)."""
    return x[..., ::2, ::2].contiguous()


def _restrict(x, scl_factor):
    """Full-weighting restriction: 3x3 smooth of x*scl_factor, decimate."""
    return _decimate(imfilter_replicate(x * scl_factor, _FW))


def _derivative_tensors(it0, it1, p: FlowFMGParams):
    """Per-level derivative stacks (FlowEminNDFASFMG_elin_2D_v10.m:123-150).
    The m-file convolves with O_dx = [+.10455 +.292315 0 -.292315 -.10455],
    which is correlation by its flip, FST_DERIVATOR5."""
    o_dx = FST_DERIVATOR5
    ist = (it0 + it1) * (0.55 / 255.0)
    idt = (it0 - it1) / 255.0
    idx = separable_filter(ist, SMOOTHER5, o_dx)
    idy = separable_filter(ist, o_dx, SMOOTHER5)
    idxx = separable_filter(ist, SMOOTHER5, SND_DERIVATOR5)
    idyy = separable_filter(ist, SND_DERIVATOR5, SMOOTHER5)
    idxy = separable_filter(ist, o_dx, o_dx)
    o_dx_s = o_dx / 255.0
    idxt = separable_filter(it0, SMOOTHER5, o_dx_s) - separable_filter(it1, SMOOTHER5, o_dx_s)
    idyt = separable_filter(it0, o_dx_s, SMOOTHER5) - separable_filter(it1, o_dx_s, SMOOTHER5)
    return dict(dt=idt, dx=idx, dy=idy, dxx=idxx, dyy=idyy, dxy=idxy, dxt=idxt, dyt=idyt)


def _constancy(t, p: FlowFMGParams):
    return dict(
        m=p.b1 * t["dy"] * t["dx"] + p.b2 * t["dxy"] * (t["dxx"] + t["dyy"]),
        cu=p.b1 * t["dt"] * t["dx"] + p.b2 * (t["dxt"] * t["dxx"] + t["dyt"] * t["dxy"]),
        cv=p.b1 * t["dt"] * t["dy"] + p.b2 * (t["dxt"] * t["dxy"] + t["dyt"] * t["dyy"]),
        du=p.b1 * t["dx"] ** 2 + p.b2 * (t["dxx"] ** 2 + t["dxy"] ** 2),
        dv=p.b1 * t["dy"] ** 2 + p.b2 * (t["dxy"] ** 2 + t["dyy"] ** 2),
    )


def _opnorm(t, u, v, p):
    return p.b1 * (t["dt"] - t["dx"] * u - t["dy"] * v) ** 2 + p.b2 * (
        (t["dxt"] - t["dxx"] * u - t["dxy"] * v) ** 2
        + (t["dyt"] - t["dxy"] * u - t["dyy"] * v) ** 2
    )


def _reduce_c(x):
    """Channel reduce (sum); an (H, W) field stays as it is."""
    return torch.sum(x, dim=0) if x.ndim == 3 else x


def _gd(t, u, v, p, nch: int = 1):
    return 1.0 / (nch * p.alpha * torch.sqrt(_opnorm(t, u, v, p) + 1e-5))


def _smooth(u, v, t, c, cu, cv, p: FlowFMGParams, want_residuals: bool, mesh=None):
    """firstLoop x {gd, Brox weights, iter solver sweeps}; optionally a
    residual pass after (FlowEminNDFASFMG_elin_2D_v10.m:367-464). cu/cv may
    be a coarse level's FAS right-hand side, (C, H, W) like the level's
    constancy terms, instead of those terms. ``mesh``: the solver=1 solves
    run sharded over it."""
    nch = t["dx"].shape[0] if t["dx"].ndim == 3 else 1
    if p.solver == 2:
        solve = pcg_flow_elin4
    elif mesh is None:
        solve = sor_flow_elin4
    else:
        solve = partial(tiled_sor_flow_elin4, mesh)
    for _ in range(p.firstLoop):
        gd = _gd(t, u, v, p, nch)
        ww, wn, we, ws = diffusion_weights_4((u, v), eps=1e-5, combine="sum")
        u, v = solve(u, v, _reduce_c(c["m"] * gd), _reduce_c(cu * gd), _reduce_c(cv * gd),
                     _reduce_c(c["du"] * gd), _reduce_c(c["dv"] * gd), ww, wn, we, ws,
                     p.iter, p.omega)

    if not want_residuals:
        return u, v
    # the residual pass: gd without the channels factor (:434)
    gd = _gd(t, u, v, p)
    ww, wn, we, ws = diffusion_weights_4((u, v), eps=1e-5, combine="sum")
    ru, rv = residuals_elin4(
        u, v, _reduce_c(c["m"] * gd), _reduce_c(cu * gd), _reduce_c(cv * gd),
        _reduce_c(c["du"] * gd), _reduce_c(c["dv"] * gd), ww, wn, we, ws,
    )
    return u, v, ru, rv


def _fas_cycle(u, v, tensors, consts, cu, cv, lvl: int, n_levels: int, p: FlowFMGParams,
               mesh=None, shard_min: int = 64):
    """FAS V/W cycle (FlowEminNDFASFMG_elin_2D_v10.m:193-273); lvl indexes
    fine to coarse. ``mesh``: the level's solves are sharded while it is at
    least ``shard_min`` px and divides over the mesh (the coarse-level
    regather below that, ``parallel/model.constrain_level``)."""
    t, c = tensors[lvl], consts[lvl]
    level_mesh = None
    if mesh is not None:
        level_mesh = constrain_level(u, mesh, shard_min)
    if lvl == n_levels - 1:
        return _smooth(u, v, t, c, cu, cv, p, want_residuals=False, mesh=level_mesh)

    tc, cc = tensors[lvl + 1], consts[lvl + 1]
    for _ in range(p.cycle_index):
        u, v, ru, rv = _smooth(u, v, t, c, cu, cv, p, want_residuals=True, mesh=level_mesh)
        ru_res, rv_res, u_res, v_res = (_restrict(x, p.scl_factor) for x in (ru, rv, u, v))

        # gd is (C, H, W): so is the coarse RHS, which the coarse level's
        # smoothing multiplies by its own per-channel gd and sums over C
        gd = _gd(tc, u_res, v_res, p)
        ww, wn, we, ws = diffusion_weights_4((u_res, v_res), eps=1e-5, combine="sum")
        au, av = lhs_elin4(
            u_res, v_res, _reduce_c(cc["m"] * gd),
            _reduce_c(cc["du"] * gd), _reduce_c(cc["dv"] * gd), ww, wn, we, ws,
        )
        fu = (ru_res + au) / gd
        fv = (rv_res + av) / gd

        uc, vc = _fas_cycle(u_res, v_res, tensors, consts, fu, fv, lvl + 1, n_levels, p,
                            mesh, shard_min)

        shape = u.shape[-2:]
        u = u + imresize((uc - u_res) / p.scl_factor, shape, "bilinear")
        v = v + imresize((vc - v_res) / p.scl_factor, shape, "bilinear")

    return _smooth(u, v, t, c, cu, cv, p, want_residuals=False, mesh=level_mesh)


def flow_fmg(it0, it1, params: FlowFMGParams | None = None, collect: list | None = None,
             mesh=None, shard_min: int = 64, device=None, **overrides):
    """FAS-FMG early-linearisation flow. it0/it1: (H, W) or (C, H, W)
    uint8-range images, as numpy arrays or tensors. Returns (U, V) float32
    (H, W) tensors on the device of ``it0`` if it is a tensor, else on
    ``device``, else on the CUDA card (raises where there is none).

    collect: optional list; (U, V) after each top-level FAS cycle is
    appended, coarsest first.
    mesh: optional ("ty", "tx") ``parallel.mesh.Mesh``: the call runs on
    the mesh's first device (an input or ``device`` of another kind
    raises); fine FAS levels solve sharded, levels below ``shard_min`` px
    whole."""
    p = with_overrides(params or FlowFMGParams(), **overrides)
    check_solver("flow_fmg", p.solver)
    if mesh is not None:
        device = mesh_device(mesh, it0, device)
        it0 = it0.to(device) if torch.is_tensor(it0) else it0
    device = input_device(it0, device)
    a = as_tensor(it0, device)
    b = as_tensor(it1, device)
    if a.ndim == 2:
        a, b = a[None], b[None]

    g = gaussian_kernel_2d(5, 1.0)
    levels = [(imfilter_replicate(a, g), imfilter_replicate(b, g))]
    while len(levels) < p.scales:
        pa, pb = levels[-1]
        na = _decimate(separable_filter(pa, binomial5, binomial5))
        nb = _decimate(separable_filter(pb, binomial5, binomial5))
        levels.append((na, nb))
        if na.shape[-2] <= 10 or na.shape[-1] <= 10:
            break

    tensors = [_derivative_tensors(l0, l1, p) for l0, l1 in levels]
    consts = [_constancy(t, p) for t in tensors]
    n = len(levels)

    u = v = None
    for lvl in range(n - 1, -1, -1):
        h, w = levels[lvl][0].shape[-2:]
        if u is None:
            u = torch.zeros((h, w), dtype=torch.float32, device=device)
            v = torch.zeros_like(u)
        u, v = _fas_cycle(u, v, tensors, consts, consts[lvl]["cu"], consts[lvl]["cv"], lvl, n,
                          p, mesh, shard_min)
        if collect is not None:
            collect.append((u, v))
        if lvl > 0:
            nh, nw = levels[lvl - 1][0].shape[-2:]
            # MATLAB imresize's default method (bicubic), :179-182
            u = imresize(u / p.scl_factor, (nh, nw), "bicubic")
            v = imresize(v / p.scl_factor, (nh, nw), "bicubic")
    return u, v


def flow_fmg_fused(it0, it1, params: FlowFMGParams | None = None, device=None):
    """``flow_fmg`` (pyramid, tensors and every FAS cycle) as one replayed
    CUDA graph a frame on the card, as ``flow_nd_fused``
    (``models/_graph.py``); on the CPU it is ``flow_fmg``."""
    return replay(flow_fmg, (params,), (it0, it1), device)
