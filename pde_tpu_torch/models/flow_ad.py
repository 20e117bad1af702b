"""Late-linearisation optical flow with anisotropic (tensor) diffusion
(FlowEminAD_llin_2D_v10.m), ported from ``pde_tpu/models/flow_ad.py``.

The warping skeleton of ``models/flow_nd.py`` (its coarse-to-fine loop and
robust data terms), with an 8-neighbour smoothness stencil built from a
2x2 diffusion tensor with a quantile-adaptive lambda
(``ops/weights.tensor_diffusion_weights_8``):

* ``diffusion='image'``: the tensor of the (smoothed) image at each
  level, computed once per level;
* ``diffusion='flow'``: the tensor of the scalar field ``U+dU+V+dV``,
  recomputed at every secondLoop iteration.

Runs eagerly on the card unless the caller asks for the CPU
(``models/_device.py``). The inner solve is red-black SOR through
``kernels/dispatch.py`` (``solver=1``, the CUDA llin8 kernel for CUDA
tensors) or the line-implicit PCG of ``solvers/krylov.py`` (``solver=2``,
its line solves the CUDA tridiagonal kernel).
"""

from __future__ import annotations

import dataclasses

import torch

from pde_tpu_torch.config import with_overrides
from pde_tpu_torch.core.median import medfilt2_3x3
from pde_tpu_torch.kernels.dispatch import robust_flow, sor_flow_llin8
from pde_tpu_torch.models._graph import replay
from pde_tpu_torch.models.flow_nd import (_coarse_to_fine, _fst_tensors, _snd_tensors,
                                          check_solver)
from pde_tpu_torch.ops.warp import warp_by_flow
from pde_tpu_torch.ops.weights import tensor_diffusion_weights_8
from pde_tpu_torch.solvers.krylov import pcg_flow_llin8


@dataclasses.dataclass(frozen=True)
class FlowADParams:
    """Defaults from FlowEminAD_llin_2D_v10.m:55-72 (as ``pde_tpu``'s)."""

    quantile: float = 0.9
    diffusion: str = "image"
    alpha: float = 0.0420
    omega: float = 1.9
    gammaS: float = 0.01
    firstLoop: int = 4
    secondLoop: int = 4
    iter: int = 4
    b1: float = 1.4843
    b2: float = 0.2915
    scl_factor: float = 0.75
    # 1: red-black SOR (the CUDA llin8 kernel); 2: line-implicit PCG (the
    # CUDA tridiagonal kernel)
    solver: int = 1
    scales: int = 10**9


def params_from_reference(obj) -> FlowADParams:
    """This package's ``FlowADParams`` from any dataclass instance or dict
    with its field names (such as a ``pde_tpu`` ``FlowADParams``).
    Unknown names raise ``TypeError``."""
    values = dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) else dict(obj)
    return with_overrides(FlowADParams(), **values)


def _ad_level(u, v, it0, i1t0, i1t1, i2t0, i2t1, us_ap, vs_ap, as_diff, p: FlowADParams,
              snd_is_gradmag: bool):
    """One pyramid level. it0 is the (smoothed) image driving the 'image'
    diffusion tensor; i1*/i2* are the constancy-term stacks (i2* None for
    the 'none' term); us_ap/vs_ap may be None (no spatial prior)."""
    image_diff = p.diffusion.lower() == "image"
    if image_diff:
        w8 = tensor_diffusion_weights_8(it0, quantile=p.quantile)

    for _first in range(p.firstLoop):
        i1t1w = warp_by_flow(i1t1, u, v)
        t1 = _fst_tensors(i1t0, i1t1w)
        t2 = None
        if i2t1 is not None:
            i2t1w = warp_by_flow(i2t1, u, v)
            t2 = _snd_tensors(i2t0, i2t1w) if snd_is_gradmag else _fst_tensors(i2t0, i2t1w)

        du = torch.zeros_like(u)
        dv = torch.zeros_like(v)

        for _second in range(p.secondLoop):
            m_gd, cu_gd, cv_gd, du_gd, dv_gd = robust_flow(
                t1, t2, u, v, du, dv, us_ap, vs_ap, as_diff, p, snd_is_gradmag)
            if not image_diff:
                w8 = tensor_diffusion_weights_8(u + du + v + dv, quantile=p.quantile)
            solve = pcg_flow_llin8 if p.solver == 2 else sor_flow_llin8
            du, dv = solve(u, v, du, dv, m_gd, cu_gd, cv_gd, du_gd, dv_gd,
                           *w8, p.iter, p.omega)

        u = medfilt2_3x3(u + du)
        v = medfilt2_3x3(v + dv)
    return u, v


def flow_ad(it0, it1, fst_term: str = "grad", snd_term: str = "gradmag",
            params: FlowADParams | None = None, us=None, vs=None,
            collect: list | None = None, device=None, **overrides):
    """Anisotropic-diffusion warping flow. it0/it1: (C, H, W) or (H, W)
    uint8-range images, as numpy arrays or tensors.

    us/vs: optional spatial prior flow fields (H, W). Returns (U, V)
    float32 (H, W) tensors on the device of ``it0`` if it is a tensor,
    else on ``device``, else on the CUDA card (raises where there is
    none). collect: optional list; per-level (U, V) appended
    coarsest-first (before upscaling).
    """
    p = with_overrides(params or FlowADParams(), **overrides)
    check_solver("flow_ad", p.solver)
    return _coarse_to_fine(it0, it1, fst_term, snd_term, p, us, vs, collect, device,
                           _ad_level)


def flow_ad_fused(it0, it1, fst_term: str = "grad", snd_term: str = "gradmag",
                  params: FlowADParams | None = None, device=None):
    """``flow_ad`` as one replayed CUDA graph a frame on the card, as
    ``flow_nd_fused`` (``models/_graph.py``); on the CPU it is
    ``flow_ad``."""
    return replay(flow_ad, (fst_term, snd_term, params), (it0, it1), device)
