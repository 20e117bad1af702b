"""Late-linearisation (Brox-style warping) optical flow with isotropic
nonlinear diffusion: the reference's flagship pipeline
(FlowEminND_llin_2D_v10.m), ported from ``pde_tpu/models/flow_nd.py``.

Per pyramid level (factor 0.75, stop <= 20 px):

  firstLoop (warping fixed point):
    warp constancy images by (U, V)           -> NaN outside the domain
    5-tap Simoncelli derivative tensors M/Cu/Cv/Du/Dv per channel
    secondLoop (robust-weight fixed point):
      gD = b/(alpha*sqrt(residual^2 + 1e-5))  per constancy term
      Brox 6-pt diffusion weights of (U+dU, V+dV)
      nansum-reduce channel tensors, `iter` red-black SOR sweeps for (dU, dV)
    U <- medfilt3x3(U + dU)  (symmetric padding)
  upscale by 1/0.75 with the 'triangle' kernel, flow values scaled

Runs eagerly on the card unless the caller asks for the CPU
(``models/_device.py``). The inner solve is red-black SOR through
``kernels/dispatch.py`` (``solver=1``, the CUDA llin4 kernel for CUDA
tensors) or the line-implicit PCG of ``solvers/krylov.py`` (``solver=2``,
its line solves the CUDA tridiagonal kernel).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import torch

from pde_tpu_torch.config import with_overrides
from pde_tpu_torch.core.median import medfilt2_3x3
from pde_tpu_torch.core.pyramid import build_pyramid
from pde_tpu_torch.core.resize import imresize
from pde_tpu_torch.ops.derivatives import fst_derivatives5, snd_derivatives5, rgb2grad
from pde_tpu_torch.ops.warp import warp_by_flow, warp_window
from pde_tpu_torch.ops.weights import diffusion_weights_4
from pde_tpu_torch.kernels.dispatch import sor_flow_llin4
from pde_tpu_torch.models._device import as_tensor, input_device
from pde_tpu_torch.models._graph import replay
from pde_tpu_torch.parallel.mesh import mesh_device
from pde_tpu_torch.parallel.model import mesh_nd_level
from pde_tpu_torch.solvers.krylov import pcg_flow_llin4
from pde_tpu_torch.utils.observe import span


@dataclasses.dataclass(frozen=True)
class FlowNDParams:
    """Defaults from FlowEminND_llin_2D_v10.m:53-67 (as ``pde_tpu``'s)."""

    alpha: float = 0.0420
    omega: float = 1.9
    gammaS: float = 0.01
    firstLoop: int = 4
    secondLoop: int = 4
    iter: int = 4
    b1: float = 1.4843
    b2: float = 0.2915
    scl_factor: float = 0.75
    # 1: red-black SOR (the CUDA llin4 kernel); 2: line-implicit PCG (the
    # CUDA tridiagonal kernel)
    solver: int = 1
    scales: int = 10**9
    # windowed shift-add warp radius (ops/warp.warp_window); 0 = exact
    # gather warp. With radius r the warp is exact for |flow| < r; beyond
    # it the sample becomes NaN (missing data).
    warp_window: int = 0


def params_from_reference(obj) -> FlowNDParams:
    """This package's ``FlowNDParams`` from any dataclass instance or dict
    with its field names (such as a ``pde_tpu`` ``FlowNDParams``).
    Unknown names raise ``TypeError``."""
    values = dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) else dict(obj)
    return with_overrides(FlowNDParams(), **values)


def _fst_tensors(i_t0, i_t1w):
    idt, idx, idy = fst_derivatives5(i_t0, i_t1w)
    return dict(
        m=idy * idx, cu=idt * idx, cv=idt * idy, du=idx * idx, dv=idy * idy,
        dt=idt, dx=idx, dy=idy,
    )


def _snd_tensors(i_t0, i_t1w):
    idxt, idyt, idxx, idyy, idxy = snd_derivatives5(i_t0, i_t1w)
    return dict(
        m=idxy * (idxx + idyy),
        cu=idxt * idxx + idyt * idxy,
        cv=idxt * idxy + idyt * idyy,
        du=idxx * idxx + idxy * idxy,
        dv=idxy * idxy + idyy * idyy,
        dxt=idxt, dyt=idyt, dxx=idxx, dyy=idyy, dxy=idxy,
    )


def check_solver(name: str, solver: int):
    """Raise for a solver other than 1 (red-black SOR) or 2 (line-implicit
    PCG), the two every model has."""
    if solver not in (1, 2):
        raise ValueError(f"{name} solver={solver}: the solvers are 1 (red-black SOR) "
                         "and 2 (line-implicit PCG)")


def _robust_terms(t1, t2, u, v, du, dv, us_ap, vs_ap, as_diff, p, snd_is_gradmag: bool):
    """The channel-summed (M, Cu, Cv, Du, Dv) of one reweighting of the
    warping flows (flow_nd, flow_ad): each constancy term's tensors under
    its robust weight gD = b/(alpha*sqrt(residual^2 + 1e-5)) at the
    current increments, plus the spatial priors' terms. t2, us_ap and vs_ap
    may be None."""
    op1 = (t1["dt"] - t1["dx"] * du - t1["dy"] * dv) ** 2
    gd1 = p.b1 / (p.alpha * torch.sqrt(op1 + 1e-5))
    parts_m = [t1["m"] * gd1]
    parts_cu = [t1["cu"] * gd1]
    parts_cv = [t1["cv"] * gd1]
    parts_du = [t1["du"] * gd1]
    parts_dv = [t1["dv"] * gd1]
    if t2 is not None:
        if snd_is_gradmag:
            op2 = (t2["dxt"] - t2["dxx"] * du - t2["dxy"] * dv) ** 2 + (
                t2["dyt"] - t2["dxy"] * du - t2["dyy"] * dv
            ) ** 2
        else:
            op2 = (t2["dt"] - t2["dx"] * du - t2["dy"] * dv) ** 2
        gd2 = p.b2 / (p.alpha * torch.sqrt(op2 + 1e-5))
        parts_m.append(t2["m"] * gd2)
        parts_cu.append(t2["cu"] * gd2)
        parts_cv.append(t2["cv"] * gd2)
        parts_du.append(t2["du"] * gd2)
        parts_dv.append(t2["dv"] * gd2)
    if us_ap is not None:
        ap_norm = (us_ap - u - du) ** 2
        gsu = p.gammaS / (p.alpha * (1.0 + ap_norm / as_diff**2))
        parts_cu.append(((us_ap - u) * gsu)[None])
        parts_du.append(gsu[None])
    if vs_ap is not None:
        ap_norm = (vs_ap - v - dv) ** 2
        gsv = p.gammaS / (p.alpha * (1.0 + ap_norm / as_diff**2))
        parts_cv.append(((vs_ap - v) * gsv)[None])
        parts_dv.append(gsv[None])

    def nsum(parts):
        return sum(torch.nansum(x, dim=0) for x in parts)

    return tuple(nsum(parts) for parts in (parts_m, parts_cu, parts_cv, parts_du, parts_dv))


def _nd_level(u, v, it0, i1t0, i1t1, i2t0, i2t1, us_ap, vs_ap, as_diff, p: FlowNDParams,
              snd_is_gradmag: bool, sor=sor_flow_llin4):
    """One pyramid level of the warping flow. it0 (the level's image) is
    unused here (flow_ad's tensor reads it); i2* may be None ('none'
    term); us_ap/vs_ap may be None (no spatial prior). ``sor`` is the
    solver=1 solve (over a mesh, ``parallel/model.py`` passes the sharded
    one)."""
    warp = partial(warp_window, r=p.warp_window) if p.warp_window > 0 else warp_by_flow

    for _first in range(p.firstLoop):
        with span("warp"):
            i1t1w = warp(i1t1, u, v)
            t1 = _fst_tensors(i1t0, i1t1w)
            t2 = None
            if i2t1 is not None:
                i2t1w = warp(i2t1, u, v)
                t2 = _snd_tensors(i2t0, i2t1w) if snd_is_gradmag else _fst_tensors(i2t0, i2t1w)

            du = torch.zeros_like(u)
            dv = torch.zeros_like(v)

        for _second in range(p.secondLoop):
            with span("robust"):
                m_gd, cu_gd, cv_gd, du_gd, dv_gd = _robust_terms(
                    t1, t2, u, v, du, dv, us_ap, vs_ap, as_diff, p, snd_is_gradmag)
            with span("weights"):
                ww, wn, we, ws = diffusion_weights_4(
                    torch.stack([u + du, v + dv]), eps=1e-5, combine="sum"
                )
            solve = pcg_flow_llin4 if p.solver == 2 else sor
            with span("solve"):
                du, dv = solve(u, v, du, dv, m_gd, cu_gd, cv_gd, du_gd, dv_gd,
                               ww, wn, we, ws, p.iter, p.omega)

        with span("median"):
            u = medfilt2_3x3(u + du)
            v = medfilt2_3x3(v + dv)
    return u, v


def _coarse_to_fine(it0, it1, fst_term: str, snd_term: str, p, us, vs, collect, device,
                    level_fn):
    """The coarse-to-fine loop of the warping flows (flow_nd, flow_ad): images
    to [0, 1] on the device rule, a pyramid (factor scl_factor, stop <= 20
    px), the priors' pyramids, then ``level_fn(u, v, l0, i1t0, i1t1, i2t0,
    i2t1, us_ap, vs_ap, as_diff, p, snd_is_gradmag)`` coarse to fine with
    the flow upscaled between levels. Returns (U, V)."""
    fst_term = fst_term.lower()
    snd_term = snd_term.lower()
    device = input_device(it0, device)

    def fst_img(img):
        return rgb2grad(img) if fst_term == "grad" else img

    def snd_img(img):
        return None if snd_term == "none" else img

    def prior_pyramid(prior):
        if prior is None:
            return [None] * n
        cur = torch.nan_to_num(as_tensor(prior, device))
        out = [cur]
        for lvl in range(1, n):
            cur = imresize(cur * p.scl_factor, levels[lvl][0].shape[-2:], "bilinear")
            out.append(cur)
        return out

    with span("pyramid"):
        a = as_tensor(it0, device) / 255.0
        b = as_tensor(it1, device) / 255.0
        if a.ndim == 2:
            a, b = a[None], b[None]

        levels = build_pyramid([a, b], p.scl_factor, 20, 5, 1.25, p.scales)
        n = len(levels)
        # spatial prior pyramid: flow scaled by scl_factor at each level (:176)
        us_lv = prior_pyramid(us)
        vs_lv = prior_pyramid(vs)

    u = v = None
    for lvl in range(n - 1, -1, -1):
        l0, l1 = levels[lvl]
        h, w = l0.shape[-2:]
        with span("level", index=lvl, shape=(h, w)):
            with span("pyramid"):
                if u is None:
                    zero = partial(torch.zeros, (h, w), device=device)
                    u = us_lv[lvl] if us_lv[lvl] is not None else zero()
                    v = vs_lv[lvl] if vs_lv[lvl] is not None else zero()
                i1t0, i1t1 = fst_img(l0), fst_img(l1)
            as_diff = 2.0 * (1.0 / p.scl_factor) ** (-(lvl))  # ASdiff at this level (:197)
            u, v = level_fn(u, v, l0, i1t0, i1t1, snd_img(l0), snd_img(l1),
                            us_lv[lvl], vs_lv[lvl], as_diff, p, snd_term == "gradmag")
            if collect is not None:
                collect.append((u, v))
            if lvl > 0:
                nh, nw = levels[lvl - 1][0].shape[-2:]
                with span("pyramid"):
                    u = imresize(u / p.scl_factor, (nh, nw), "triangle")
                    v = imresize(v / p.scl_factor, (nh, nw), "triangle")
    return u, v


def flow_nd(it0, it1, fst_term: str = "grad", snd_term: str = "gradmag",
            params: FlowNDParams | None = None, us=None, vs=None,
            collect: list | None = None, mesh=None, shard_min: int = 64, device=None,
            **overrides):
    """Warping flow. it0/it1: (C, H, W) or (H, W) uint8-range images, as
    numpy arrays or tensors.

    us/vs: optional spatial prior flow fields (H, W) (param.Us/Vs).
    Returns (U, V) float32 (H, W) tensors on the device of ``it0`` if it
    is a tensor, else on ``device``, else on the CUDA card (raises where
    there is none). collect: optional list; per-level (U, V) appended
    coarsest-first.
    mesh: optional ("ty", "tx") ``parallel.mesh.Mesh``: the call runs on
    the mesh's first device (an input or ``device`` of another kind
    raises), and every pyramid level of at least ``shard_min`` px that
    divides over the mesh solves sharded (``parallel/model.py``), with the
    unsharded call's numbers.
    """
    p = with_overrides(params or FlowNDParams(), **overrides)
    check_solver("flow_nd", p.solver)
    level_fn = _nd_level
    if mesh is not None:
        device = mesh_device(mesh, it0, device)
        it0 = it0.to(device) if torch.is_tensor(it0) else it0
        level_fn = partial(mesh_nd_level, mesh=mesh, shard_min=shard_min)
    return _coarse_to_fine(it0, it1, fst_term, snd_term, p, us, vs, collect, device,
                           level_fn)


def flow_nd_fused(it0, it1, fst_term: str = "grad", snd_term: str = "gradmag",
                  params: FlowNDParams | None = None, device=None):
    """``flow_nd`` as one device program a frame, as ``pde_tpu``'s jitted
    whole frame: on the card, the frame is captured into a CUDA graph at
    the first call of its signature (the terms, ``params``, the images'
    shapes) and replayed at every call (``models/_graph.py``); on the CPU
    it is ``flow_nd``. Returns new (U, V) tensors."""
    return replay(flow_nd, (fst_term, snd_term, params), (it0, it1), device)


def flow_nd_sequence(frames, fst_term: str = "grad", snd_term: str = "gradmag",
                     params: FlowNDParams | None = None, device=None):
    """Flow for a video clip. frames: (T, H, W) or (T, C, H, W)
    uint8-range, on the device rule of ``flow_nd``. Returns (U, V) of
    shape (T-1, H, W): the flow of each consecutive pair, as ``flow_nd``
    computes it. Every pair is a call of ``flow_nd_fused``: on the card a
    replay of the graph of one (C, H, W) pair, queued with no host sync
    between pairs, as ``pde_tpu``'s ``lax.scan`` makes the clip one
    dispatch."""
    a = as_tensor(frames, input_device(frames, device))
    pairs = [flow_nd_fused(a[t], a[t + 1], fst_term, snd_term, params)
             for t in range(a.shape[0] - 1)]
    return torch.stack([u for u, _ in pairs]), torch.stack([v for _, v in pairs])
