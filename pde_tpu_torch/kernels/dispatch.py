"""Solver dispatch: the hand-written kernel for CUDA tensors, the plain
PyTorch version for CPU tensors.

A CUDA tensor goes to a kernel or raises; it never falls back. Every SOR
solve (llin4, elin4, disp llin4, pde4, llin8 and pde8) goes where
``sor_route`` sends its shape, a pure function of the family, the (H, W),
the batch, the sweeps and the card's SM count, decided before any launch,
as ``pde_tpu`` chooses between its resident and tiled kernels
(``pde_tpu/kernels/dispatch.py``):

- the resident kernels (one launch a call, ``resident_cuda``) wherever
  ``resident_cuda.plan_resident`` gives the shape a plan;
- else the temporally blocked tile kernel (``tiled_cuda``,
  ``ceil(iters / k)`` launches a call) wherever ``tiled.plan_tiles`` gives
  one at ``k_max = 4`` and the kernel takes the batch (llin4, elin4 and
  llin8 one system, disp llin4 up to 2, pde4 and pde8 up to 3 channels
  over shared weights) and, for the families that fill the border, H, W
  >= 3, as ``pde_tpu`` sends a grid too large for VMEM to
  ``_stripe_kernel`` with ``k_max = 4``: the 1024x1024 levels of every
  family, elin4's 768x768, pde4 and pde8 with C = 3 at 481x641 (pde4 also
  at 576x576 and 768x768);
- else the global kernels (``sor_cuda``, ``interior_cuda``), one launch a
  colour.

The reweighting step of the warping models takes the same rule: the
robust data terms (``robust_flow``, ``robust_disp``) and the diffusion
weights of every caller (``diffusion_weights_4``) run one launch each of
``csrc/reweight.cu`` for CUDA tensors, the plain ``ops/robust.py`` and
``ops/weights.py`` for CPU tensors; each call adds 1 to the counter
``reweight.kernel`` or ``reweight.plain`` (``utils/observe.py``).

``plain_solvers()`` (``kernels/plain_mode.py``) runs the plain version on
any device, so that a check can hold the kernel against it on the card;
the package itself never enters it.

Every tridiagonal line solve of the package comes through here
(``thomas_solve``, ``tridiag_factor``/``tridiag_solve`` and the zebra
helpers ``line_factors``/``line_solve``, and the preconditioner's fused
``zebra_pass``). On the card, one factor of the
full field serves both zebra parities (the kernel's per-line arithmetic is
the same); in the plain version each parity's lines have their own, as in
``pde_tpu``.
"""

from __future__ import annotations

import torch

from pde_tpu_torch.kernels import (interior_cuda, resident_cuda, reweight_cuda, sor_cuda,
                                   tdma_cuda, tiled, tiled_cuda)
from pde_tpu_torch.kernels.plain_mode import _FORCE_PLAIN, plain_solvers  # noqa: F401
from pde_tpu_torch.kernels.plain_mode import is_plain as _plain
from pde_tpu_torch.ops import robust as _robust
from pde_tpu_torch.ops import weights as _weights
from pde_tpu_torch.solvers import sor as _sor
from pde_tpu_torch.solvers import tdma as _tdma
from pde_tpu_torch.utils import observe


# the tile kernel's family (tiled.LAYOUTS) of each solver family
TILE_FAMILY = {"llin4": "flow_llin4", "elin4": "flow_elin4", "disp": "disp_llin4",
               "pde4": "pde4", "llin8": "flow_llin8", "pde8": "pde8"}


def sor_route(family: str, h: int, w: int, batch: int = 1, iters: int = 4,
              sm_count: int = resident_cuda.SM_COUNT):
    """Where a solve of ``family`` (``resident_cuda.FAMILIES``) over a
    batch of (h, w) systems and ``iters`` sweeps goes on a card of
    ``sm_count`` SMs: ``("resident", ResidentPlan)``, ``("tiled",
    TilePlan)`` or ``("global", None)``."""
    plan = resident_cuda.plan_resident(h, w, family, batch, sm_count)
    if plan is not None:
        return "resident", plan
    layout = tiled.LAYOUTS[TILE_FAMILY[family]]
    # W4: the border fill of an image under 3 px is the global kernels'
    if 1 <= batch <= layout.max_batch and (not layout.fill or min(h, w) >= 3):
        # plan_tiles' default k_max = 4, pde_tpu's for grids too large for VMEM
        tile_plan = tiled.plan_tiles(h, w, TILE_FAMILY[family], max(int(iters), 1),
                                     sm_count=sm_count, batch=batch)
        if tile_plan is not None:
            return "tiled", tile_plan
    return "global", None


def _route(x, family: str, batch: int, iters: int):
    """``sor_route`` of systems shaped like ``x`` (..., H, W) on its card."""
    return sor_route(family, *x.shape[-2:], batch, iters,
                     resident_cuda.sm_count(x.device.index or 0))


def _tiled(family: str, fields, iters: int, omega: float, plan):
    return tiled_cuda.tiled_sor(TILE_FAMILY[family], fields, iters, omega, plan.k, plan.tile_h,
                                plan.tile_w, slots=plan.slots)


def sor_flow_llin4(u, v, du, dv, m, cu, cv, duc, dvc, ww, wn, we, ws,
                   iters: int, omega: float):
    args = (u, v, du, dv, m, cu, cv, duc, dvc, ww, wn, we, ws, iters, omega)
    if _plain(u):
        return _sor.sor_flow_llin4(*args)
    route, plan = _route(u, "llin4", 1, iters) if u.ndim == 2 else ("global", None)
    if route == "resident":
        return resident_cuda.flow_llin4_sor(*args, plan=plan)
    if route == "tiled":
        return _tiled("llin4", (du, dv, u, v, m, cu, cv, duc, dvc, ww, wn, we, ws), iters, omega,
                      plan)
    return sor_cuda.flow_llin4_sor(*args)


def sor_flow_elin4(u, v, m, cu, cv, duc, dvc, ww, wn, we, ws, iters: int, omega: float):
    args = (u, v, m, cu, cv, duc, dvc, ww, wn, we, ws, iters, omega)
    if _plain(u):
        return _sor.sor_flow_elin4(*args)
    route, plan = _route(u, "elin4", 1, iters) if u.ndim == 2 else ("global", None)
    if route == "resident":
        return resident_cuda.flow_elin4_sor(*args, plan=plan)
    if route == "tiled":
        return _tiled("elin4", args[:-2], iters, omega, plan)
    return sor_cuda.flow_elin4_sor(*args)


def sor_flow_llin8(u, v, du, dv, m, cu, cv, duc, dvc,
                   ww, wnw, wn, wne, we, wse, ws, wsw, iters: int, omega: float):
    args = (u, v, du, dv, m, cu, cv, duc, dvc, ww, wnw, wn, wne, we, wse, ws, wsw,
            iters, omega)
    if _plain(u):
        return _sor.sor_flow_llin8(*args)
    route, plan = _route(u, "llin8", 1, iters) if u.ndim == 2 else ("global", None)
    if route == "resident":
        return resident_cuda.flow_llin8_sor(*args, plan=plan)
    if route == "tiled":
        return _tiled("llin8", (du, dv, u, v, m, cu, cv, duc, dvc, ww, wnw, wn, wne, we, wse, ws,
                                wsw), iters, omega, plan)
    return sor_cuda.flow_llin8_sor(*args)


def sor_disp_llin4(u, du, cu, duc, ww, wn, we, ws, iters: int, omega: float):
    args = (u, du, cu, duc, ww, wn, we, ws, iters, omega)
    if _plain(u):
        return _sor.sor_disp_llin4(*args)
    route, plan = (_route(u, "disp", u.shape[0] if u.ndim == 3 else 1, iters)
                   if u.ndim in (2, 3) else ("global", None))
    if route == "resident":
        return resident_cuda.disp_llin4_sor(*args, plan=plan)
    if route == "tiled":
        return _tiled("disp", (du, u, cu, duc, ww, wn, we, ws), iters, omega, plan)[0]
    return interior_cuda.disp_llin4_sor(*args)


def sor_disp_llin_sym4(u0, du0, cu0, duc0, ww0, wn0, we0, ws0,
                       u1, du1, cu1, duc1, ww1, wn1, we1, ws1,
                       iters: int, omega: float):
    """The symmetric pair as one kernel call with a batch of 2: on the
    resident and the tile kernel each system keeps its own planes; the
    global kernel takes them stacked."""
    if _plain(u0):
        return _sor.sor_disp_llin_sym4(u0, du0, cu0, duc0, ww0, wn0, we0, ws0,
                                       u1, du1, cu1, duc1, ww1, wn1, we1, ws1, iters, omega)
    route, plan = _route(u0, "disp", 2, iters) if u0.ndim == 2 else ("global", None)
    if route == "resident":
        return resident_cuda.disp_llin4_pair((u0, du0, cu0, duc0, ww0, wn0, we0, ws0),
                                             (u1, du1, cu1, duc1, ww1, wn1, we1, ws1),
                                             iters, omega, plan=plan)
    if route == "tiled":
        (out0,), (out1,) = tiled_cuda.tiled_sor_systems(
            "disp_llin4", [(du0, u0, cu0, duc0, ww0, wn0, we0, ws0),
                           (du1, u1, cu1, duc1, ww1, wn1, we1, ws1)],
            iters, omega, plan.k, plan.tile_h, plan.tile_w, plan.slots)
        return out0, out1
    pairs = ((u0, u1), (du0, du1), (cu0, cu1), (duc0, duc1),
             (ww0, ww1), (wn0, wn1), (we0, we1), (ws0, ws1))
    out = interior_cuda.disp_llin4_sor(*(torch.stack(pair) for pair in pairs), iters, omega)
    return out[0], out[1]


def sor_pde4(x, trace, b, ww, wn, we, ws, iters: int, omega: float):
    """(H, W) or (C, H, W) unknowns alike: on the card the resident or the
    tile kernel takes up to 3 channels over shared (H, W) weights where
    ``sor_route`` sends the shape, the global kernel every other call."""
    args = (x, trace, b, ww, wn, we, ws, iters, omega)
    if _plain(x):
        return _sor.sor_pde4(*args)
    channels = resident_cuda.diag_channels("pde4", x, trace, b, (ww, wn, we, ws))
    route, plan = _route(x, "pde4", channels, iters) if channels else ("global", None)
    if route == "resident":
        return resident_cuda.pde4_sor(*args, plan=plan)
    if route == "tiled":
        return _tiled("pde4", args[:-2], iters, omega, plan)[0]
    return interior_cuda.pde4_sor(*args)


def sor_pde8(x, trace, b, ww, wnw, wn, wne, we, wse, ws, wsw, iters: int, omega: float):
    """As ``sor_pde4``, with the eight weights W, NW, N, NE, E, SE, S, SW."""
    args = (x, trace, b, ww, wnw, wn, wne, we, wse, ws, wsw, iters, omega)
    if _plain(x):
        return _sor.sor_pde8(*args)
    channels = resident_cuda.diag_channels("pde8", x, trace, b,
                                           (ww, wnw, wn, wne, we, wse, ws, wsw))
    route, plan = _route(x, "pde8", channels, iters) if channels else ("global", None)
    if route == "resident":
        return resident_cuda.pde8_sor(*args, plan=plan)
    if route == "tiled":
        return _tiled("pde8", args[:-2], iters, omega, plan)[0]
    return interior_cuda.pde8_sor(*args)


def thomas_solve(a, b, c, d, axis: int = -2):
    """Tridiagonal systems along ``axis`` (a[0] and c[-1] ignored)."""
    if _plain(d):
        return _tdma.thomas_solve(a, b, c, d, axis)
    return tdma_cuda.thomas_solve(a, b, c, d, axis)


def tridiag_factor(a, b, c, axis: int = -2):
    """The elimination of the systems along ``axis``, for ``tridiag_solve``."""
    if _plain(b):
        return _tdma.tridiag_factor(a, b, c, axis)
    return tdma_cuda.tridiag_factor(a, b, c, axis)


def tridiag_solve(fac, d, axis: int = -2):
    """Solve with a factor of ``tridiag_factor`` for a new RHS."""
    if _plain(d):
        return _tdma.tridiag_solve(fac, d, axis)
    return tdma_cuda.tridiag_solve(fac, d)


def line_factors(a, b, c, vertical: bool):
    """Factors for the zebra line solves of ``line_solve``: columns
    (``vertical``) or rows."""
    if _plain(b):
        return _tdma.line_factors(a, b, c, vertical)
    fac = tdma_cuda.tridiag_factor(a, b, c, -2 if vertical else -1)
    return fac, fac


def line_solve(facs, d_full, parity: int, vertical: bool):
    """The lines ``parity::2`` (columns if ``vertical``, else rows) of the
    solve with RHS ``d_full``, compactly."""
    if _plain(d_full):
        return _tdma.line_solve(facs, d_full, parity, vertical)
    return tdma_cuda.tridiag_solve(facs[parity], d_full, parity)


def zebra_pass(facs, z, rhs, w_lo, w_hi, parity: int, vertical: bool, z_o=None, m=None,
               w_diag=None):
    """One zebra-ADI pass on the lines ``parity::2`` of ``z`` (see
    ``solvers/tdma.py::zebra_pass``), ``facs`` from ``line_factors``.
    Returns the new ``z``: a new tensor on the plain path; on the card the
    kernel writes into ``z``, the solver's own buffer, and returns it."""
    args = (z, rhs, w_lo, w_hi, parity)
    if _plain(z):
        return _tdma.zebra_pass(facs, *args, vertical, z_o, m, w_diag)
    return tdma_cuda.zebra_pass(facs[parity], *args, z_o, m, w_diag)


def _reweight_plain(x) -> bool:
    plain = _plain(x)
    observe.count("reweight.plain" if plain else "reweight.kernel")
    return plain


def robust_flow(t1, t2, u, v, du, dv, us_ap, vs_ap, as_diff, p, snd_is_gradmag: bool):
    """The (M, Cu, Cv, Du, Dv) of one reweighting of the warping flows
    (``ops/robust.py::robust_terms_flow``) from the terms' derivative
    planes."""
    if _reweight_plain(u):
        return _robust.robust_terms_flow(t1, t2, u, v, du, dv, us_ap, vs_ap, as_diff, p,
                                         snd_is_gradmag)
    return reweight_cuda.robust_flow(t1, t2, u, v, du, dv, us_ap, vs_ap, as_diff, p.alpha,
                                     p.b1, p.b2, p.gammaS, snd_is_gradmag)


def robust_disp(d1, d2, u, du, us_ap, as_diff, p, snd_is_gradmag: bool):
    """(Cu, Du) of one reweighting of the disparity
    (``ops/robust.py::robust_terms_disp``)."""
    if _reweight_plain(u):
        return _robust.robust_terms_disp(d1, d2, u, du, us_ap, as_diff, p, snd_is_gradmag)
    return reweight_cuda.robust_disp(d1, d2, u, du, us_ap, as_diff, p.alpha, p.b1, p.b2,
                                     p.gammaS, snd_is_gradmag)


def diffusion_weights_4(fields, eps: float = 1e-5, combine: str = "sum",
                        zero_borders: bool = False, increments=None):
    """``ops/weights.py::diffusion_weights_4`` of ``fields`` plus
    ``increments``: each a (C, H, W) or (H, W) tensor or a sequence of
    (H, W) planes, ``increments`` None or like ``fields``. On the card the
    kernel adds the increments as it reads the fields (no sum or stack of
    planes is made), for up to ``reweight_cuda.MAX_FIELDS`` channels."""
    single = torch.is_tensor(fields)
    first = fields if single else fields[0]
    if _reweight_plain(first):
        if increments is not None:
            fields = fields + increments if single else [f + d for f, d in
                                                         zip(fields, increments)]
        if not torch.is_tensor(fields):
            fields = torch.stack(list(fields))
        return _weights.diffusion_weights_4(fields, eps, combine, zero_borders)

    def planes(x):
        return [x] if torch.is_tensor(x) and x.ndim == 2 else list(x)

    return reweight_cuda.weights4(planes(fields),
                                  None if increments is None else planes(increments),
                                  eps, combine, zero_borders)
