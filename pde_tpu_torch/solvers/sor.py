"""Red-black SOR solvers: the plain PyTorch versions of the CUDA kernels
in ``csrc/``. Each is the path for CPU tensors and its kernel's reference
on the card.

Coupled flow pair, ``sor_flow_llin4``, ``sor_flow_elin4`` and the
8-neighbour ``sor_flow_llin8`` (kernel ``csrc/flow_llin4_sor.cu``),
written from ``_flow_sor`` (``pde_tpu/solvers/sor.py``, late=True and
late=False, eight=True):

* Border-solving convention: the out-facing weights are zeroed (for the
  diagonals, wherever the diagonal neighbour is off the image) and every
  pixel, border included, is relaxed with its one-sided stencil.
* NaN in Cu/Cv drops the data term; NaN in Du/Dv drops it from the
  divisor.
* Within each colour, u updates first and v then uses the refreshed u.
  A half-sweep computes its whole colour from the state before it (the
  diagonal neighbours of the 8-neighbour stencil have the pixel's own
  colour, so this is Jacobi within a colour).
* Diffusion term ``Σ w_k (dU_k + U_k − U_c)`` (late: the increments
  against the frozen flow) or ``Σ w_k U_k`` (early: the flow itself),
  summed W, E, N, S, then NW, NE, SW, SE; the weight sum in the order of
  the weights, W, N, E, S (4) or W, NW, N, NE, E, SE, S, SW (8).

Interior-update family, ``sor_disp_llin4``, ``sor_disp_llin_sym4``,
``sor_pde4`` and ``sor_pde8`` (kernel ``csrc/interior_sor.cu``), written
from ``_scalar_llin_sor`` and ``_pde_sor``:

* Only interior pixels are relaxed, colour 0 then colour 1, and the 1-px
  border is replicated after every sweep (``core/grid.replicate_border``).
* disparity: NaN in Cu means pure diffusion, NaN in Du drops it from the
  divisor. pde4/pde8: NaN in TRACE means pure diffusion (``1/Σw``, no B).
* Leading dimensions broadcast (a batch of independent systems).
"""

from __future__ import annotations

import torch

from pde_tpu_torch.core.grid import (
    checkerboard,
    interior_mask,
    replicate_border,
    shift_e,
    shift_n,
    shift_s,
    shift_w,
)


def _edge_zeroed(ww, wn, we, ws):
    ww, wn, we, ws = (x.clone() for x in (ww, wn, we, ws))
    ww[..., :, 0] = 0.0
    wn[..., 0, :] = 0.0
    we[..., :, -1] = 0.0
    ws[..., -1, :] = 0.0
    return ww, wn, we, ws


def _edge_zeroed8(ww, wnw, wn, wne, we, wse, ws, wsw):
    """The eight weights with every one whose neighbour is off the image
    zeroed (``pde_tpu``'s ``_edge_zero`` and ``_zero_diag_borders``)."""
    ww, wn, we, ws = _edge_zeroed(ww, wn, we, ws)
    wnw, wne, wse, wsw = (x.clone() for x in (wnw, wne, wse, wsw))
    for wt, row, col in ((wnw, 0, 0), (wne, 0, -1), (wse, -1, -1), (wsw, -1, 0)):
        wt[..., row, :] = 0.0
        wt[..., :, col] = 0.0
    return ww, wnw, wn, wne, we, wse, ws, wsw


def _weight_sum(weights):
    """Σw in the order of ``weights``, as ``pde_tpu``'s ``sum(weights)``."""
    total = weights[0]
    for wt in weights[1:]:
        total = total + wt
    return total


def _nbr_sum4(x, ww, wn, we, ws):
    return shift_w(x) * ww + shift_e(x) * we + shift_n(x) * wn + shift_s(x) * ws


def _nbr_sum8(x, ww, wnw, wn, wne, we, wse, ws, wsw):
    return (shift_w(x) * ww + shift_e(x) * we + shift_n(x) * wn + shift_s(x) * ws
            + shift_n(shift_w(x)) * wnw + shift_n(shift_e(x)) * wne
            + shift_s(shift_w(x)) * wsw + shift_s(shift_e(x)) * wse)


def _nbr_sum(weights):
    return _nbr_sum8 if len(weights) == 8 else _nbr_sum4


def _fold_data_nan(c, dc, wsum):
    """(NaN flag of c, c with NaN -> 0, 1 / (Σw + dc with NaN -> 0))."""
    return torch.isnan(c), torch.nan_to_num(c), 1.0 / (wsum + torch.nan_to_num(dc))


def _flow_sor(u, v, fu, fv, m, cu, cv, duc, dvc, weights, iters: int, omega: float):
    """Shared core: relaxes (fu, fv) with the 4 or 8 ``weights``; late
    linearisation when the frozen flow (u, v) is given, early (fu, fv are
    the flow) when it is None."""
    h, w = m.shape[-2:]
    mask0 = checkerboard(h, w, 0, device=m.device)
    mask1 = checkerboard(h, w, 1, device=m.device)
    nbr = _nbr_sum(weights)
    weights = _edge_zeroed8(*weights) if len(weights) == 8 else _edge_zeroed(*weights)
    wsum = _weight_sum(weights)
    cu_nan, cu0, inv_u = _fold_data_nan(cu, duc, wsum)
    cv_nan, cv0, inv_v = _fold_data_nan(cv, dvc, wsum)
    m0 = torch.nan_to_num(m)

    def diff_term(df, f):
        if f is None:
            return nbr(df, *weights)
        return nbr(df + f, *weights) - f * wsum

    def half(fu, fv, mask):
        su = diff_term(fu, u)
        sv = diff_term(fv, v)
        num_u = torch.where(cu_nan, su, su + cu0 - m0 * fv)
        new_u = torch.where(mask, (1.0 - omega) * fu + omega * num_u * inv_u, fu)
        num_v = torch.where(cv_nan, sv, sv + cv0 - m0 * new_u)
        new_v = torch.where(mask, (1.0 - omega) * fv + omega * num_v * inv_v, fv)
        return new_u, new_v

    for _ in range(iters):
        fu, fv = half(fu, fv, mask0)
        fu, fv = half(fu, fv, mask1)
    return fu, fv


def sor_flow_llin4(u, v, du, dv, m, cu, cv, duc, dvc, ww, wn, we, ws,
                   iters: int, omega: float):
    """Late-linearisation 4-neighbour flow SOR (cf. GS_SOR_llin4_2d):
    ``iters`` red-black sweeps for the increments (dU, dV) against the
    frozen (U, V). All arguments are (H, W) float32 tensors on one device;
    returns new (dU, dV)."""
    return _flow_sor(u, v, du, dv, m, cu, cv, duc, dvc, (ww, wn, we, ws), iters, omega)


def sor_flow_elin4(u, v, m, cu, cv, duc, dvc, ww, wn, we, ws, iters: int, omega: float):
    """Early-linearisation 4-neighbour flow SOR (cf. GS_SOR_elin4_2d):
    ``iters`` red-black sweeps for (U, V) themselves. (H, W) float32
    tensors on one device; returns new (U, V)."""
    return _flow_sor(None, None, u, v, m, cu, cv, duc, dvc, (ww, wn, we, ws), iters, omega)


def sor_flow_llin8(u, v, du, dv, m, cu, cv, duc, dvc,
                   ww, wnw, wn, wne, we, wse, ws, wsw, iters: int, omega: float):
    """Late-linearisation 8-neighbour (anisotropic tensor) flow SOR (cf.
    GS_SOR_llin8_2d): as ``sor_flow_llin4`` with the eight stencil
    weights W, NW, N, NE, E, SE, S, SW, which may be negative. Returns new
    (dU, dV)."""
    return _flow_sor(u, v, du, dv, m, cu, cv, duc, dvc,
                     (ww, wnw, wn, wne, we, wse, ws, wsw), iters, omega)


def _interior_color_masks(h: int, w: int, device=None):
    inter = interior_mask(h, w, device=device)
    return (checkerboard(h, w, 0, device=device) & inter,
            checkerboard(h, w, 1, device=device) & inter)


def sor_disp_llin4(u, du, cu, duc, ww, wn, we, ws, iters: int, omega: float):
    """Scalar late-linearisation disparity SOR (cf. disparitySolvers.c
    GS_SOR_llin4_2d): ``iters`` red-black sweeps for the increment dU
    against the frozen U, interior only, border replicated after each
    sweep. (..., H, W) float32 tensors on one device; returns new dU."""
    h, w = u.shape[-2:]
    mask0, mask1 = _interior_color_masks(h, w, device=u.device)
    wsum = ww + wn + we + ws
    cu_nan, cu0, inv = _fold_data_nan(cu, duc, wsum)

    def half(df, mask):
        s = _nbr_sum4(df + u, ww, wn, we, ws) - u * wsum
        num = torch.where(cu_nan, s, s + cu0)
        return torch.where(mask, (1.0 - omega) * df + omega * num * inv, df)

    for _ in range(iters):
        du = half(du, mask0)
        du = half(du, mask1)
        du = replicate_border(du)
    return du


def sor_disp_llin_sym4(u0, du0, cu0, duc0, ww0, wn0, we0, ws0,
                       u1, du1, cu1, duc1, ww1, wn1, we1, ws1,
                       iters: int, omega: float):
    """Coupled left/right disparity pair (cf. GS_SOR_llinsym4_2d). The two
    relaxations are independent within a solve (the coupling enters
    through Cu/Du), so they run as one batch of 2. Returns (dU0, dU1)."""
    pairs = ((u0, u1), (du0, du1), (cu0, cu1), (duc0, duc1),
             (ww0, ww1), (wn0, wn1), (we0, we1), (ws0, ws1))
    out = sor_disp_llin4(*(torch.stack(p) for p in pairs), iters, omega)
    return out[0], out[1]


def _pde_sor(x, trace, b, weights, iters: int, omega: float):
    h, w = x.shape[-2:]
    mask0, mask1 = _interior_color_masks(h, w, device=x.device)
    nbr = _nbr_sum(weights)
    wsum = _weight_sum(weights)
    tr_nan = torch.isnan(trace)
    inv = torch.where(tr_nan, 1.0 / wsum, 1.0 / torch.nan_to_num(trace, nan=1.0))
    b_eff = torch.where(tr_nan, 0.0, b)

    def half(xc, mask):
        new = (b_eff + nbr(xc, *weights)) * inv
        return torch.where(mask, (1.0 - omega) * xc + omega * new, xc)

    for _ in range(iters):
        x = half(x, mask0)
        x = half(x, mask1)
        x = replicate_border(x)
    return x


def sor_pde4(x, trace, b, ww, wn, we, ws, iters: int, omega: float):
    """Diagonal-form 4-neighbour SOR ``X+ = (B + Σ w X)/TRACE`` (cf.
    GS_SOR_4_2d), interior only, border replicated after each sweep.
    Leading channel dims broadcast: weights may be (H, W) and shared."""
    return _pde_sor(x, trace, b, (ww, wn, we, ws), iters, omega)


def sor_pde8(x, trace, b, ww, wnw, wn, wne, we, wse, ws, wsw, iters: int, omega: float):
    """Diagonal-form 8-neighbour SOR (cf. GS_SOR_8_2d): as ``sor_pde4``
    with the eight tensor-stencil weights W, NW, N, NE, E, SE, S, SW."""
    return _pde_sor(x, trace, b, (ww, wnw, wn, wne, we, wse, ws, wsw), iters, omega)
