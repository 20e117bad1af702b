"""Red-black SOR for the late-linearised coupled flow pair: the plain
PyTorch version of the CUDA kernel ``csrc/flow_llin4_sor.cu``.

Written from ``_flow_sor`` (``pde_tpu/solvers/sor.py``, late=True). It is
the path for CPU tensors and the kernel's reference on the card.

* Border-solving convention: the out-facing weights are zeroed and every
  pixel, border included, is relaxed with its one-sided stencil.
* NaN in Cu/Cv drops the data term; NaN in Du/Dv drops it from the
  divisor.
* Within each colour, u updates first and v then uses the refreshed u.
* Diffusion term ``Σ w_k (dU_k + U_k − U_c)``, summed W, E, N, S.
"""

from __future__ import annotations

import torch

from pde_tpu_torch.core.grid import shift_w, shift_e, shift_n, shift_s, checkerboard


def _edge_zeroed(ww, wn, we, ws):
    ww, wn, we, ws = (x.clone() for x in (ww, wn, we, ws))
    ww[..., :, 0] = 0.0
    wn[..., 0, :] = 0.0
    we[..., :, -1] = 0.0
    ws[..., -1, :] = 0.0
    return ww, wn, we, ws


def _nbr_sum4(x, ww, wn, we, ws):
    return shift_w(x) * ww + shift_e(x) * we + shift_n(x) * wn + shift_s(x) * ws


def _fold_data_nan(c, dc, wsum):
    """(NaN flag of c, c with NaN -> 0, 1 / (Σw + dc with NaN -> 0))."""
    return torch.isnan(c), torch.nan_to_num(c), 1.0 / (wsum + torch.nan_to_num(dc))


def sor_flow_llin4(u, v, du, dv, m, cu, cv, duc, dvc, ww, wn, we, ws,
                   iters: int, omega: float):
    """Late-linearisation 4-neighbour flow SOR (cf. GS_SOR_llin4_2d):
    ``iters`` red-black sweeps for the increments (dU, dV) against the
    frozen (U, V). All arguments are (H, W) float32 tensors on one device;
    returns new (dU, dV)."""
    h, w = m.shape[-2:]
    mask0 = checkerboard(h, w, 0, device=m.device)
    mask1 = checkerboard(h, w, 1, device=m.device)
    weights = _edge_zeroed(ww, wn, we, ws)
    wsum = weights[0] + weights[1] + weights[2] + weights[3]
    cu_nan, cu0, inv_u = _fold_data_nan(cu, duc, wsum)
    cv_nan, cv0, inv_v = _fold_data_nan(cv, dvc, wsum)
    m0 = torch.nan_to_num(m)

    def half(fu, fv, mask):
        su = _nbr_sum4(fu + u, *weights) - u * wsum
        sv = _nbr_sum4(fv + v, *weights) - v * wsum
        num_u = torch.where(cu_nan, su, su + cu0 - m0 * fv)
        new_u = torch.where(mask, (1.0 - omega) * fu + omega * num_u * inv_u, fu)
        num_v = torch.where(cv_nan, sv, sv + cv0 - m0 * new_u)
        new_v = torch.where(mask, (1.0 - omega) * fv + omega * num_v * inv_v, fv)
        return new_u, new_v

    for _ in range(iters):
        du, dv = half(du, dv, mask0)
        du, dv = half(du, dv, mask1)
    return du, dv
