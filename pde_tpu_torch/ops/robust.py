"""The robust data terms of one reweighting (the secondLoop body) of the
warping models, in plain PyTorch: the flows' (``models/flow_nd.py``,
``models/flow_ad.py``) and the disparity's (``models/disparity.py``).
``kernels/dispatch.py`` runs these for CPU tensors and inside
``plain_solvers()``, and ``csrc/reweight.cu`` for CUDA tensors.

A term is a dict of its derivative planes (C, H, W): a first-order term
``dt, dx, dy`` (the disparity's ``dt, dx``), the flows' gradient-magnitude
term ``dxt, dyt, dxx, dyy, dxy`` (the disparity's without ``dyy``). Each
call forms the term's products (``fst_products``, ``snd_products``,
``disp_products``) from them, as the kernels do.
"""

from __future__ import annotations

import torch


def fst_products(dt, dx, dy) -> dict:
    """The first-order term's tensors (M, Cu, Cv, Du, Dv)."""
    return dict(m=dy * dx, cu=dt * dx, cv=dt * dy, du=dx * dx, dv=dy * dy)


def snd_products(dxt, dyt, dxx, dyy, dxy) -> dict:
    """The gradient-magnitude term's tensors (M, Cu, Cv, Du, Dv)."""
    return dict(
        m=dxy * (dxx + dyy),
        cu=dxt * dxx + dyt * dxy,
        cv=dxt * dxy + dyt * dyy,
        du=dxx * dxx + dxy * dxy,
        dv=dxy * dxy + dyy * dyy,
    )


def disp_products(term: dict) -> dict:
    """The disparity term's u-components (Cu, Du)."""
    if "dxt" in term:
        return dict(cu=term["dxt"] * term["dxx"] + term["dyt"] * term["dxy"],
                    du=term["dxx"] * term["dxx"] + term["dxy"] * term["dxy"])
    return dict(cu=term["dt"] * term["dx"], du=term["dx"] * term["dx"])


def _flow_products(term: dict) -> dict:
    if "dxt" in term:
        return snd_products(*(term[k] for k in ("dxt", "dyt", "dxx", "dyy", "dxy")))
    return fst_products(term["dt"], term["dx"], term["dy"])


def robust_terms_flow(t1, t2, u, v, du, dv, us_ap, vs_ap, as_diff, p, snd_is_gradmag: bool):
    """The channel-summed (M, Cu, Cv, Du, Dv) of one reweighting of the
    warping flows (flow_nd, flow_ad): each constancy term's tensors under
    its robust weight gD = b/(alpha*sqrt(residual^2 + 1e-5)) at the current
    increments, plus the spatial priors' terms. t2, us_ap and vs_ap may be
    None."""
    op1 = (t1["dt"] - t1["dx"] * du - t1["dy"] * dv) ** 2
    gd1 = p.b1 / (p.alpha * torch.sqrt(op1 + 1e-5))
    k1 = _flow_products(t1)
    parts_m = [k1["m"] * gd1]
    parts_cu = [k1["cu"] * gd1]
    parts_cv = [k1["cv"] * gd1]
    parts_du = [k1["du"] * gd1]
    parts_dv = [k1["dv"] * gd1]
    if t2 is not None:
        if snd_is_gradmag:
            op2 = (t2["dxt"] - t2["dxx"] * du - t2["dxy"] * dv) ** 2 + (
                t2["dyt"] - t2["dxy"] * du - t2["dyy"] * dv
            ) ** 2
        else:
            op2 = (t2["dt"] - t2["dx"] * du - t2["dy"] * dv) ** 2
        gd2 = p.b2 / (p.alpha * torch.sqrt(op2 + 1e-5))
        k2 = _flow_products(t2)
        parts_m.append(k2["m"] * gd2)
        parts_cu.append(k2["cu"] * gd2)
        parts_cv.append(k2["cv"] * gd2)
        parts_du.append(k2["du"] * gd2)
        parts_dv.append(k2["dv"] * gd2)
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


def robust_terms_disp(d1, d2, u, du, us_ap, as_diff, p, snd_is_gradmag: bool):
    """(Cu, Du) of one reweighting of the disparity: the warping flow's
    robust terms restricted to the u-components, channels combined with a
    plain ``sum`` so NaN (out-of-domain) pixels stay NaN (reference
    :289-293), and the prior gS = gamma/alpha * exp(-APnorm/ASdiff^2). d2
    and us_ap may be None."""
    op1 = (d1["dt"] - d1["dx"] * du) ** 2
    gd1 = p.b1 / (p.alpha * torch.sqrt(op1 + 1e-5))
    k1 = disp_products(d1)
    cu_parts = [k1["cu"] * gd1]
    du_parts = [k1["du"] * gd1]
    if d2 is not None:
        if snd_is_gradmag:
            op2 = (d2["dxt"] - d2["dxx"] * du) ** 2 + (d2["dyt"] - d2["dxy"] * du) ** 2
        else:
            op2 = (d2["dt"] - d2["dx"] * du) ** 2
        gd2 = p.b2 / (p.alpha * torch.sqrt(op2 + 1e-5))
        k2 = disp_products(d2)
        cu_parts.append(k2["cu"] * gd2)
        du_parts.append(k2["du"] * gd2)
    if us_ap is not None:
        ap_norm = (us_ap - u - du) ** 2
        gs = (p.gammaS / p.alpha) * torch.exp(-ap_norm / as_diff**2)
        cu_parts.append(((us_ap - u) * gs)[None])
        du_parts.append(gs[None])

    cu_gd = sum(torch.sum(x, dim=0) for x in cu_parts)
    du_gd = sum(torch.sum(x, dim=0) for x in du_parts)
    return cu_gd, du_gd
