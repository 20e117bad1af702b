"""Plain PyTorch reference of ``disparity_nd`` (Ralli's DispEminND_llin_2D.m:
the scalar horizontal field of a rectified pair), frame for frame: the
pyramid down to the configuration's ``pyramid_stop``, and at each level
from the coarsest ``firstLoop`` horizontal warps, each with ``secondLoop``
reweightings around an ``iter``-sweep SOR solve of the interior (the
border replicated), the 3x3 median, then the field upscaled.

Only the options the benchmark's configurations use are here: the SOR
solver (``solver`` 1) and the exact gather warp (``warp_window`` 0). It
imports nothing of the program under test.
"""

from __future__ import annotations

import torch

from bench_gpu.reference.plain import (Resizer, check_options, diffusion_weights,
                                       fst_derivatives, images, matmul_precision, medfilt3,
                                       robust, snd_derivatives, sor_disp, warp)


def fields(il, ir, config: dict, device="cpu", precision="float32") -> tuple:
    """(U,): float32 (H, W), the horizontal shift that takes the uint8-range
    (C, H, W) ``ir`` onto ``il`` under ``config`` (its ``params``,
    ``terms`` and ``pyramid_stop``)."""
    p = dict(config["params"])
    check_options(p, solver=1, warp_window=0)
    fst_term, snd_term = config["terms"]["fst_term"], config["terms"]["snd_term"]
    stop = int(config["pyramid_stop"])
    gm = snd_term == "gradmag"
    resize = Resizer(device, precision)
    with matmul_precision(precision), torch.no_grad():
        levels = images(il, ir, device, fst_term, snd_term, p["scl_factor"], stop, resize,
                        p["scales"])
        u = None
        for lvl in range(len(levels) - 1, -1, -1):
            i1t0, i1t1, i2t0, i2t1 = levels[lvl]
            if u is None:
                u = torch.zeros(i1t0.shape[-2:], device=device)
            zero = torch.zeros_like(u)
            for _first in range(p["firstLoop"]):
                dt, dx, _ = fst_derivatives(i1t0, warp(i1t1, u, zero))
                cu1, du1 = dt * dx, dx * dx
                if i2t1 is not None:
                    i2w = warp(i2t1, u, zero)
                    if gm:
                        dxt, dyt, dxx, _, dxy = snd_derivatives(i2t0, i2w)
                        cu2, du2 = dxt * dxx + dyt * dxy, dxx * dxx + dxy * dxy
                    else:
                        dt2, dx2, _ = fst_derivatives(i2t0, i2w)
                        cu2, du2 = dt2 * dx2, dx2 * dx2
                df = torch.zeros_like(u)
                for _second in range(p["secondLoop"]):
                    gd1 = robust(p["b1"], p["alpha"], (dt - dx * df) ** 2)
                    cu_parts, du_parts = [cu1 * gd1], [du1 * gd1]
                    if i2t1 is not None:
                        if gm:
                            op2 = (dxt - dxx * df) ** 2 + (dyt - dxy * df) ** 2
                        else:
                            op2 = (dt2 - dx2 * df) ** 2
                        gd2 = robust(p["b2"], p["alpha"], op2)
                        cu_parts.append(cu2 * gd2)
                        du_parts.append(du2 * gd2)
                    # a plain sum: a NaN (out of the image) stays NaN
                    cu = sum(torch.sum(x, dim=0) for x in cu_parts)
                    duc = sum(torch.sum(x, dim=0) for x in du_parts)
                    ww, wn, we, ws = diffusion_weights(u + df, "max", True)
                    df = sor_disp(u, df, cu, duc, ww, wn, we, ws, p["iter"], p["omega"])
                u = medfilt3(u + df)
            if lvl > 0:
                u = resize(u / p["scl_factor"], levels[lvl - 1][0].shape[-2:])
    return (u,)
