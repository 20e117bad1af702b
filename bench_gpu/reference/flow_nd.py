"""Plain PyTorch reference of ``flow_nd`` (Ralli's FlowEminND_llin_2D_v10.m:
isotropic nonlinear diffusion, late linearisation, red-black SOR), frame
for frame: the pyramid down to the configuration's ``pyramid_stop``, and
at each level from the coarsest ``firstLoop`` warps, each with
``secondLoop`` reweightings of the robust data terms and the diffusion
weights around an ``iter``-sweep SOR solve, the 3x3 median, then the
field upscaled to the next level.

Only the options the benchmark's configurations use are here: the SOR
solver (``solver`` 1) and the exact gather warp (``warp_window`` 0). It
imports nothing of the program under test.
"""

from __future__ import annotations

import torch

from bench_gpu.reference.plain import (Resizer, check_options, diffusion_weights,
                                       fst_derivatives, images, matmul_precision, medfilt3,
                                       robust, snd_derivatives, sor_flow, warp)


def fields(it0, it1, config: dict, device="cpu", precision="float32") -> tuple:
    """(U, V) float32 (H, W) of the uint8-range (C, H, W) pair ``it0``,
    ``it1`` under ``config`` (its ``params``, ``terms`` and
    ``pyramid_stop``)."""
    p = dict(config["params"])
    check_options(p, solver=1, warp_window=0)
    fst_term, snd_term = config["terms"]["fst_term"], config["terms"]["snd_term"]
    stop = int(config["pyramid_stop"])
    gm = snd_term == "gradmag"
    resize = Resizer(device, precision)
    with matmul_precision(precision), torch.no_grad():
        levels = images(it0, it1, device, fst_term, snd_term, p["scl_factor"], stop, resize,
                        p["scales"])
        u = v = None
        for lvl in range(len(levels) - 1, -1, -1):
            i1t0, i1t1, i2t0, i2t1 = levels[lvl]
            if u is None:
                u = torch.zeros(i1t0.shape[-2:], device=device)
                v = torch.zeros_like(u)
            for _first in range(p["firstLoop"]):
                dt, dx, dy = fst_derivatives(i1t0, warp(i1t1, u, v))
                t1 = (dy * dx, dt * dx, dt * dy, dx * dx, dy * dy)
                if i2t1 is not None:
                    i2w = warp(i2t1, u, v)
                    if gm:
                        dxt, dyt, dxx, dyy, dxy = snd_derivatives(i2t0, i2w)
                        t2 = (dxy * (dxx + dyy), dxt * dxx + dyt * dxy, dxt * dxy + dyt * dyy,
                              dxx * dxx + dxy * dxy, dxy * dxy + dyy * dyy)
                    else:
                        dt2, dx2, dy2 = fst_derivatives(i2t0, i2w)
                        t2 = (dy2 * dx2, dt2 * dx2, dt2 * dy2, dx2 * dx2, dy2 * dy2)
                du = torch.zeros_like(u)
                dv = torch.zeros_like(v)
                for _second in range(p["secondLoop"]):
                    gd1 = robust(p["b1"], p["alpha"], (dt - dx * du - dy * dv) ** 2)
                    terms = [[x * gd1 for x in t1]]
                    if i2t1 is not None:
                        if gm:
                            op2 = ((dxt - dxx * du - dxy * dv) ** 2
                                   + (dyt - dxy * du - dyy * dv) ** 2)
                        else:
                            op2 = (dt2 - dx2 * du - dy2 * dv) ** 2
                        gd2 = robust(p["b2"], p["alpha"], op2)
                        terms.append([x * gd2 for x in t2])
                    m, cu, cv, duc, dvc = (sum(torch.nansum(t[k], dim=0) for t in terms)
                                           for k in range(5))
                    ww, wn, we, ws = diffusion_weights(torch.stack([u + du, v + dv]), "sum",
                                                       False)
                    du, dv = sor_flow(u, v, du, dv, m, cu, cv, duc, dvc, ww, wn, we, ws,
                                      p["iter"], p["omega"])
                u = medfilt3(u + du)
                v = medfilt3(v + dv)
            if lvl > 0:
                size = levels[lvl - 1][0].shape[-2:]
                u = resize(u / p["scl_factor"], size)
                v = resize(v / p["scl_factor"], size)
    return u, v
