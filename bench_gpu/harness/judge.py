"""The comparison that decides ``correct``.

The fields that the timed path returned are held against the plain
reference (``bench_gpu/reference``) run on the same uint8 inputs. Each
number compared is a statistic of the absolute gap |program - reference|
over every pixel of every component of the field (U and V, or U), worst
over the frames judged; each has its limit in the configuration's
``checks``. A field of another shape, or a NaN or infinity in either side,
reads as an infinite gap.
"""

from __future__ import annotations

import math
import sys

import torch

STATISTICS = {
    "gap_mean_px": lambda d: float(d.mean()),
    "gap_p99_px": lambda d: float(torch.quantile(d[:: max(1, d.numel() // 2**24)], 0.99)),
    "gap_max_px": lambda d: float(d.max()),
}


def gaps(program, reference, names) -> dict:
    """The statistics ``names`` of |program - reference| over all fields."""
    if len(program) != len(reference) or any(p.shape != r.shape
                                             for p, r in zip(program, reference)):
        return {n: math.inf for n in names}
    p = torch.cat([x.detach().reshape(-1).to(torch.float64) for x in program])
    r = torch.cat([x.detach().reshape(-1).to(torch.float64).to(p.device) for x in reference])
    if not (torch.isfinite(p).all() and torch.isfinite(r).all()):
        return {n: math.inf for n in names}
    d = (p - r).abs()
    return {n: STATISTICS[n](d) for n in names}


def worst(readings, names) -> dict:
    """The largest of each statistic over ``readings`` (dicts)."""
    return {n: max((r[n] for r in readings), default=math.inf) for n in names}


def verdict(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): correct when every number is
    at most its limit. An infinite gap is reported as the largest float,
    so that the result stays plain JSON."""
    checks = {n: {"value": min(numbers[n], sys.float_info.max), "limit": limits[n]}
              for n in limits}
    return all(numbers[n] <= limits[n] for n in limits), checks


def epe(field, truth) -> float:
    """Mean end-point error (px) of ``field`` against the known ``truth``,
    over pixels 16 px or more inside the image."""
    comps = [(f.detach().double().cpu() - torch.as_tensor(t, dtype=torch.float64)) ** 2
             for f, t in zip(field, truth)]
    e = torch.sqrt(sum(comps))
    return float(e[16:-16, 16:-16].mean()) if min(e.shape) > 40 else float(e.mean())
