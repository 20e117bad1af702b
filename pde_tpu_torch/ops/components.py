"""Connected components by min-label propagation, ported from
``pde_tpu/ops/components.py``.

The reference uses MATLAB ``bwlabel``/``regionprops`` for one purpose:
keeping only the biggest connected component of a level set
(DispSegmentation.m:282-298). Every masked pixel starts with its linear
index, and labels propagate by rounds of 8-neighbour minima followed by
running minima along rows and columns that restart where the mask breaks,
so one round carries a label across the whole image along each axis. The
rounds repeat until nothing changes; each round's check is one host sync.

The labels are exact integers (int64 here), so any order of propagation
ends at the same fixed point: 1 + the smallest linear index of each
component, as ``pde_tpu`` gives.
"""

from __future__ import annotations

import torch

from pde_tpu_torch.core.grid import shift_e, shift_n, shift_s, shift_w


def _segmented_cummin(vals, mask, dim: int, big: int):
    """Running minimum of ``vals`` along ``dim`` that restarts after every
    pixel off the mask. Each run of the mask gets an id (the count of breaks
    before it); subtracting ``id * big`` puts every later run below all
    earlier ones, so a plain ``cummin`` never reaches back across a break."""
    seg = torch.cumsum((~mask).to(torch.int64), dim=dim)
    return torch.cummin(vals - seg * big, dim=dim).values + seg * big


def _masked_min(lab, mask, inf: int):
    """One 8-neighbour minimum and a forward and backward running minimum
    along each axis, off-mask pixels held at ``inf``."""
    x = torch.where(mask, lab, inf)
    cand = torch.minimum(torch.minimum(shift_w(x), shift_e(x)),
                         torch.minimum(shift_n(x), shift_s(x)))
    diag = torch.minimum(torch.minimum(shift_n(shift_w(x)), shift_n(shift_e(x))),
                         torch.minimum(shift_s(shift_w(x)), shift_s(shift_e(x))))
    x = torch.where(mask, torch.minimum(x, torch.minimum(cand, diag)), inf)
    big = inf + 1
    for dim in (-2, -1):
        x = torch.where(mask, _segmented_cummin(x, mask, dim, big), inf)
        rev = _segmented_cummin(x.flip(dim), mask.flip(dim), dim, big).flip(dim)
        x = torch.where(mask, rev, inf)
    return x


def label_components(mask: torch.Tensor) -> torch.Tensor:
    """8-connected component labels of a boolean (H, W) mask.

    Returns int32 (H, W): 0 outside the mask, otherwise 1 + the smallest
    linear index in the component.
    """
    h, w = mask.shape
    inf = h * w
    lab = torch.arange(h * w, dtype=torch.int64, device=mask.device).reshape(h, w)
    while True:
        new = _masked_min(lab, mask, inf)
        if torch.equal(new, lab):  # the round's host sync
            break
        lab = new
    return torch.where(mask, lab + 1, 0).to(torch.int32)


def biggest_component_mask(mask: torch.Tensor) -> torch.Tensor:
    """Boolean mask of the largest 8-connected component of ``mask``; the
    first (smallest label) wins a tie. As in ``pde_tpu``, the background's
    size is set to 0, so an empty mask gives label 0 everywhere and the
    whole field comes back True.

    Mirrors the reference's sanity pass (DispSegmentation.m:282-290).
    """
    h, w = mask.shape
    lab = label_components(mask)
    # a scatter-add rather than bincount, whose output length costs a sync
    sizes = torch.zeros(h * w + 1, dtype=torch.int64, device=mask.device)
    sizes.scatter_add_(0, lab.reshape(-1).to(torch.int64), mask.reshape(-1).to(torch.int64))
    sizes[:1] = 0  # the background never counts (a fill: no host copy)
    return lab == torch.argmax(sizes)
