"""Level-set disparity segmentation, ported from ``pde_tpu/models/segmentation.py``:
Chan-Vese active regions and RANSAC polynomial surfaces (dense:
DispSegmentation.m; sparse: NaN-holed maps, DispSegmentationSparse.m).

Pipeline (dense, DispSegmentation.m:96-145):

1. ``generateSeeds``: grow one seed at a time over a "there and back"
   pyramid (fine -> coarse -> fine, :66-91). Each stage and iteration
   RANSAC-fits a plane or quadric to the current segment
   (``ops.ransac.ransac_surface``), turns the squared surface distance into
   a Gaussian log-likelihood-ratio DATA term (:365-374) and takes one
   semi-implicit Chan-Vese AOS step (``solvers.aos.cv_aos_step``: two
   line-set solves, on the card two ``tridiag_thomas`` launches). A
   mid-pyramid sanity pass keeps only the biggest connected component
   (:282-298, ``ops.components``). Seeds that collapse (< 20 px) shrink
   gamma by 0.8 and are skipped (:330-335, :402-405).
2. ``regionCompetition``: all segments compete. Each segment's RANSAC refit
   and likelihood are recomputed every 2nd iteration (:531), a competition
   DATA term by strategy ('surface', 'greedy', 'inverse', :590-618), one CV
   AOS step on the whole segment stack, and small segments are removed
   (:505-529) through an alive mask.
3. Orchestration: seeds -> competition('inverse') -> more seeds in the
   uncovered area -> competition again (:99-143); a warm-start ``phi``
   re-segments instead (:147-180).

``pde_tpu`` folds each pyramid stage into one jitted program
(``fori_loop``, ``cond``); here the same loops run eagerly, with the same
iteration counts, gates and order of operations. Host syncs: one a seed
(was it recorded?), one a competition phase (which segments live), one a
round of the connected-components propagation, and those
``torch.linalg.svd`` makes (its error check) in each RANSAC fit.

Randomness comes from a draw source that the pipeline calls at the points
where ``pde_tpu`` splits its ``jax.random`` key, in the same order:
``split()`` once a seed iteration (once more for the peeled first one) and
once a competition iteration, ``split(n)`` once a recompute (one stream a
segment) and ``categorical(mask, iters, ns)`` in each RANSAC fit.
:class:`TorchDraws`, the default, serves them all from one
``torch.Generator`` on the input's device seeded from ``rng_seed``. Another
source with the same three methods (and ``state``/``set_state`` for the
checkpoint) may be passed as the private ``_draws=``; the tests pass one
backed by ``jax.random``, so that the port draws ``pde_tpu``'s samples.

Sparse deltas (DispSegmentationSparse.m): 5x5 NaN-median prefilter at every
pyramid level (:63,76), NaN -> 1000 sentinel before fitting (:284,500),
variance over inlier distances < 100 only (:418-420, :598-600), polyorder 2,
scl_factor 0.75, gen/rc_scl 0.55, seed gamma 0.005 (:226) and competition
gamma 0.005*(rows*cols)^0.7 (:495).

As in ``pde_tpu``, the small-segment filter at the end of the reference's
generateSeeds (:636-645 dense) inspects the working level set, not the
accumulated stack, so it never removes anything; that is reproduced.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import warnings

import numpy as np
import torch

from pde_tpu_torch.config import with_overrides
from pde_tpu_torch.core.conv import imfilter_replicate
from pde_tpu_torch.core.median import nanmedfilt2
from pde_tpu_torch.core.resize import imresize, imresize_nan
from pde_tpu_torch.models._device import as_tensor, input_device
from pde_tpu_torch.ops.components import biggest_component_mask
from pde_tpu_torch.ops.ransac import ransac_surface
from pde_tpu_torch.solvers.aos import cv_aos_step
from pde_tpu_torch.utils.checkpoint import load_state, save_state

_EPS = float(np.finfo(np.float64).eps)
_CDX = np.array([-0.5, 0.0, 0.5], dtype=np.float32)  # O_dx = [-1 0 1]*0.5


@dataclasses.dataclass(frozen=True)
class DispSegParams:
    """Dense defaults: DispSegmentation.m:40-53; sparse: Sparse.m:42-55 (as
    ``pde_tpu``'s)."""

    tau: float = 1.0
    srem_thr: float = 0.002
    polyorder: int = 1
    seeds: int = 15
    scl_factor: float = 0.7
    gen_scl: float = 0.2
    rc_scl: float = 0.4
    ransac_min_cset: float = 0.1
    ransac_max_cset: float = 0.7
    ransac_cset_cycles: int = 10
    varLim: float = 0.7  # the sparse variant exposes this (Sparse.m:46)
    rng_seed: int = 0
    # loop counts of the hard-wired orchestration calls
    # (DispSegmentation.m:103-143); exposed so tests can shrink them
    seed_iterations: int = 20
    rc_iterations: int = 30
    rc_iterations2: int = 20
    ransac_first: int = 2000
    ransac_rest: int = 100


def sparse_defaults() -> DispSegParams:
    return DispSegParams(polyorder=2, scl_factor=0.75, gen_scl=0.55, rc_scl=0.55)


class TorchDraws:
    """The pipeline's draw source: one ``torch.Generator`` on ``device``.

    ``split`` hands back the same generator, so every draw advances one
    stream; ``categorical`` draws uniformly with replacement over the mask's
    pixels (``pde_tpu``'s ``categorical`` over logits 0 on the mask, -inf off
    it). A mask with no pixel (a dead seed's, whose fit the alive gate
    throws away) draws over every pixel, since ``multinomial`` refuses an
    all-zero row."""

    def __init__(self, seed: int, device):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)

    def split(self, n: int | None = None):
        return self

    def categorical(self, mask: torch.Tensor, iters: int, ns: int) -> torch.Tensor:
        """(..., iters, ns) linear pixel indices, one stream of draws a row of
        the leading dimensions of ``mask`` (..., H, W)."""
        lead = mask.shape[:-2]
        m = mask.reshape(-1, mask.shape[-2] * mask.shape[-1])
        weights = m.to(torch.float32) + (~m.any(dim=-1, keepdim=True)).to(torch.float32)
        idx = torch.multinomial(weights, iters * ns, replacement=True, generator=self.gen)
        return idx.reshape(*lead, iters, ns)

    def state(self) -> np.ndarray:
        return self.gen.get_state().numpy()

    def set_state(self, state) -> None:
        self.gen.set_state(torch.as_tensor(np.asarray(state, dtype=np.uint8)))


def _grad_mag(phi):
    """|grad PHI| by the [-0.5 0 0.5] correlation with replicate borders."""
    dx = imfilter_replicate(phi, _CDX[None, :])
    dy = imfilter_replicate(phi, _CDX[:, None])
    return torch.sqrt(dx * dx + dy * dy)


def _delta_heaviside(phi, floor=None):
    dh = 1.0 / (np.pi * (1.0 + phi * phi))
    if floor is not None:
        dh = torch.clamp(dh, min=floor)
    return dh


def _likelihood(dist, cov):
    """(norm, p): the peak of the Gaussian of variance ``cov`` and its value at
    each squared surface distance ``dist`` (DispSegmentation.m:365-374)."""
    norm = 1.0 / torch.sqrt(2.0 * np.pi * cov)
    return norm, norm * torch.exp(-dist / (2.0 * cov))


def _log_ratio(p, q):
    """The DATA term log((p + eps) / (q + eps)) (:365-374, :590-618)."""
    return torch.log((p + _EPS) / (q + _EPS))


def _n_coef(order: int) -> int:
    return 3 if order == 1 else 6


def _feature_shape(h: int, w: int, order: int) -> torch.Tensor:
    """``ransac_surface``'s features argument: it reads only the (H, W, k)
    shape, so a tensor without storage stands in for ``surface_features``."""
    return torch.empty((h, w, _n_coef(order)), device="meta")


# ---------------------------------------------------------------------------
# generateSeeds (DispSegmentation.m:203-443)
# ---------------------------------------------------------------------------


def _seed_iter(draws, phi, d, d_fit, include, h1eq, min_cov, gamma_scl, rcons, tau,
               riter: int, order: int, inlier_lt_100: bool):
    """One seed-growth iteration: RANSAC fit, likelihood DATA and CV step.

    The reference aborts a seed when its support drops under 20 px
    (SIG_emptysegment, DispSegmentation.m:332-335); here, as in ``pde_tpu``,
    that check is an ``alive`` gate on the card: a dead seed's state passes
    through unchanged, and the host reads the flag once a seed."""
    h, w = d.shape
    feats = _feature_shape(h, w, order)
    h1 = phi >= 0.0
    h1sum = h1.sum()
    alive = h1sum >= 20
    model, dist_d = ransac_surface(draws, d_fit, h1, feats, 0.7, rcons, riter, model_in=h1eq)
    if inlier_lt_100:
        inl = h1 & (dist_d < 100.0)
        cov = torch.where(inl, dist_d, 0.0).sum() / torch.clamp(inl.sum(), min=1)
    else:
        cov = torch.where(h1, dist_d, 0.0).sum() / torch.clamp(h1sum, min=1)
    cov_raw = cov  # the mid-pyramid minCOV reset (:408-412) reads the unfloored value
    cov = torch.maximum(cov, min_cov)
    norm, p1 = _likelihood(dist_d, cov)
    p0 = norm - p1
    data = _log_ratio(p1, p0)
    data = torch.where(include, data, -2.0)
    dh = _delta_heaviside(phi)
    grad = _grad_mag(phi)
    # pde_tpu's argument order: delta-H in the "grad" slot, |grad phi| in "diff"
    phi_new = cv_aos_step(phi, data, dh, grad, tau, gamma_scl)
    phi = torch.where(alive, phi_new, phi)
    model = torch.where(alive, model, h1eq)
    return phi, model, cov_raw, alive


def _aa_chain(aa0, shapes):
    """Pyramid of a mask or stack by successive bicubic downscales (the
    reference's per-level imresize loop, :66-91)."""
    out = [aa0]
    for s in shapes:
        out.append(imresize(out[-1], s, "bicubic"))
    return out


def _seed_stage(draws, phi, d, d_fit, include, h1eq, min_cov, dead, gamma_scl, rcons_vec,
                tau, riter0: int, riter: int, n_iters: int, order: int,
                inlier_lt_100: bool, peel: bool, mask_init: bool, bigcomp: bool,
                adjust_cov: bool, next_shape):
    """One pyramid stage of seed growth (DispSegmentation.m:300-394), with the
    steps ``pde_tpu`` folds into its stage program under the same flags: the
    coarsest stage's seed-mask init (:238-244, ``mask_init``), the
    mid-pyramid biggest-connected-component pass (:282-298, ``bigcomp``),
    the mid-pyramid minimum-variance re-estimate (:408-412 dense,
    Sparse.m:418-425, ``adjust_cov``; ``min_cov`` a scalar on the card), the
    SIG_emptysegment support check (:332-335, the ``dead`` flag) and the
    bicubic upscale to the next stage (``next_shape``). ``peel`` runs
    iteration 0 with the larger first hypothesis count (RITER 2000 -> 100,
    :308-312); ``rcons_vec`` is the consensus-fraction ramp (:313-323).

    Returns (phi, h1eq, min_cov, dead); ``draws`` advances."""
    if mask_init:
        phi = torch.where(include, phi, -1.0)
    if bigcomp:
        big = biggest_component_mask(phi > 0)
        phi = torch.where(big, 5.0, -5.0)

    last_cov = torch.zeros((), dtype=torch.float32, device=phi.device)
    it0 = 0
    if peel:
        phi, h1eq, last_cov, _ = _seed_iter(
            draws.split(), phi, d, d_fit, include, h1eq, min_cov, gamma_scl, rcons_vec[0],
            tau, riter=riter0, order=order, inlier_lt_100=inlier_lt_100)
        it0 = 1
    for i in range(it0, n_iters):
        phi, h1eq, last_cov, _ = _seed_iter(
            draws.split(), phi, d, d_fit, include, h1eq, min_cov, gamma_scl, rcons_vec[i],
            tau, riter=riter, order=order, inlier_lt_100=inlier_lt_100)

    dead = dead | ((phi >= 0.0).sum() < 20)
    if adjust_cov:
        take = (last_cov > 0.5) if inlier_lt_100 else torch.ones_like(dead)
        min_cov = torch.where(take & ~dead, last_cov, min_cov)
    if next_shape is not None:
        phi = imresize(phi, next_shape, "bicubic")
    return phi, h1eq, min_cov, dead


def _generate_seeds(d_levels, d_fit_levels, pyramid, order, sigma_lim, cset_vect, iterations,
                    aa0, seeds, gamma0, tau, draws, ransac_first, ransac_rest, inlier_lt_100):
    """Returns (list of (H, W) phi fields, list of (k,) models)."""
    n_levels = max(pyramid)  # pyramid entries are 1-based level indices
    shapes = [tuple(d_levels[i].shape) for i in range(n_levels)]
    h0, w0 = shapes[0]
    dev = d_levels[0].device

    phi_init = -torch.ones((h0, w0), dtype=torch.float32, device=dev)
    phi_init[1:h0 - 1:5, 1:w0 - 1:5] = 1.0  # PHIinitial(2:5:end-1) (:238-239)

    aa = [as_tensor(aa0, dev)]
    phi_out, models_out = [], []
    gamma = gamma0
    sig_empty = False
    mid = round(len(pyramid) / 2) - 1
    aa_shapes = shapes[1:n_levels]

    for _seed in range(seeds):
        if not sig_empty:
            aa = _aa_chain(aa[0], aa_shapes)
        sig_empty = False
        min_cov = torch.full((), sigma_lim, dtype=torch.float32, device=dev)
        dead = torch.zeros((), dtype=torch.bool, device=dev)
        phi = phi_init
        h1eq = torch.zeros((_n_coef(order),), dtype=torch.float32, device=dev)

        for cscl in range(len(pyramid) - 1):
            scl = pyramid[cscl] - 1  # to 0-based
            h, w = shapes[scl]
            gamma_scl = gamma * float((h * w) ** 0.7)
            include = aa[scl] > 0.05
            if cscl == 0:
                rcons_vec = [cset_vect[min(it, len(cset_vect) - 1)] for it in range(iterations)]
            else:
                rcons_vec = [cset_vect[-1]] * iterations
            nxt = pyramid[cscl + 1]
            phi, h1eq, min_cov, dead = _seed_stage(
                draws, phi, d_levels[scl], d_fit_levels[scl], include, h1eq, min_cov, dead,
                gamma_scl, rcons_vec, tau,
                riter0=(ransac_first if cscl == 0 else ransac_rest), riter=ransac_rest,
                n_iters=iterations, order=order, inlier_lt_100=inlier_lt_100,
                peel=(cscl == 0), mask_init=(cscl == 0), bigcomp=(cscl == mid),
                adjust_cov=(cscl == mid),
                next_shape=(shapes[nxt - 1] if nxt != -1 else None))

        sig_empty = bool(dead)  # the seed's one device -> host sync
        if sig_empty:
            gamma = gamma * 0.8
        else:
            phi_out.append(phi)
            models_out.append(h1eq)
            aa[0] = ((phi < 0) & (aa[0] > 0)).to(torch.float32)

    return phi_out, models_out


# ---------------------------------------------------------------------------
# regionCompetition (DispSegmentation.m:448-654)
# ---------------------------------------------------------------------------


def _others_max(q):
    """For each segment s, the maximum over t != s of q[t]; an empty set gives 0
    (MATLAB's max over an empty 3rd dim leaves the zero-initialised WC). The
    leave-one-out maximum is the global one unless s is the argmax (the first
    on a tie), and then the runner-up."""
    s = q.shape[0]
    top1 = torch.amax(q, dim=0)
    arg1 = torch.argmax(q, dim=0)
    is_arg = torch.arange(s, device=q.device)[:, None, None] == arg1[None]
    top2 = torch.amax(torch.where(is_arg, -torch.inf, q), dim=0)
    out = torch.where(is_arg, top2[None], top1[None])
    return torch.where(torch.isfinite(out), out, 0.0)


def _rc_recompute(draws, phi, d, d_fit, surface, min_cov, cset, alive, order: int,
                  strategy: str, inlier_lt_100: bool):
    """Per-segment RANSAC refit, likelihoods and the competition DATA term.

    phi: (S, H, W) slots; alive: (S,) slot mask (purged segments stay in the
    stack but stop competing, in place of the reference's deletion,
    DispSegmentation.m:505-529); surface: (S, k) warm starts. Every slot is
    fitted in one batch with a stream of its own (``draws.split(S)``).
    Returns (DATA, DH, gradPHI, surface, cov)."""
    s, h, w = phi.shape
    feats = _feature_shape(h, w, order)
    h1 = (phi >= 0.0) & alive[:, None, None]

    surface, dist_d = ransac_surface(draws.split(s), d_fit, h1, feats, 1.0, cset, 10,
                                     model_in=surface)

    h1sum = torch.clamp(h1.sum(dim=(1, 2)), min=1)
    if inlier_lt_100:
        inl = h1 & (dist_d < 100.0)
        cov = torch.where(inl, dist_d, 0.0).sum(dim=(1, 2)) / torch.clamp(
            inl.sum(dim=(1, 2)), min=1)
    else:
        cov = torch.where(h1, dist_d, 0.0).sum(dim=(1, 2)) / h1sum
    cov = torch.maximum(cov, min_cov)

    norm, p = _likelihood(dist_d, cov[:, None, None])  # norm (S, 1, 1)
    # dead slots claim nothing and contribute nothing to the competition
    p = torch.where(alive[:, None, None], p, 0.0)
    surface = torch.where(alive[:, None], surface, 0.0)

    dh = _delta_heaviside(phi, floor=0.06)  # (:535-536)
    grad = _grad_mag(phi)

    if strategy == "surface":
        wc = _others_max(p)
    elif strategy == "greedy":
        hnotany = ~h1.any(dim=0)
        wc = torch.where(hnotany[None] & (dh > 0.02), 0.0, _others_max(p))
    else:  # 'inverse'
        ptemp = torch.where(h1, p, 0.0)
        inv = norm - p
        wc = torch.maximum(inv, _others_max(ptemp))
    data = _log_ratio(p, wc)
    return data, dh, grad, surface, cov


def _rc_cv_step(phi, data, dh, grad, tau, gamma, alive):
    out = cv_aos_step(phi, data, dh, grad, tau, gamma)
    return torch.where(alive[:, None, None], out, -5.0)


def _rc_purge(phi, alive, thr_px):
    """Small-segment purge (:505-529) as an alive-mask update, no sync."""
    sizes = (phi >= 0.0).sum(dim=(1, 2))
    return alive & (sizes.to(torch.float32) >= thr_px)


def _rc_stage(draws, phi, d, d_fit, surface, alive, min_cov, cset, tau, gamma, thr_px,
              n_iters: int, order: int, strategy: str, inlier_lt_100: bool, next_shape=None):
    """One pyramid stage of region competition (DispSegmentation.m:531-631):
    the purge, a stream split every iteration, the recompute on even
    iterations, one CV step of the stack. Returns (phi, surface, alive)."""
    data = dh = grad = torch.zeros_like(phi)
    for i in range(n_iters):
        alive = _rc_purge(phi, alive, thr_px)
        sub = draws.split()
        if i % 2 == 0:
            data, dh, grad, surface, _cov = _rc_recompute(
                sub, phi, d, d_fit, surface, min_cov, cset, alive, order=order,
                strategy=strategy, inlier_lt_100=inlier_lt_100)
        phi = _rc_cv_step(phi, data, dh, grad, tau, gamma, alive)
    if next_shape is not None:
        phi = imresize(phi, next_shape, "bicubic")
    return phi, surface, alive


def _region_competition(d_levels, d_fit_levels, pyramid, order, sigma_lim, iterations,
                        srem_thr, phi_list, strategy, draws, gamma_coef, tau, inlier_lt_100,
                        cset=0.7):
    """Returns (list of (H, W) phi fields, (S', k) surfaces)."""
    n_levels = max(pyramid)
    shapes = [tuple(d_levels[i].shape) for i in range(n_levels)]
    dev = d_levels[0].device

    # downscale the stack through the levels (:470-473)
    phi_levels = _aa_chain(torch.stack(phi_list), shapes[1:n_levels])

    s = phi_levels[0].shape[0]
    min_cov = torch.full((), float(sigma_lim), dtype=torch.float32, device=dev)
    surface = torch.zeros((s, _n_coef(order)), dtype=torch.float32, device=dev)
    alive = torch.ones((s,), dtype=torch.bool, device=dev)
    phi = None

    for cscl in range(len(pyramid) - 1):
        scl = pyramid[cscl] - 1
        h, w = shapes[scl]
        gamma = gamma_coef * float((h * w) ** 0.7)
        if phi is None:
            phi = phi_levels[scl]
        # as in pde_tpu: a purged slot leaves the competition DATA at the next
        # scheduled recompute (<= 1 iteration later), and the all-segments-gone
        # exit (:505-529) is decided once, at the end
        nxt = pyramid[cscl + 1]
        phi, surface, alive = _rc_stage(
            draws, phi, d_levels[scl], d_fit_levels[scl], surface, alive, min_cov, cset, tau,
            gamma, float(np.float32(srem_thr * h * w)), n_iters=iterations, order=order,
            strategy=strategy, inlier_lt_100=inlier_lt_100,
            next_shape=(shapes[nxt - 1] if nxt != -1 else None))

    keep = torch.nonzero(alive).reshape(-1).tolist()  # the phase's one sync
    if not keep:
        return [], torch.zeros((0, _n_coef(order)), dtype=torch.float32, device=dev)
    return [phi[i] for i in keep], surface[keep]


# ---------------------------------------------------------------------------
# Public drivers
# ---------------------------------------------------------------------------


def _build_pyramids(din, p: DispSegParams, sparse: bool, device):
    d0 = as_tensor(din, device)
    if sparse:
        d0 = nanmedfilt2(d0, 5)  # Sparse.m:63
    else:
        d0 = torch.nan_to_num(d0)  # "We don't like NaNs" (:62)
    d_levels = [d0]
    h0, w0 = d0.shape
    seed_pyr, comp_pyr = [1], [1]
    min_scl = min(p.gen_scl, p.rc_scl)
    while True:
        prev = d_levels[-1]
        nh = int(np.ceil(prev.shape[0] * p.scl_factor))
        nw = int(np.ceil(prev.shape[1] * p.scl_factor))
        if sparse:
            nxt = nanmedfilt2(imresize_nan(nanmedfilt2(prev, 5), (nh, nw), "bicubic"), 5)
        else:
            nxt = imresize(prev, (nh, nw), "bicubic")
        d_levels.append(nxt)
        scl = len(d_levels)
        if nh >= h0 * p.gen_scl and nw >= w0 * p.gen_scl:
            seed_pyr.append(scl)
        if nh >= h0 * p.rc_scl and nw >= w0 * p.rc_scl:
            comp_pyr.append(scl)
        if nh < h0 * min_scl or nw < w0 * min_scl:
            break
    seed_pyr = seed_pyr + list(range(seed_pyr[-1], 0, -1)) + [-1]
    comp_pyr = comp_pyr + list(range(comp_pyr[-1], 0, -1)) + [-1]

    if sparse:
        d_fit = [torch.where(torch.isnan(d), 1000.0, d) for d in d_levels]
    else:
        d_fit = d_levels
    return d_levels, d_fit, seed_pyr, comp_pyr


def _number_segments(phi_stack):
    """SEG map (:190-198): overlaps -> 0, ids 1..S, int32."""
    if phi_stack.shape[0] == 0:
        return torch.zeros(phi_stack.shape[1:], dtype=torch.int32, device=phi_stack.device)
    h1 = phi_stack > 0.0
    s = phi_stack.shape[0]
    ids = torch.arange(1, s + 1, dtype=torch.int32, device=phi_stack.device)[:, None, None]
    seg = (h1 * ids).sum(dim=0).to(torch.int32)
    seg = torch.where(h1.sum(dim=0) >= 2, 0, seg)
    seg = torch.where(seg > s, s + 1, seg)
    return seg.to(torch.int32)


def _fingerprint(din, p: DispSegParams, sparse: bool) -> str:
    """sha1 over the input map (NaN as 1e30), the parameters and the variant,
    as ``pde_tpu`` computes it."""
    host = din.detach().cpu().numpy() if torch.is_tensor(din) else np.asarray(din)
    fp = hashlib.sha1()
    fp.update(np.ascontiguousarray(np.nan_to_num(host.astype(np.float32), nan=1e30)).tobytes())
    fp.update(repr((repr(p), bool(sparse))).encode())
    return fp.hexdigest()


def _disp_segmentation(din, sparse: bool, params=None, phi=None, aa=None, checkpoint_path=None,
                       collect=None, device=None, _draws=None, **overrides):
    base = params or (sparse_defaults() if sparse else DispSegParams())
    p = with_overrides(base, **overrides)
    dev = input_device(din, device)
    d_levels, d_fit, seed_pyr, comp_pyr = _build_pyramids(din, p, sparse, dev)
    h, w = d_levels[0].shape
    k = _n_coef(p.polyorder)
    aa0 = (torch.ones((h, w), dtype=torch.float32, device=dev) if aa is None
           else as_tensor(aa, dev))
    cset_vect = [
        p.ransac_min_cset
        + (p.ransac_max_cset - p.ransac_min_cset) / p.ransac_cset_cycles * i
        for i in range(p.ransac_cset_cycles + 1)
    ]
    draws = _draws if _draws is not None else TorchDraws(p.rng_seed, dev)
    gamma_seed = 0.005 if sparse else 0.01
    gamma_rc = 0.005 if sparse else 0.001
    il100 = sparse

    def gen(pyr, sigma_lim, n_seeds, aa_in):
        return _generate_seeds(
            d_levels, d_fit, pyr, p.polyorder, sigma_lim, cset_vect, p.seed_iterations, aa_in,
            n_seeds, gamma_seed, p.tau, draws, p.ransac_first, p.ransac_rest, il100)

    def compete(phi_list, sigma_lim, iters):
        return _region_competition(
            d_levels, d_fit, comp_pyr, p.polyorder, sigma_lim, iters, p.srem_thr, phi_list,
            "inverse", draws, gamma_rc, p.tau, il100, cset=p.ransac_max_cset)

    def uncovered(phi_list):
        return ((torch.stack(phi_list) > 0).sum(dim=0) == 0).to(torch.float32)

    # phase-level checkpoint and resume for the long cold-start pipeline
    # (the reference has none). The file is fingerprinted over (din, params,
    # sparse), so a stale one from another input or configuration is ignored
    # with a warning; a warm-start ``phi`` run neither reads nor writes one.
    # It holds the draw source's state where pde_tpu holds its key, so a
    # resumed run draws what an uninterrupted one draws.
    owns_checkpoint = checkpoint_path is not None and phi is None
    ck_phase = -1
    if owns_checkpoint:
        fp_hex = _fingerprint(din, p, sparse)
        fp_arr = np.frombuffer(fp_hex.encode(), dtype=np.uint8).copy()
    if owns_checkpoint and os.path.exists(checkpoint_path):
        like = {"phase": 0, "phi": np.zeros((1, h, w), np.float32),
                "sparam": np.zeros((1, k), np.float32), "key": draws.state(), "fp": fp_arr}
        # any fault of the file (unreadable, another structure, another input
        # or draw source) is reported and the run starts afresh
        try:
            st = load_state(checkpoint_path, like)
            if bytes(np.asarray(st["fp"])) != fp_hex.encode():
                raise ValueError("fingerprint mismatch")
            draws.set_state(st["key"])
        except Exception as e:
            warnings.warn(
                f"ignoring checkpoint at {checkpoint_path}: {e} "
                "(different input/params or incompatible format)", stacklevel=3)
        else:
            ck_phase = int(st["phase"])
            phi_list = [torch.from_numpy(x).to(dev) for x in st["phi"]]
            sparam = torch.from_numpy(np.asarray(st["sparam"], np.float32)).to(dev)

    def save_ck(phase, phi_list, sparam):
        if not owns_checkpoint:
            return
        if isinstance(sparam, list):
            sparam = np.asarray([m.cpu().numpy() for m in sparam])
        save_state(checkpoint_path, {
            "phase": phase,
            "phi": (torch.stack(phi_list) if phi_list
                    else np.zeros((0, h, w), np.float32)),
            "sparam": sparam, "key": draws.state(), "fp": fp_arr})

    def snap(name, phi_list):
        # phase-level observability (the reference's imagesc/drawnow,
        # DispSegmentation.m:395,644-645): append (phase, SEG map)
        if collect is not None:
            stack = (torch.stack(phi_list) if phi_list
                     else torch.zeros((0, h, w), dtype=torch.float32, device=dev))
            collect.append((name, _number_segments(stack)))

    if phi is None:
        if ck_phase < 0:
            phi_list, sparam = gen(seed_pyr, 0.7, p.seeds, aa0)
            save_ck(0, phi_list, sparam)
        snap("seeds", phi_list)
        if p.seeds != 1 and phi_list:
            if ck_phase < 1:
                phi_list, sparam = compete(phi_list, 1.5, p.rc_iterations)
                save_ck(1, phi_list, sparam)
            snap("competition1", phi_list)
            if ck_phase < 2:
                covered = uncovered(phi_list) if phi_list else aa0
                new_list, _ = gen(comp_pyr, 1.2, p.seeds, covered)
                phi_list = phi_list + new_list
                save_ck(2, phi_list, sparam)
            snap("seeds2", phi_list)
            if phi_list:
                phi_list, sparam = compete(phi_list, 1.5, p.rc_iterations2)
    else:
        phi_in = as_tensor(phi, dev)
        phi_list = [phi_in[i] for i in range(phi_in.shape[0])]
        phi_list, sparam = compete(phi_list, 1.0, p.rc_iterations2)
        covered = uncovered(phi_list) if phi_list else aa0
        new_list, _ = gen(comp_pyr, 1.2, 1, covered)
        phi_list = phi_list + new_list
        if phi_list:
            phi_list, sparam = compete(phi_list, 2.0, p.rc_iterations2)

    # the run completed: drop the phase checkpoint, so that a later call with
    # the same path starts afresh
    if owns_checkpoint and os.path.exists(checkpoint_path):
        try:
            os.remove(checkpoint_path)
        except OSError:
            pass

    phi_stack = (torch.stack(phi_list) if phi_list
                 else torch.zeros((0, h, w), dtype=torch.float32, device=dev))
    seg = _number_segments(phi_stack)
    if isinstance(sparam, list):
        sparam = (torch.stack(sparam) if sparam
                  else torch.zeros((0, k), dtype=torch.float32, device=dev))
    return phi_stack, seg, sparam


def disp_segmentation(din, params: DispSegParams | None = None, phi=None, aa=None,
                      checkpoint_path=None, collect=None, device=None, _draws=None,
                      **overrides):
    """Dense disparity-map segmentation (DispSegmentation.m).

    din: (H, W) disparity map, a numpy array or a tensor. phi: optional
    (S, H, W) warm-start level sets (the re-segmentation path, :147-180).
    aa: optional (H, W) allowed area. checkpoint_path: optional ``.npz`` of
    a phase checkpoint, resumed when it matches this input and these
    parameters and removed when the run completes. collect: optional list;
    (phase name, SEG map) is appended after each pipeline phase.

    Runs on ``din``'s device if it is a tensor, else on ``device``, else on
    the CUDA card (raises where there is none); ``phi``, ``aa`` and the
    random draws follow. Returns (PHI (S, H, W) float32, SEG (H, W) int32,
    SParam (S, k) float32) tensors on that device."""
    return _disp_segmentation(din, False, params, phi, aa, checkpoint_path, collect, device,
                              _draws, **overrides)


def disp_segmentation_sparse(din, params: DispSegParams | None = None, phi=None, aa=None,
                             checkpoint_path=None, collect=None, device=None, _draws=None,
                             **overrides):
    """Sparse (NaN-holed) disparity segmentation (DispSegmentationSparse.m);
    as :func:`disp_segmentation` otherwise."""
    return _disp_segmentation(din, True, params, phi, aa, checkpoint_path, collect, device,
                              _draws, **overrides)
