"""Batched tridiagonal (Thomas) solves and zebra alternating-line relaxation
(ALR), ported from ``pde_tpu/solvers/tdma.py``.

The functions here up to ``line_solve`` are the plain PyTorch versions of
the CUDA kernel ``csrc/tridiag.cu``: the path for CPU tensors and the
kernel's reference on the card. Callers reach them through
``kernels/dispatch.py`` (``thomas_solve``, ``tridiag_factor``,
``tridiag_solve``, ``line_factors``, ``line_solve``), which sends CUDA
tensors to the kernel.

* ``thomas_solve_scan``: ``pde_tpu``'s ``lax.scan`` Thomas elimination as a
  Python loop over the line axis, with exactly its float operations.
* ``tridiag_factor``/``tridiag_solve``: factor once, replay the RHS pass;
  the same arithmetic, ``method="scan"`` (the path here, as on ``pde_tpu``'s
  CPU backend) or ``"cr"`` (cyclic reduction, ``pde_tpu``'s TPU path, kept
  for parity tests). ``thomas_solve`` is the two in one.
* ``line_factors``/``line_solve``: the zebra helpers (the lines of one
  parity).
* ``alr_*``: the zebra ALR solvers (cf. GS_ALR_SOR_*_2d): whole rows or
  columns of one parity solved at once, SOR-blended with the previous
  iterate, their line solves through ``kernels/dispatch.py``. The
  8-neighbour ones (``alr_flow_llin8``, ``alr_pde8``) keep the line's two
  neighbours on the tridiagonal and couple the other two and the four
  diagonals through the RHS with their current values.

Systems: ``a[k] x[k-1] + b[k] x[k] + c[k] x[k+1] = d[k]`` along ``axis``,
independent over every other axis; ``a[0]`` and ``c[-1]`` are ignored.
Coefficients broadcast against each other (a shared ``(H, W)`` plane
against a ``(C, H, W)`` diagonal).
"""

from __future__ import annotations

import torch

from pde_tpu_torch.core.grid import shift_e, shift_n, shift_s, shift_w
from pde_tpu_torch.kernels import dispatch


def thomas_solve_scan(a, b, c, d, axis: int = -2):
    """The sequential Thomas elimination, as ``pde_tpu``'s reference scan:
    a[0] enters multiplied by a zero carry, c[-1] by a zero solution."""
    a, b, c, d = (torch.movedim(x, axis, 0) for x in (a, b, c, d))
    zeros = torch.zeros_like(b[0])
    cp_prev = dp_prev = zeros
    cps, dps = [], []
    for k in range(b.shape[0]):
        denom = 1.0 / (b[k] - cp_prev * a[k])
        cp_prev = c[k] * denom
        dp_prev = (d[k] - dp_prev * a[k]) * denom
        cps.append(cp_prev)
        dps.append(dp_prev)
    xs = [zeros] * len(dps)
    x_next = zeros
    for k in range(len(dps) - 1, -1, -1):
        x_next = dps[k] - cps[k] * x_next
        xs[k] = x_next
    return torch.movedim(torch.stack(xs), 0, axis)


def _zero_corners(a, c):
    """a with a[0] = 0 and c with c[-1] = 0 (the line axis first)."""
    zero = torch.zeros_like(a[:1])
    return torch.cat([zero, a[1:]]), torch.cat([c[:-1], torch.zeros_like(c[:1])])


def thomas_solve_cr(a, b, c, d, axis: int = -2):
    """Cyclic-reduction solve (``pde_tpu``'s TPU path): log2(L) levels that
    eliminate the odd rows; the same systems as the scan, to float32
    elimination-order noise."""
    a, b, c, d = (torch.movedim(x, axis, 0) for x in (a, b, c, d))
    a, c = _zero_corners(a, c)
    return torch.movedim(_cr_level(a, b, c, d), 0, axis)


def _cr_level(a, b, c, d):
    h = a.shape[0]
    if h == 1:
        return d / b
    if h == 2:
        det = b[0] * b[1] - c[0] * a[1]
        x0 = (d[0] * b[1] - c[0] * d[1]) / det
        x1 = (b[0] * d[1] - d[0] * a[1]) / det
        return torch.stack([x0, x1])
    if h % 2 == 1:
        # append an identity row (x_pad = 0, decoupled)
        a = torch.cat([a, torch.zeros_like(a[:1])])
        b = torch.cat([b, torch.ones_like(b[:1])])
        c = torch.cat([c, torch.zeros_like(c[:1])])
        d = torch.cat([d, torch.zeros_like(d[:1])])
        return _cr_level(a, b, c, d)[:h]

    ae, be, ce, de = a[0::2], b[0::2], c[0::2], d[0::2]
    ao, bo, co, do_ = a[1::2], b[1::2], c[1::2], d[1::2]
    bprev = torch.cat([torch.ones_like(bo[:1]), bo[:-1]])
    cprev = torch.cat([torch.zeros_like(co[:1]), co[:-1]])
    dprev = torch.cat([torch.zeros_like(do_[:1]), do_[:-1]])
    aprev = torch.cat([torch.zeros_like(ao[:1]), ao[:-1]])
    alpha = ae / bprev
    gamma = ce / bo
    a2 = -alpha * aprev
    c2 = -gamma * co
    b2 = be - alpha * cprev - gamma * ao
    d2 = de - alpha * dprev - gamma * do_
    xe = _cr_level(a2, b2, c2, d2)
    xnext = torch.cat([xe[1:], torch.zeros_like(xe[:1])])
    xo = (do_ - ao * xe - co * xnext) / bo
    return torch.stack([xe, xo], 1).reshape((-1,) + tuple(xe.shape[1:]))


class TridiagFactor:
    """Reusable elimination of a tridiagonal (a, b, c) along one axis
    (moved to the front): ``cp``, ``denom`` and the corner-zeroed ``a``
    for ``method="scan"``; the reduction levels and base solve for
    ``"cr"``."""

    __slots__ = ("method", "levels", "base", "cp", "denom", "a")

    def __init__(self, method: str):
        self.method = method
        self.levels = []
        self.base = None


def tridiag_factor(a, b, c, axis: int = -2, method: str = "scan") -> TridiagFactor:
    """Precompute the elimination of the systems along ``axis`` (a[0] and
    c[-1] ignored), for :func:`tridiag_solve`."""
    a, b, c = (torch.movedim(x, axis, 0) for x in (a, b, c))
    a, c = _zero_corners(a, c)
    if method == "cr":
        fac = TridiagFactor("cr")
        while a.shape[0] > 2:
            h = a.shape[0]
            if h % 2 == 1:
                a = torch.cat([a, torch.zeros_like(a[:1])])
                b = torch.cat([b, torch.ones_like(b[:1])])
                c = torch.cat([c, torch.zeros_like(c[:1])])
                fac.levels.append(("pad", h))
                continue
            ae, be, ce = a[0::2], b[0::2], c[0::2]
            ao, bo, co = a[1::2], b[1::2], c[1::2]
            bprev = torch.cat([torch.ones_like(bo[:1]), bo[:-1]])
            cprev = torch.cat([torch.zeros_like(co[:1]), co[:-1]])
            aprev = torch.cat([torch.zeros_like(ao[:1]), ao[:-1]])
            alpha = ae / bprev
            gamma = ce / bo
            a2 = -alpha * aprev
            c2 = -gamma * co
            b2 = be - alpha * cprev - gamma * ao
            fac.levels.append(("reduce", alpha, gamma, ao, co, 1.0 / bo))
            a, b, c = a2, b2, c2
        if a.shape[0] == 1:
            fac.base = ("b1", 1.0 / b)
        else:
            det = b[0] * b[1] - c[0] * a[1]
            fac.base = ("b2", b[0], b[1], a[1], c[0], 1.0 / det)
        return fac
    if method != "scan":
        raise ValueError(f"tridiag_factor: method must be 'scan' or 'cr', got {method!r}")
    fac = TridiagFactor("scan")
    cp_prev = torch.zeros_like(b[0])
    cps, denoms = [], []
    for k in range(b.shape[0]):
        denom = 1.0 / (b[k] - cp_prev * a[k])
        cp_prev = c[k] * denom
        cps.append(cp_prev)
        denoms.append(denom)
    fac.cp, fac.denom, fac.a = torch.stack(cps), torch.stack(denoms), a
    return fac


def tridiag_solve(fac: TridiagFactor, d, axis: int = -2):
    """Solve with a precomputed :func:`tridiag_factor` for a new RHS."""
    d = torch.movedim(d, axis, 0)
    if fac.method == "cr":
        stack = []
        for lvl in fac.levels:
            if lvl[0] == "pad":
                d = torch.cat([d, torch.zeros_like(d[:1])])
                stack.append(("pad", lvl[1]))
                continue
            _, alpha, gamma, ao, co, inv_bo = lvl
            de, do_ = d[0::2], d[1::2]
            dprev = torch.cat([torch.zeros_like(do_[:1]), do_[:-1]])
            stack.append(("reduce", do_, ao, co, inv_bo))
            d = de - alpha * dprev - gamma * do_
        if fac.base[0] == "b1":
            x = d * fac.base[1]
        else:
            _, b0, b1, a1, c0, inv_det = fac.base
            x0 = (d[0] * b1 - c0 * d[1]) * inv_det
            x1 = (b0 * d[1] - d[0] * a1) * inv_det
            x = torch.stack([x0, x1])
        for lvl in reversed(stack):
            if lvl[0] == "pad":
                x = x[: lvl[1]]
                continue
            _, do_, ao, co, inv_bo = lvl
            xnext = torch.cat([x[1:], torch.zeros_like(x[:1])])
            xo = (do_ - ao * x - co * xnext) * inv_bo
            x = torch.stack([x, xo], 1).reshape((-1,) + tuple(x.shape[1:]))
        return torch.movedim(x, 0, axis)

    dp_prev = torch.zeros_like(d[0])
    dps = []
    for k in range(d.shape[0]):
        dp_prev = (d[k] - dp_prev * fac.a[k]) * fac.denom[k]
        dps.append(dp_prev)
    xs = [dp_prev] * len(dps)
    x_next = torch.zeros_like(d[0])
    for k in range(len(dps) - 1, -1, -1):
        x_next = dps[k] - fac.cp[k] * x_next
        xs[k] = x_next
    return torch.movedim(torch.stack(xs), 0, axis)


def thomas_solve(a, b, c, d, axis: int = -2):
    """Solve the systems along ``axis``: the scan's arithmetic with a[0]
    and c[-1] ignored (they may hold anything), the plain version of the
    kernel's one-launch solve."""
    return tridiag_solve(tridiag_factor(a, b, c, axis), d, axis)


def slice_lines(x, parity: int, vertical: bool):
    """The lines of one zebra parity: columns ``parity::2`` (vertical
    solves) or rows ``parity::2`` (horizontal)."""
    return x[..., parity::2] if vertical else x[..., parity::2, :]


def scatter_lines(x, val, parity: int, vertical: bool):
    """A copy of ``x`` with ``val`` written into its parity lines."""
    out = x.clone()
    if vertical:
        out[..., parity::2] = val
    else:
        out[..., parity::2, :] = val
    return out


def line_factors(a, b, c, vertical: bool):
    """Per-parity factors for zebra line solves: a half-pass keeps only the
    lines of one parity, so each parity's lines are factored apart, once
    per solver call."""
    axis = -2 if vertical else -1
    return tuple(
        tridiag_factor(slice_lines(a, p, vertical), slice_lines(b, p, vertical),
                       slice_lines(c, p, vertical), axis)
        for p in (0, 1))


def line_solve(facs, d_full, parity: int, vertical: bool):
    """Solve the parity lines given the full-field RHS ``d_full``."""
    axis = -2 if vertical else -1
    return tridiag_solve(facs[parity], slice_lines(d_full, parity, vertical), axis)


def _edge_zero(w, axis: int, side: str):
    """A copy of ``w`` with its first or last slice along ``axis`` zeroed
    (one-sided line ends)."""
    w = w.clone()
    w.select(axis, 0 if side == "first" else -1).zero_()
    return w


def _edge_zeroed_w4(ww, wn, we, ws):
    ww_l = _edge_zero(ww, -1, "first")
    wn_l = _edge_zero(wn, -2, "first")
    we_l = _edge_zero(we, -1, "last")
    ws_l = _edge_zero(ws, -2, "last")
    return (ww_l, wn_l, we_l, ws_l), ww_l + wn_l + we_l + ws_l


class _LlinPlan:
    """Loop-invariant pieces of one field's llin zebra relaxation: the
    edge-zeroed weights, the base-field flux plus the masked data RHS, the
    masked coupling and the line factors of both directions. Each zebra
    half-pass replays only the RHS pass on its parity lines."""

    __slots__ = ("w4", "base", "mu", "fv", "fh", "omega")

    def __init__(self, f, cuf, ducf, m0, w4_edge, wsum, omega, extra_b=None):
        ww_l, wn_l, we_l, ws_l = w4_edge
        self.w4 = w4_edge
        self.omega = omega
        valid = ~torch.isnan(cuf)
        b = wsum + torch.where(valid, torch.nan_to_num(ducf), 0.0)
        if extra_b is not None:  # the diagonal weights' sum (8 neighbours)
            b = b + extra_b
        flux = (ww_l * (shift_w(f) - f) + wn_l * (shift_n(f) - f)
                + we_l * (shift_e(f) - f) + ws_l * (shift_s(f) - f))
        self.base = flux + torch.where(valid, torch.nan_to_num(cuf), 0.0)
        self.mu = None if m0 is None else torch.where(valid, m0, 0.0)
        self.fv = dispatch.line_factors(-wn_l, b, -ws_l, True)
        self.fh = dispatch.line_factors(-ww_l, b, -we_l, False)

    def rhs_lag(self, df, vertical: bool):
        ww_l, wn_l, we_l, ws_l = self.w4
        if vertical:
            return ww_l * shift_w(df) + we_l * shift_e(df)
        return wn_l * shift_n(df) + ws_l * shift_s(df)

    def sweep(self, df, other, parity: int, vertical: bool, extra=None):
        d = self.base + self.rhs_lag(df, vertical)
        if extra is not None:
            d = d + extra
        if self.mu is not None:
            d = d - self.mu * other
        x = dispatch.line_solve(self.fv if vertical else self.fh, d, parity, vertical)
        blended = self.omega * x + (1.0 - self.omega) * slice_lines(df, parity, vertical)
        return scatter_lines(df, blended, parity, vertical)


def _alr_pair(pu, pv, fu, fv, iters: int, dflux=None):
    """Sweep order of the reference (opticalflowSolvers.c:238-257): U
    columns, V columns, V rows, U rows, each parity 0 then 1. ``dflux``
    (8 neighbours) adds the diagonal coupling of the current iterate to
    each half-pass's RHS."""

    def sweep(plan, f, other, par, vertical):
        return plan.sweep(f, other, par, vertical, None if dflux is None else dflux(f))

    for _ in range(iters):
        for par in (0, 1):
            fu = sweep(pu, fu, fv, par, True)
        for par in (0, 1):
            fv = sweep(pv, fv, fu, par, True)
        for par in (0, 1):
            fv = sweep(pv, fv, fu, par, False)
        for par in (0, 1):
            fu = sweep(pu, fu, fv, par, False)
    return fu, fv


def alr_flow_llin4(u, v, du, dv, m, cu, cv, duc, dvc, ww, wn, we, ws, iters: int, omega: float):
    """Zebra ALR for the late-linearised flow pair (cf. GS_ALR_SOR_llin4_2d).
    Returns new (dU, dV)."""
    m0 = torch.nan_to_num(m)
    w4, wsum = _edge_zeroed_w4(ww, wn, we, ws)
    pu = _LlinPlan(u, cu, duc, m0, w4, wsum, omega)
    pv = _LlinPlan(v, cv, dvc, m0, w4, wsum, omega)
    return _alr_pair(pu, pv, du, dv, iters)


def _zero_diag_borders(wnw, wne, wse, wsw):
    """Diagonal weights vanish wherever the diagonal neighbour is off the
    image."""
    wnw = _edge_zero(_edge_zero(wnw, -2, "first"), -1, "first")
    wne = _edge_zero(_edge_zero(wne, -2, "first"), -1, "last")
    wse = _edge_zero(_edge_zero(wse, -2, "last"), -1, "last")
    wsw = _edge_zero(_edge_zero(wsw, -2, "last"), -1, "first")
    return wnw, wne, wse, wsw


def _diag_flux_fn(wnw_l, wne_l, wse_l, wsw_l):
    """x -> Σ over the four diagonals of w_d x_d."""
    def dflux(x):
        return (wnw_l * shift_n(shift_w(x)) + wne_l * shift_n(shift_e(x))
                + wse_l * shift_s(shift_e(x)) + wsw_l * shift_s(shift_w(x)))

    return dflux


def alr_flow_llin8(u, v, du, dv, m, cu, cv, duc, dvc,
                   ww, wnw, wn, wne, we, wse, ws, wsw, iters: int, omega: float):
    """Zebra ALR for the 8-neighbour (anisotropic) flow pair (cf.
    GS_ALR_SOR_llin8_2d), the sweep order of the 4-neighbour one: column
    solves keep N/S on the tridiagonal, W/E and the four diagonals couple
    through the RHS with their current values. Returns new (dU, dV)."""
    m0 = torch.nan_to_num(m)
    w4, wsum4 = _edge_zeroed_w4(ww, wn, we, ws)
    wnw_l, wne_l, wse_l, wsw_l = _zero_diag_borders(wnw, wne, wse, wsw)
    dsum = wnw_l + wne_l + wse_l + wsw_l
    dflux = _diag_flux_fn(wnw_l, wne_l, wse_l, wsw_l)
    pu = _LlinPlan(u, cu, duc, m0, w4, wsum4, omega, extra_b=dsum)
    pv = _LlinPlan(v, cv, dvc, m0, w4, wsum4, omega, extra_b=dsum)
    # the frozen flow's part of the diagonal coupling: Σ w_d (f_d − f)
    pu.base = pu.base + (dflux(u) - dsum * u)
    pv.base = pv.base + (dflux(v) - dsum * v)
    return _alr_pair(pu, pv, du, dv, iters, dflux)


def alr_flow_elin4(u, v, m, cu, cv, duc, dvc, ww, wn, we, ws, iters: int, omega: float):
    """Zebra ALR for the early-linearised pair (cf. GS_ALR_SOR_elin4_2d): the
    llin core with a zero base field, so the unknown is (U, V) itself."""
    zero = torch.zeros_like(u)
    m0 = torch.nan_to_num(m)
    w4, wsum = _edge_zeroed_w4(ww, wn, we, ws)
    pu = _LlinPlan(zero, cu, duc, m0, w4, wsum, omega)
    pv = _LlinPlan(zero, cv, dvc, m0, w4, wsum, omega)
    return _alr_pair(pu, pv, u, v, iters)


def alr_disp_llin4(u, du, cu, duc, ww, wn, we, ws, iters: int, omega: float):
    """Zebra ALR for the scalar disparity increment (cf. disparitySolvers.c
    GS_ALR_SOR_llin4_2d: columns then rows). Returns new dU."""
    w4, wsum = _edge_zeroed_w4(ww, wn, we, ws)
    pu = _LlinPlan(u, cu, duc, None, w4, wsum, omega)
    for _ in range(iters):
        for par in (0, 1):
            du = pu.sweep(du, None, par, True)
        for par in (0, 1):
            du = pu.sweep(du, None, par, False)
    return du


def _alr_diag_form(x, trace, b, w4, w_diag, iters: int, omega: float):
    """Zebra ALR for the diagonal form with 4 weights, or 8 when
    ``w_diag`` holds the four diagonal ones (coupled through the RHS)."""
    tr_nan = torch.isnan(trace)
    (ww_l, wn_l, we_l, ws_l), wsum = _edge_zeroed_w4(*w4)
    dflux = None
    if w_diag is not None:
        wnw_l, wne_l, wse_l, wsw_l = _zero_diag_borders(*w_diag)
        wsum = wsum + wnw_l + wne_l + wse_l + wsw_l
        dflux = _diag_flux_fn(wnw_l, wne_l, wse_l, wsw_l)
    diag = torch.where(tr_nan, wsum, torch.nan_to_num(trace, nan=1.0))
    b_eff = torch.where(tr_nan, 0.0, b)
    fv = dispatch.line_factors(-wn_l, diag, -ws_l, True)
    fh = dispatch.line_factors(-ww_l, diag, -we_l, False)

    def half(xc, parity, vertical):
        if vertical:
            d = b_eff + ww_l * shift_w(xc) + we_l * shift_e(xc)
        else:
            d = b_eff + wn_l * shift_n(xc) + ws_l * shift_s(xc)
        if dflux is not None:
            d = d + dflux(xc)
        sol = dispatch.line_solve(fv if vertical else fh, d, parity, vertical)
        blended = omega * sol + (1.0 - omega) * slice_lines(xc, parity, vertical)
        return scatter_lines(xc, blended, parity, vertical)

    for _ in range(iters):
        for vertical in (True, False):
            for par in (0, 1):
                x = half(x, par, vertical)
    return x


def alr_pde4(x, trace, b, ww, wn, we, ws, iters: int, omega: float):
    """Zebra ALR for the diagonal form (cf. GS_ALR_SOR_4_2d): lines with
    diagonal TRACE and off-diagonals -wN/-wS (or -wW/-wE), RHS B plus the
    perpendicular flux; NaN TRACE means pure diffusion (diagonal Σw, B
    dropped). Leading channel dims broadcast against (H, W) weights."""
    return _alr_diag_form(x, trace, b, (ww, wn, we, ws), None, iters, omega)


def alr_pde8(x, trace, b, ww, wnw, wn, wne, we, wse, ws, wsw, iters: int, omega: float):
    """Zebra ALR for the 8-neighbour diagonal form (cf. GS_ALR_SOR_8_2d):
    lines keep N/S (or W/E) on the tridiagonal, all other neighbours
    couple through the RHS."""
    return _alr_diag_form(x, trace, b, (ww, wn, we, ws), (wnw, wne, wse, wsw), iters, omega)
