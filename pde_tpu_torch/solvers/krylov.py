"""Line-implicit preconditioned conjugate gradients (the engine's
``solver=2``), ported from ``pde_tpu/solvers/krylov.py``.

Conjugate gradients on the symmetric positive (semi-)definite systems of
the flow, disparity and diagonal-form solvers, preconditioned by one
symmetrised zebra-ADI pass: every line of one parity solved at once
(columns, then rows, then the same in reverse). Each such step (its RHS,
the parity line solve and the write into the correction) is one
``kernels/dispatch.py::zebra_pass``: one launch of the CUDA kernel
``csrc/tridiag.cu`` for CUDA tensors. The line systems are fixed for a
whole solve, so they are factored once per call and each step replays
only the RHS.

NaN protocol: pixels with NaN data terms drop Du/Cu/M and relax by pure
diffusion, folded into the coefficient fields, so the CG operator itself
is branch-free.

The CG scalars (step, direction weight, residual products and their
guards) stay 0-d or per-system tensors on the fields' device: no value
comes back to the host inside the loop. ``iters`` is the fixed number of
CG iterations; ``omega`` is accepted for the reference's signatures and
unused, as in ``pde_tpu``.

The 8-neighbour systems (``pcg_flow_llin8``, ``pcg_pde8``) add the four
diagonal weights to the operator and to each preconditioner line pass's
RHS, with the lines' own tridiagonals unchanged. The tensor stencil's
diagonal weights may be negative; the operator stays symmetric and, for
the quantile-regularised tensors the models build, positive semidefinite.

Reduction scopes: ``pcg_pde4`` and ``pcg_pde8`` solve leading channel dims
jointly (one dot product over all of ``(C, H, W)``, as ``pde_tpu``); ``pcg_disp_llin4``
takes leading dims as independent systems (one dot product per member
over ``(H, W)``, as ``pde_tpu``'s ``vmap`` of it over the symmetric pair).
"""

from __future__ import annotations

import torch

from pde_tpu_torch.core.grid import shift_e, shift_n, shift_s, shift_w
from pde_tpu_torch.kernels import dispatch
from pde_tpu_torch.solvers.tdma import _edge_zero, _zero_diag_borders

PER_MEMBER = (-2, -1)  # reduce over (H, W) only: leading dims are separate systems


def _edge_zeroed4(ww, wn, we, ws):
    return (_edge_zero(ww, -1, "first"), _edge_zero(wn, -2, "first"),
            _edge_zero(we, -1, "last"), _edge_zero(ws, -2, "last"))


def _nbr4(x, ww, wn, we, ws):
    return ww * shift_w(x) + wn * shift_n(x) + we * shift_e(x) + ws * shift_s(x)


def _nbr_diag(x, wnw, wne, wse, wsw):
    return (wnw * shift_n(shift_w(x)) + wne * shift_n(shift_e(x))
            + wse * shift_s(shift_e(x)) + wsw * shift_s(shift_w(x)))


def _diag_weights(w_diag):
    """(edge-zeroed diagonal weights, x -> their flux) or (None, None)."""
    if w_diag is None:
        return None, None
    wd = _zero_diag_borders(*w_diag)
    return wd, lambda x: _nbr_diag(x, *wd)


def _pcg(apply_a, precond, b, x0, iters: int, dims=None):
    """CG on tuples of fields, ``iters`` iterations. ``dims`` None reduces
    each dot product over everything; else over ``dims``, one product per
    remaining index (kept as size-1 dims, so it broadcasts)."""

    def dot(xs, ys):
        if dims is None:
            return sum(torch.sum(x * y) for x, y in zip(xs, ys))
        return sum(torch.sum(x * y, dim=dims, keepdim=True) for x, y in zip(xs, ys))

    def axpy(alpha, xs, ys):
        return tuple(x + alpha * y for x, y in zip(xs, ys))

    x = x0
    r = tuple(bb - aa for bb, aa in zip(b, apply_a(x0)))
    p = precond(r)
    rz = dot(r, p)
    for _ in range(iters):
        ap = apply_a(p)
        pap = dot(p, ap)
        # guard exact convergence / a semidefinite null space
        alpha = torch.where(pap > 0, rz / torch.where(pap == 0, 1.0, pap), 0.0)
        x = axpy(alpha, x, p)
        r = axpy(-alpha, r, ap)
        z = precond(r)
        rz_new = dot(r, z)
        beta = torch.where(rz > 0, rz_new / torch.where(rz == 0, 1.0, rz), 0.0)
        p = axpy(beta, z, p)
        rz = rz_new
    return x


def _zebra_factors(diags, wz4s):
    """Per field, the (vertical, horizontal) line factors of the
    preconditioner, once per solve."""
    return [(dispatch.line_factors(-wn, dg, -ws, True),
             dispatch.line_factors(-ww, dg, -we, False))
            for dg, (ww, wn, we, ws) in zip(diags, wz4s)]


def _zebra_adi(rhs, diags, facs, wz4s, n: int, w_diag=None, m=None):
    """One symmetrised zebra-ADI pass over ``n`` coupled fields from a zero
    guess: field 0..n-1 columns (parity 0, 1), then rows, then the same
    steps reversed. Field k's RHS is ``rhs[k]``, less ``m`` times the
    other field's current correction for the coupled pair (``m`` given);
    ``w_diag`` (8 neighbours) adds the diagonal coupling of the field's
    current correction. Each step is one ``dispatch.zebra_pass``: one
    launch on the card, writing into the corrections allocated here."""
    z = [torch.zeros_like(d) for d in diags]
    steps = [(k, p, True) for k in range(n) for p in (0, 1)]
    steps += [(k, p, False) for k in range(n) for p in (0, 1)]
    for k, p, vert in steps + steps[::-1]:
        ww, wn, we, ws = wz4s[k]
        z[k] = dispatch.zebra_pass(facs[k][0 if vert else 1], z[k], rhs[k],
                                   ww if vert else wn, we if vert else ws, p, vert,
                                   None if m is None else z[1 - k], m, w_diag)
    return tuple(z)


def _flow_pcg(u, v, du0, dv0, m, cu, cv, duc, dvc, w4, w_diag, iters: int):
    """The coupled flow pair: llin against the frozen (u, v); elin with
    u = v = 0, whose base term vanishes. ``w_diag``: the four diagonal
    weights (NW, NE, SE, SW) of the 8-neighbour system, or None."""
    ww, wn, we, ws = _edge_zeroed4(*w4)
    wsum = ww + wn + we + ws
    wd, dflux = _diag_weights(w_diag)
    if wd is not None:
        wsum = wsum + wd[0] + wd[1] + wd[2] + wd[3]
    valid_u = ~torch.isnan(cu)
    valid_v = ~torch.isnan(cv)
    d_u = torch.where(valid_u, torch.nan_to_num(duc), 0.0)
    d_v = torch.where(valid_v, torch.nan_to_num(dvc), 0.0)
    # symmetrised coupling mask (the Cu/Cv NaN patterns coincide in the
    # models: both come from the same out-of-bounds warp)
    m_eff = torch.where(valid_u & valid_v, torch.nan_to_num(m), 0.0)

    def base_term(f):
        # llin base-field differences Σ w_z (f_nbr − f_c)
        s = _nbr4(f, ww, wn, we, ws)
        if dflux is not None:
            s = s + dflux(f)
        return s - wsum * f

    b_u = base_term(u) + torch.where(valid_u, torch.nan_to_num(cu), 0.0)
    b_v = base_term(v) + torch.where(valid_v, torch.nan_to_num(cv), 0.0)
    diag_u = wsum + d_u
    diag_v = wsum + d_v

    def apply_a(x):
        xu, xv = x
        au = diag_u * xu - _nbr4(xu, ww, wn, we, ws) + m_eff * xv
        av = diag_v * xv - _nbr4(xv, ww, wn, we, ws) + m_eff * xu
        if dflux is not None:
            au = au - dflux(xu)
            av = av - dflux(xv)
        return au, av

    wz4 = (ww, wn, we, ws)
    facs = _zebra_factors((diag_u, diag_v), (wz4, wz4))

    def precond(r):
        ru, rv = r
        return _zebra_adi((ru, rv), (diag_u, diag_v), facs, (wz4, wz4), 2, wd, m_eff)

    return _pcg(apply_a, precond, (b_u, b_v), (du0, dv0), iters)


def pcg_flow_elin4(u, v, m, cu, cv, duc, dvc, ww, wn, we, ws, iters: int, omega: float):
    """solver=2 for the early-linearised pair (drop-in for
    GS_ALR_SOR_elin4_2d). (H, W) fields; returns new (U, V)."""
    del omega
    zero = torch.zeros_like(u)
    return _flow_pcg(zero, zero, u, v, m, cu, cv, duc, dvc, (ww, wn, we, ws), None, iters)


def pcg_flow_llin4(u, v, du, dv, m, cu, cv, duc, dvc, ww, wn, we, ws,
                   iters: int, omega: float):
    """solver=2 for the late-linearised increment pair
    (GS_ALR_SOR_llin4_2d). (H, W) fields; returns new (dU, dV)."""
    del omega
    return _flow_pcg(u, v, du, dv, m, cu, cv, duc, dvc, (ww, wn, we, ws), None, iters)


def pcg_flow_llin8(u, v, du, dv, m, cu, cv, duc, dvc,
                   ww, wnw, wn, wne, we, wse, ws, wsw, iters: int, omega: float):
    """solver=2 for the anisotropic 8-neighbour increment pair
    (GS_ALR_SOR_llin8_2d). (H, W) fields; returns new (dU, dV)."""
    del omega
    return _flow_pcg(u, v, du, dv, m, cu, cv, duc, dvc, (ww, wn, we, ws),
                     (wnw, wne, wse, wsw), iters)


def _scalar_pcg(u, du0, cu, duc, w4, iters: int, dims, trace=None, b_in=None, w_diag=None):
    ww, wn, we, ws = _edge_zeroed4(*w4)
    wsum = ww + wn + we + ws
    wd, dflux = _diag_weights(w_diag)
    if wd is not None:
        wsum = wsum + wd[0] + wd[1] + wd[2] + wd[3]
    if trace is None:
        valid = ~torch.isnan(cu)
        diag = wsum + torch.where(valid, torch.nan_to_num(duc), 0.0)
        b = (_nbr4(u, ww, wn, we, ws) - wsum * u) + torch.where(valid, torch.nan_to_num(cu), 0.0)
    else:
        valid = ~torch.isnan(trace)
        diag = torch.where(valid, torch.nan_to_num(trace, nan=1.0), wsum)
        b = torch.where(valid, b_in, 0.0)

    def apply_a(x):
        (xu,) = x
        ax = diag * xu - _nbr4(xu, ww, wn, we, ws)
        return (ax if dflux is None else ax - dflux(xu),)

    wz4 = (ww, wn, we, ws)
    facs = _zebra_factors((diag,), (wz4,))

    def precond(r):
        return _zebra_adi(r, (diag,), facs, (wz4,), 1, wd)

    return _pcg(apply_a, precond, (b,), (du0,), iters, dims)[0]


def pcg_disp_llin4(u, du, cu, duc, ww, wn, we, ws, iters: int, omega: float):
    """solver=2 scalar disparity increment (disparitySolvers.c:154-217).
    Fields (..., H, W); leading dims are independent systems, each with its
    own CG scalars. Returns new dU."""
    del omega
    return _scalar_pcg(u, du, cu, duc, (ww, wn, we, ws), iters, PER_MEMBER)


def pcg_pde4(x, trace, b, ww, wn, we, ws, iters: int, omega: float):
    """solver=2 diagonal form: TRACE x − Σ w_z x_nbr = B (GS_ALR_SOR_4_2d).
    Leading channel dims are solved jointly (the system is block-diagonal
    over them); the weights may be one shared (H, W) plane. Returns new X."""
    del omega
    return _scalar_pcg(None, x, None, None, (ww, wn, we, ws), iters, None, trace=trace, b_in=b)


def pcg_pde8(x, trace, b, ww, wnw, wn, wne, we, wse, ws, wsw, iters: int, omega: float):
    """solver=2 diagonal form, 8-neighbour tensor stencil (GS_ALR_SOR_8_2d).
    Leading channel dims are solved jointly, as in ``pcg_pde4``; the
    weights may be one shared (H, W) plane each. Returns new X."""
    del omega
    return _scalar_pcg(None, x, None, None, (ww, wn, we, ws), iters, None, trace=trace,
                       b_in=b, w_diag=(wnw, wne, wse, wsw))
