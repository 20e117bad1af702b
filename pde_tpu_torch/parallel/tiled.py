"""Spatially tiled solvers over a ("ty", "tx") mesh, after
``pde_tpu/parallel/tiled.py``.

Whole (H, W) fields come in and go out, on the first input's device. In
between, each field is cut into the mesh's tiles (``mesh.shard``), each
tile on its device, and every tile is relaxed on its own device from its
own data and the halo its neighbours give it (``halo.py``).

Temporal blocking (as ``pde_tpu``): one red-black sweep has dependency
radius 2, so a 2k-pixel halo (2k + 1 where the border is filled after
each sweep), exchanged once, buys k exact local sweeps
before the next exchange. A chunk of k sweeps runs on each tile's window
(``kernels/tiled.Window``: the tile and its halo, clipped to the image;
colours, the interior and the edges in the image's coordinates) and keeps
the tile: bit for bit what the same sweeps over the whole image give.
On CUDA tiles the chunks of every sharded family (llin4, elin4, llin8,
disp llin4 and pde4) run the windowed variant of ``csrc/tiled_sor.cu``,
one launch a tile and chunk, where ``pde_tpu`` runs its shard bodies as
XLA ops. On CPU tiles, or under ``dispatch.plain_solvers()``, every
family runs the plain windowed schedule (its sweep factory of
``kernels/sweeps.py`` in torch ops), over one tile a shard. The families
that fill the border take a halo of ``2k + 1`` (``kernels/tiled.py``).

The tiled PCG (``tiled_pcg_flow_llin4``) runs the CG iteration of
``solvers/krylov.py`` with halo-exchanged matvecs and dot products summed
over the tiles on the mesh's first device, where the CG scalars stay; its
zebra line preconditioner solves tile-local line segments (an additive-
Schwarz approximation of the full-image lines), each through
``kernels/dispatch.thomas_solve``: on the card the tridiagonal kernel,
``csrc/tridiag.cu``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pde_tpu_torch.kernels import dispatch, sweeps, tiled
from pde_tpu_torch.parallel.halo import halo_exchange, halo_window
from pde_tpu_torch.parallel.mesh import Mesh, shard, unshard
from pde_tpu_torch.solvers.tdma import _edge_zero

RB_RADIUS = tiled.RB_RADIUS  # dependency radius (px) of one full red-black sweep


def _grid_map(fn, *grids):
    """``fn`` tile by tile over grids of equal layout."""
    return [[fn(*(g[i][j] for g in grids)) for j in range(len(grids[0][0]))]
            for i in range(len(grids[0]))]


def _shard_chunk(fields, sweep, prepare, n_mut: int, kc: int, window, double_buffer: bool):
    """``kc`` sweeps on one tile's window; the tile's part of the relaxed
    fields."""
    i0, i1, j0, j1 = window.box
    if dispatch._plain(fields[0]):
        return tiled.plain_tiled_relax(fields, sweep, prepare, n_mut, kc, kc, i1 - i0, j1 - j0,
                                       window)
    out = tiled.tiled_relax(fields, sweep, n_mut, kc, prepare_fn=prepare, window=window,
                            double_buffer=double_buffer)
    if out is None:
        raise RuntimeError(f"no tile plan for a {i1 - i0}x{j1 - j0} shard of {len(fields)} "
                           f"fields at k = {kc}")
    return out


def tiled_relax_sharded(mesh: Mesh, sweep_factory, fields, n_mut: int, iters: int,
                        omega: float, k: int = 4, comm: bool = True,
                        double_buffer: bool = False):
    """Run ``iters`` global red-black sweeps of any ``kernels/sweeps.py``
    factory with (H, W) fields sharded over mesh axes ("ty", "tx").

    The numbers of the single-device solvers, bit for bit. Halos are
    exchanged once per ``k`` sweeps (2k px wide, 2k + 1 for disp llin4 and
    pde4), ``k`` cut to the tile's
    half-size and to ``iters``, the last chunk the remainder; pass k=1 for
    the classic per-sweep exchange. Returns the ``n_mut`` relaxed fields,
    whole, on the device of ``fields[0]``.

    comm=False pads the tiles with their own strips in place of the
    exchange (``halo.halo_window``): WRONG at tile seams, benchmark-only,
    the communication-free floor. double_buffer=True runs the chunks on
    the double-buffered windowed kernel (the same bits)."""
    prepare, sweep = sweep_factory(float(omega))
    out_device = fields[0].device
    nty, ntx = mesh.shape["ty"], mesh.shape["tx"]
    tiles = [shard(x, mesh) for x in fields]
    h, w = tiles[0][0][0].shape[-2:]
    gh, gw = h * nty, w * ntx
    iters = max(int(iters), 0)
    k_eff = max(1, min(k, iters, h // RB_RADIUS, w // RB_RADIUS))
    n_full, rem = divmod(iters, k_eff)
    mut, const = tiles[:n_mut], tiles[n_mut:]
    const_ext = {}  # the frozen fields' windows, by chunk length
    for kc in [k_eff] * n_full + ([rem] if rem else []):
        halo = tiled._halo_for(sweep.family, kc)
        if kc not in const_ext:
            const_ext[kc] = [halo_window(x, halo, comm) for x in const]
        ext = [halo_window(x, halo, comm) for x in mut] + const_ext[kc]
        new = [[[None] * ntx for _ in range(nty)] for _ in range(n_mut)]
        for i in range(nty):
            for j in range(ntx):
                r0, c0 = max(0, i * h - halo), max(0, j * w - halo)
                box = (i * h - r0, i * h - r0 + h, j * w - c0, j * w - c0 + w)
                out = _shard_chunk([e[i][j] for e in ext], sweep, prepare, n_mut, kc,
                                   tiled.Window(r0, c0, gh, gw, box), double_buffer)
                for f in range(n_mut):
                    new[f][i][j] = out[f]
        mut = new
    return tuple(unshard(t, out_device) for t in mut)


def tiled_sor_flow_llin4(mesh, u, v, du, dv, m, cu, cv, duc, dvc, ww, wn, we, ws,
                         iters: int, omega: float, comm: bool = True):
    """Tiled drop-in for ``sor_flow_llin4``: the same update, (H, W)
    sharded over mesh axes ("ty", "tx"), k = 4 sweeps a halo exchange.
    comm=False is the benchmark-only communication-free floor."""
    return tiled_relax_sharded(
        mesh, sweeps.flow_llin4_sweep,
        (du, dv, u, v, m, cu, cv, duc, dvc, ww, wn, we, ws), 2, iters, omega, comm=comm)


def tiled_sor_flow_elin4(mesh, u, v, m, cu, cv, duc, dvc, ww, wn, we, ws,
                         iters: int, omega: float):
    return tiled_relax_sharded(
        mesh, sweeps.flow_elin4_sweep,
        (u, v, m, cu, cv, duc, dvc, ww, wn, we, ws), 2, iters, omega)


def tiled_sor_flow_llin8(mesh, u, v, du, dv, m, cu, cv, duc, dvc,
                         ww, wnw, wn, wne, we, wse, ws, wsw,
                         iters: int, omega: float):
    return tiled_relax_sharded(
        mesh, sweeps.flow_llin8_sweep,
        (du, dv, u, v, m, cu, cv, duc, dvc,
         ww, wnw, wn, wne, we, wse, ws, wsw), 2, iters, omega)


def tiled_sor_disp_llin4(mesh, u, du, cu, duc, ww, wn, we, ws, iters: int, omega: float):
    return tiled_relax_sharded(
        mesh, sweeps.disp_llin4_sweep, (du, u, cu, duc, ww, wn, we, ws), 1, iters, omega)[0]


def tiled_sor_pde4(mesh, x, trace, b, ww, wn, we, ws, iters: int, omega: float):
    return tiled_relax_sharded(
        mesh, sweeps.pde4_sweep, (x, trace, b, ww, wn, we, ws), 1, iters, omega)[0]


# ---------------------------------------------------------------------------
# Tiled PCG, late-linearised flow pair (mirrors krylov._flow_pcg)
# ---------------------------------------------------------------------------


def _nbr(xp, ww, wn, we, ws):
    """Σ w x over the 4 neighbours, from a tile ``xp`` with a 1-px halo."""
    return (ww * xp[..., 1:-1, :-2] + wn * xp[..., :-2, 1:-1] + we * xp[..., 1:-1, 2:]
            + ws * xp[..., 2:, 1:-1])


class _PcgTile:
    """One tile's part of the tiled PCG: its coefficients, on its device."""

    def __init__(self, ti, tj, nty, ntx, m, cu, cv, duc, dvc, ww, wn, we, ws):
        # weights zeroed on the GLOBAL image edges only: tile-interior edges
        # keep theirs, the neighbours' values arrive through the halo
        if tj == 0:
            ww = _edge_zero(ww, -1, "first")
        if tj == ntx - 1:
            we = _edge_zero(we, -1, "last")
        if ti == 0:
            wn = _edge_zero(wn, -2, "first")
        if ti == nty - 1:
            ws = _edge_zero(ws, -2, "last")
        self.w4 = (ww, wn, we, ws)
        self.wsum = ww + wn + we + ws
        valid_u, valid_v = ~torch.isnan(cu), ~torch.isnan(cv)
        self.d_u = torch.where(valid_u, torch.nan_to_num(duc), 0.0)
        self.d_v = torch.where(valid_v, torch.nan_to_num(dvc), 0.0)
        self.m_eff = torch.where(valid_u & valid_v, torch.nan_to_num(m), 0.0)
        self.diag_u = self.wsum + self.d_u
        self.diag_v = self.wsum + self.d_v
        self.c_u = torch.where(valid_u, torch.nan_to_num(cu), 0.0)
        self.c_v = torch.where(valid_v, torch.nan_to_num(cv), 0.0)
        # the line systems stop at the tile's edges (additive Schwarz; the
        # per-tile edge zeroing keeps the preconditioner SPD)
        self.wl = (_edge_zero(ww, -1, "first"), _edge_zero(wn, -2, "first"),
                   _edge_zero(we, -1, "last"), _edge_zero(ws, -2, "last"))
        h, w = m.shape[-2:]
        self.col_par = torch.arange(w, device=m.device)[None, :] % 2
        self.row_par = (torch.arange(h, device=m.device) % 2)[:, None]

    def rhs(self, up, vp, u, v):
        """b = Σ w (f_nbr − f_c) + the NaN-folded data term, u and v given
        with a 1-px halo (up, vp) and without."""
        return ((_nbr(up, *self.w4) - self.wsum * u) + self.c_u,
                (_nbr(vp, *self.w4) - self.wsum * v) + self.c_v)

    def apply_a(self, xup, xvp, xu, xv):
        return (self.diag_u * xu - _nbr(xup, *self.w4) + self.m_eff * xv,
                self.diag_v * xv - _nbr(xvp, *self.w4) + self.m_eff * xu)

    def _line_pass(self, z, rhs, diag, parity: int, vertical: bool):
        ww_t, wn_t, we_t, ws_t = self.wl
        if vertical:
            d = rhs + ww_t * F.pad(z, (1, 0))[:, :-1] + we_t * F.pad(z, (0, 1))[:, 1:]
            sol = dispatch.thomas_solve(-wn_t, diag, -ws_t, d, -2)
            sel = self.col_par == parity
        else:
            d = rhs + wn_t * F.pad(z, (0, 0, 1, 0))[:-1, :] + ws_t * F.pad(z, (0, 0, 0, 1))[1:, :]
            sol = dispatch.thomas_solve(-ww_t, diag, -we_t, d, -1)
            sel = self.row_par == parity
        return torch.where(sel, sol, z)

    def precond(self, ru, rv):
        """The tile-local symmetrised zebra-ADI pass from a zero guess."""
        zu, zv = torch.zeros_like(ru), torch.zeros_like(rv)
        steps = [(0, p, True) for p in (0, 1)] + [(1, p, True) for p in (0, 1)]
        steps += [(0, p, False) for p in (0, 1)] + [(1, p, False) for p in (0, 1)]
        for k, p, vert in steps + list(reversed(steps)):
            if k == 0:
                zu = self._line_pass(zu, ru - self.m_eff * zv, self.diag_u, p, vert)
            else:
                zv = self._line_pass(zv, rv - self.m_eff * zu, self.diag_v, p, vert)
        return zu, zv


def _split(grid):
    """A grid of (u, v) pairs as the grid of u and the grid of v."""
    return _grid_map(lambda q: q[0], grid), _grid_map(lambda q: q[1], grid)


def _pdot(xs, ys, device):
    """Σ x·y over the pair of fields and every tile: each tile's dot
    product on its device, then summed on ``device`` over ty, then over tx
    (``pde_tpu``'s psum order). ``xs``, ``ys``: (grid of u, grid of v)."""
    local = _grid_map(lambda xu, xv, yu, yv: (
        torch.vdot(xu.reshape(-1), yu.reshape(-1))
        + torch.vdot(xv.reshape(-1), yv.reshape(-1))).to(device), *xs, *ys)
    total = None
    for j in range(len(local[0])):
        col = local[0][j]
        for i in range(1, len(local)):
            col = col + local[i][j]
        total = col if total is None else total + col
    return total


def tiled_pcg_flow_llin4(mesh: Mesh, u, v, du, dv, m, cu, cv, duc, dvc, ww, wn, we, ws,
                         iters: int, omega: float = 1.9):
    """Tiled drop-in for ``pcg_flow_llin4`` over a ("ty", "tx") mesh: the
    same fixed point, a tile-local line preconditioner. Returns (dU, dV),
    whole, on the device of ``u``."""
    del omega
    nty, ntx = mesh.shape["ty"], mesh.shape["tx"]
    t = [shard(x, mesh) for x in (u, v, du, dv, m, cu, cv, duc, dvc, ww, wn, we, ws)]
    sys = [[_PcgTile(i, j, nty, ntx, *(f[i][j] for f in t[4:])) for j in range(ntx)]
           for i in range(nty)]
    sc = mesh.device  # the CG scalars

    def apply_a(xu, xv):
        return _split(_grid_map(_PcgTile.apply_a, sys, halo_exchange(xu, 1),
                                halo_exchange(xv, 1), xu, xv))

    def precond(ru, rv):
        return _split(_grid_map(_PcgTile.precond, sys, ru, rv))

    def axpy(alpha, xs, ys):
        return tuple(_grid_map(lambda x, y: x + alpha.to(x.device) * y, a, b)
                     for a, b in zip(xs, ys))

    b = _split(_grid_map(_PcgTile.rhs, sys, halo_exchange(t[0], 1), halo_exchange(t[1], 1),
                         t[0], t[1]))
    x = (t[2], t[3])
    r = tuple(_grid_map(torch.sub, bb, aa) for bb, aa in zip(b, apply_a(*x)))
    p = precond(*r)
    rz = _pdot(r, p, sc)
    for _ in range(iters):
        ap = apply_a(*p)
        pap = _pdot(p, ap, sc)
        alpha = torch.where(pap > 0, rz / torch.where(pap == 0, 1.0, pap), 0.0)
        x = axpy(alpha, x, p)
        r = axpy(-alpha, r, ap)
        z = precond(*r)
        rz_new = _pdot(r, z, sc)
        beta = torch.where(rz > 0, rz_new / torch.where(rz == 0, 1.0, rz), 0.0)
        p = axpy(beta, z, p)
        rz = rz_new
    return unshard(x[0], u.device), unshard(x[1], u.device)
