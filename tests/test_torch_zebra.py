"""The fused zebra-ADI pass of the port (``solvers/tdma.py::zebra_pass``,
``kernels/dispatch.py::zebra_pass``), the plain version of the CUDA entry
``tridiag_zebra_pass`` (``csrc/tridiag.cu``).

The plain pass must give exactly the floats of the composition the PCG
preconditioner ran before it was fused (shifts, products, ``line_solve``,
``scatter_lines``), for both directions and parities, the scalar, coupled
and 8-neighbour forms, channels over shared weights and a per-member
batch, degenerate shapes and junk corner coefficients; it is held against
``pde_tpu``'s own composition at float32 rounding. Also: the line plan fits
its shared memory, the wrapper's checks, and that the CPU path builds
nothing. The kernel itself runs only on the card: ``chip_smoke.py`` holds
it against this plain version bit for bit there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_tpu.core import grid as jgrid
from pde_tpu.solvers import tdma as jtdma
from pde_tpu_torch.core.grid import shift_e, shift_n, shift_s, shift_w
from pde_tpu_torch.kernels import build, dispatch, tdma_cuda
from pde_tpu_torch.solvers import krylov, tdma

torch.set_num_threads(1)

JAX_TOL = 1e-6  # the same operations in the same order: float32 rounding only

# (field shape, shared weights): degenerate lines, an odd count of each
# parity, pcg_pde4/8's channels over one (H, W) plane, disparity_sym's pair
SHAPES = [((1, 7), False), ((7, 1), False), ((2, 3), False), ((33, 7), False),
          ((3, 12, 9), True), ((2, 11, 10), False)]
FORMS = ["scalar", "coupled", "8 neighbours", "coupled, 8 neighbours"]


def _system(rng, shape, shared):
    """Diagonally dominant line coefficients (a, b, c) of both directions'
    lines and the pass's fields, float32; weights (and m) one (H, W) plane
    when ``shared``."""
    plane = shape[-2:] if shared else shape

    def r(shp, lo, hi):
        return (rng.random(shp) * (hi - lo) + lo).astype(np.float32)

    a, c = r(plane, -0.5, -0.1), r(plane, -0.5, -0.1)
    b = (np.abs(a) + np.abs(c) + r(shape, 0.5, 1.5)).astype(np.float32)
    return dict(a=a, b=b, c=c, z=r(shape, -1, 1), rhs=r(shape, -1, 1), z_o=r(shape, -1, 1),
                m=r(plane, 0, 0.01), w_lo=r(plane, 0.1, 1.1), w_hi=r(plane, 0.1, 1.1),
                w_diag=tuple(r(plane, -0.15, 0.15) for _ in range(4)))


def _torch(f):
    return {k: tuple(map(torch.from_numpy, v)) if isinstance(v, tuple) else torch.from_numpy(v)
            for k, v in f.items()}


def _form_args(t, form):
    coupled, diag = "coupled" in form, "8 neighbours" in form
    return dict(z_o=t["z_o"] if coupled else None, m=t["m"] if coupled else None,
                w_diag=t["w_diag"] if diag else None)


def _composed(facs, z, rhs, w_lo, w_hi, parity, vertical, z_o=None, m=None, w_diag=None):
    """The preconditioner pass as the PCG ran it before the fusion: the
    RHS in eager ops, the parity line solve, the scatter."""
    rhs_k = rhs if z_o is None else rhs - m * z_o
    if vertical:
        d = rhs_k + w_lo * shift_w(z) + w_hi * shift_e(z)
    else:
        d = rhs_k + w_lo * shift_n(z) + w_hi * shift_s(z)
    if w_diag is not None:
        wnw, wne, wse, wsw = w_diag
        d = d + (wnw * shift_n(shift_w(z)) + wne * shift_n(shift_e(z))
                 + wse * shift_s(shift_e(z)) + wsw * shift_s(shift_w(z)))
    sol = tdma.line_solve(facs, d, parity, vertical)
    return tdma.scatter_lines(z, sol, parity, vertical)


def _jax_pass(f, parity, vertical, form):
    """pde_tpu's pass (krylov._zebra_adi's ``pas``) on the same fields."""
    j = {k: tuple(map(jnp.asarray, v)) if isinstance(v, tuple) else jnp.asarray(v)
         for k, v in f.items()}
    facs = jtdma.line_factors(j["a"], j["b"], j["c"], vertical)
    rhs = j["rhs"] - j["m"] * j["z_o"] if "coupled" in form else j["rhs"]
    z = j["z"]
    extra = 0.0
    if "8 neighbours" in form:
        wnw, wne, wse, wsw = j["w_diag"]
        extra = (wnw * jgrid.shift_n(jgrid.shift_w(z)) + wne * jgrid.shift_n(jgrid.shift_e(z))
                 + wse * jgrid.shift_s(jgrid.shift_e(z)) + wsw * jgrid.shift_s(jgrid.shift_w(z)))
    if vertical:
        d = rhs + j["w_lo"] * jgrid.shift_w(z) + j["w_hi"] * jgrid.shift_e(z) + extra
    else:
        d = rhs + j["w_lo"] * jgrid.shift_n(z) + j["w_hi"] * jgrid.shift_s(z) + extra
    return jtdma.scatter_lines(z, jtdma.line_solve(facs, d, parity, vertical), parity, vertical)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("shape,shared", SHAPES)
def test_plain_pass_equals_the_unfused_composition(rng, shape, shared, form):
    """Both directions and parities: the plain pass and the CPU dispatch
    give the composition's bits; the input z is not written."""
    t = _torch(_system(rng, shape, shared))
    for vertical in (True, False):
        facs = tdma.line_factors(t["a"], t["b"], t["c"], vertical)
        for parity in (0, 1):
            z_before = t["z"].clone()
            args = (t["z"], t["rhs"], t["w_lo"], t["w_hi"], parity, vertical)
            want = _composed(facs, *args, **_form_args(t, form))
            got = tdma.zebra_pass(facs, *args, **_form_args(t, form))
            via = dispatch.zebra_pass(dispatch.line_factors(t["a"], t["b"], t["c"], vertical),
                                      *args, **_form_args(t, form))
            assert got.shape == want.shape == tuple(shape)
            assert torch.equal(got, want) and torch.equal(via, want)
            assert torch.equal(t["z"], z_before)


@pytest.mark.parametrize("form", FORMS)
def test_plain_pass_ignores_junk_corners(rng, form):
    """inf in a[0] and c[L-1] of every line of the solved direction: the
    pass ignores them (the factor zeroes them, as the kernel does), so it
    equals the pass with zero corners and stays finite."""
    f = _system(rng, (9, 8), False)
    t = _torch(f)
    for vertical in (True, False):
        a_junk, c_junk, a_zero, c_zero = f["a"].copy(), f["c"].copy(), f["a"].copy(), f["c"].copy()
        first, last = ((0, slice(None)), (-1, slice(None))) if vertical else \
            ((slice(None), 0), (slice(None), -1))
        a_junk[first], c_junk[last] = np.inf, np.inf
        a_zero[first], c_zero[last] = 0.0, 0.0
        facs_junk = tdma.line_factors(torch.from_numpy(a_junk), t["b"],
                                      torch.from_numpy(c_junk), vertical)
        facs_zero = tdma.line_factors(torch.from_numpy(a_zero), t["b"],
                                      torch.from_numpy(c_zero), vertical)
        for parity in (0, 1):
            args = (t["z"], t["rhs"], t["w_lo"], t["w_hi"], parity, vertical)
            got = tdma.zebra_pass(facs_junk, *args, **_form_args(t, form))
            want = tdma.zebra_pass(facs_zero, *args, **_form_args(t, form))
            assert torch.isfinite(got).all() and torch.equal(got, want)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("vertical", [True, False])
def test_plain_pass_matches_reference(rng, vertical, form):
    """pde_tpu's pass on the same (3, H, W) fields over shared weights,
    both parities."""
    f = _system(rng, (3, 13, 10), True)
    t = _torch(f)
    facs = tdma.line_factors(t["a"], t["b"], t["c"], vertical)
    for parity in (0, 1):
        got = tdma.zebra_pass(facs, t["z"], t["rhs"], t["w_lo"], t["w_hi"], parity, vertical,
                              **_form_args(t, form))
        want = np.asarray(_jax_pass(f, parity, vertical, form))
        np.testing.assert_allclose(got.numpy(), want, atol=JAX_TOL, rtol=0)


def _zebra_adi_unfused(rhs, diags, facs, wz4s, n, w_diag=None, m=None):
    """krylov._zebra_adi as it ran before the fusion: eager RHS, the parity
    solve through dispatch.line_solve, the scatter."""
    z = tuple(torch.zeros_like(d) for d in diags)
    steps = [(k, p, True) for k in range(n) for p in (0, 1)]
    steps += [(k, p, False) for k in range(n) for p in (0, 1)]
    for k, p, vert in steps + steps[::-1]:
        ww, wn, we, ws = wz4s[k]
        r_k = rhs[k] if m is None else rhs[k] - m * z[1 - k]
        zk = z[k]
        if vert:
            d = r_k + ww * shift_w(zk) + we * shift_e(zk)
        else:
            d = r_k + wn * shift_n(zk) + ws * shift_s(zk)
        if w_diag is not None:
            d = d + krylov._nbr_diag(zk, *w_diag)
        sol = dispatch.line_solve(facs[k][0 if vert else 1], d, p, vert)
        z = z[:k] + (tdma.scatter_lines(zk, sol, p, vert),) + z[k + 1:]
    return z


@pytest.mark.parametrize("n,diag", [(1, False), (1, True), (2, False), (2, True)])
def test_zebra_adi_through_dispatch_equals_unfused(rng, n, diag):
    """The whole symmetrised preconditioner pass: scalar (n = 1) and the
    coupled flow pair (n = 2), with and without the diagonal flux, bit for
    bit against the unfused run."""
    shape = (17, 14)
    fs = [_torch(_system(rng, shape, False)) for _ in range(n)]
    # positive weights (W, N, E, S), each field's diagonal above their sum
    wz4s = [tuple(torch.from_numpy((rng.random(shape) * 0.4 + 0.1).astype(np.float32))
                  for _ in range(4)) for _ in range(n)]
    diags = [sum(w4) + f["b"] for w4, f in zip(wz4s, fs)]
    facs = krylov._zebra_factors(diags, wz4s)
    rhs = tuple(f["rhs"] for f in fs)
    w_diag = fs[0]["w_diag"] if diag else None
    m = fs[0]["m"] if n == 2 else None
    got = krylov._zebra_adi(rhs, diags, facs, wz4s, n, w_diag, m)
    want = _zebra_adi_unfused(rhs, diags, facs, wz4s, n, w_diag, m)
    assert len(got) == n
    for g, w_ in zip(got, want):
        assert torch.isfinite(g).all() and torch.equal(g, w_)


PLAN_CASES = [(h, w) for h, w in ((1, 7), (7, 1), (2, 3), (33, 7), (480, 640), (481, 641),
                                  (640, 480), (1024, 1024))]


@pytest.mark.parametrize("h,w", PLAN_CASES)
def test_line_plan_fits_shared_memory(h, w):
    """Every mode, both axes, every parity, the zebra pass's forms: the
    plan's block fits a block's shared memory, covers every line, and its
    bytes are the kernel's formula (tridiag.cu::smem_bytes_of)."""
    for vertical in (True, False):
        length, n_all = (h, w) if vertical else (w, h)
        for mode in tdma_cuda.MODES:
            for parity in ((0, 1) if mode == "zebra" else (None, 0, 1)):
                for coupled, diag in ((False, False), (True, False), (False, True), (True, True)):
                    if mode != "zebra" and (coupled or diag):
                        continue
                    pl = tdma_cuda.plan_lines(3, h, w, vertical, parity, mode, coupled, diag)
                    n_lines = len(range(0 if parity is None else parity, n_all,
                                        1 if parity is None else 2))
                    assert pl.smem_bytes <= tdma_cuda.MAX_SMEM
                    assert pl.g in (1, 2, 4, 8, 16, 32) and pl.r in (32, 64)
                    assert 2 <= pl.stages <= 4
                    assert pl.blocks * pl.g >= 3 * n_lines
                    n_tiles = {"thomas": 4, "factor": 3, "solve": 3}.get(
                        mode, 5 + 2 * coupled + 4 * diag)
                    # tile and window rows of R + 4 floats, resident rows of L
                    # rounded up to 4 mod 8 (16-byte accesses without bank
                    # conflicts)
                    window = (2 * pl.g + 1) * (pl.r + 4) if mode == "zebra" else 0
                    pitch = length + (4 - length) % 8
                    assert pitch >= length and pitch % 8 == 4
                    assert pl.smem_bytes == 4 * (2 * pl.g * pitch + pl.stages * (
                        n_tiles * pl.g * (pl.r + 4) + window))


def test_line_plan_refuses_what_the_kernel_does_not_take():
    # more blocks than a launch's grid holds (a line of any length is taken:
    # tests/test_torch_tdma.py)
    with pytest.raises(ValueError, match="does not take"):
        tdma_cuda.plan_lines(2**31, 100_000, 4, True, None, "thomas")
    with pytest.raises(ValueError, match="does not take"):
        tdma_cuda.plan_lines(1, 64, 64, True, 0, "solve", override=(3, 32, 2))
    with pytest.raises(ValueError, match="does not take"):
        tdma_cuda.plan_lines(1, 64, 64, True, 0, "solve", override=(2, 16, 2))
    with pytest.raises(ValueError, match="mode"):
        tdma_cuda.plan_lines(1, 64, 64, True, 0, "cr")


@pytest.fixture
def no_build(monkeypatch):
    """Any build or load of a CUDA source fails the test."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path and the wrapper's checks must build nothing")

    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "build", refuse)


def test_zebra_wrapper_rejects_what_the_kernel_does_not_take(rng, no_build):
    """CPU tensors, another dtype, a non-contiguous field, mismatched
    shapes, a half of the coupled pair, a bad parity: each raises before
    anything is built, and nothing counts as a launch."""
    t = _torch(_system(rng, (9, 12), False))
    fac = tdma_cuda.LineFactor(t["a"], t["a"], t["a"], (9, 12), True)
    before = dict(tdma_cuda.LAUNCHES)
    base = (fac, t["z"], t["rhs"], t["w_lo"], t["w_hi"], 0)
    with pytest.raises(ValueError, match="CUDA"):
        tdma_cuda.zebra_pass(*base)
    with pytest.raises(ValueError, match="float32"):
        tdma_cuda.zebra_pass(fac, t["z"].double(), *base[2:])
    with pytest.raises(ValueError, match="contiguous"):
        tdma_cuda.zebra_pass(fac, t["z"], t["rhs"].t().contiguous().t(), *base[3:])
    with pytest.raises(ValueError, match="shape"):
        tdma_cuda.zebra_pass(fac, t["z"], t["rhs"][:, :11].contiguous(), *base[3:])
    with pytest.raises(ValueError, match="full shape"):
        tdma_cuda.zebra_pass(fac, t["z"][None].expand(2, 9, 12).contiguous(), t["rhs"],
                             *base[3:])
    with pytest.raises(ValueError, match="together"):
        tdma_cuda.zebra_pass(*base, z_o=t["z_o"])
    with pytest.raises(ValueError, match="parity"):
        tdma_cuda.zebra_pass(*base[:5], 2)
    with pytest.raises(ValueError, match="4 diagonal"):
        tdma_cuda.zebra_pass(*base, w_diag=t["w_diag"][:3])
    with pytest.raises(ValueError, match="factor of the kernel"):
        tdma_cuda.zebra_pass(tdma.line_factors(t["a"], t["b"], t["c"], True), *base[1:])
    assert tdma_cuda.LAUNCHES == before


def test_cpu_path_builds_nothing(rng, no_build):
    """The models' CPU path (a coupled PCG solve through every zebra pass)
    builds and loads nothing and counts no launch."""
    before = dict(tdma_cuda.LAUNCHES)
    f = _system(rng, (12, 14), False)
    t = _torch(f)
    out = krylov.pcg_flow_elin4(t["z"], t["z_o"], t["m"], t["rhs"], t["rhs"], t["b"], t["b"],
                                t["w_lo"], t["w_hi"], t["w_lo"], t["w_hi"], 3, 1.9)
    assert all(torch.isfinite(o).all() for o in out)
    assert tdma_cuda.LAUNCHES == before
    assert tdma_cuda._lib.cache_info().currsize == 0
