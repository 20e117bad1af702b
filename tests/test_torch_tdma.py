"""The plain tridiagonal solves and zebra ALR of the port
(``pde_tpu_torch/solvers/tdma.py``), the CUDA kernel's reference, held
against ``pde_tpu``'s: the Thomas scan, cyclic reduction, the Pallas CR
kernel in interpret mode, the parity-line helpers and every ``alr_*``
solver; and the dispatch and wrapper rules that can be checked without a
card.

The kernel itself runs only on the card: ``chip_smoke.py`` compares it with
the plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_tpu.kernels.tdma_pallas import tridiag_cr_pallas
from pde_tpu.solvers import tdma as jtdma
from pde_tpu_torch.kernels import build, dispatch, tdma_cuda
from pde_tpu_torch.solvers import tdma

torch.set_num_threads(1)

SCAN_TOL = 1e-6  # the same elimination in the same order: float32 rounding only
CR_TOL = 2e-5    # cyclic reduction vs Thomas: elimination-order noise (tdma.py:41-43)
PALLAS_TOL = 5e-5  # as tests/test_kernels.py holds the Pallas kernel against the scan
ALR_TOL = 1e-4   # per solver call (ROADMAP tolerances)
# tests/test_kernels.py's shapes: power-of-two and odd lengths, both axes,
# leading channels, a 1- and 2-long line
SHAPES = [((64, 80), -2), ((7, 130), -2), ((57, 257), -1), ((8, 128), -2),
          ((1024, 16), -2), ((3, 33, 40), -2), ((3, 33, 40), -1), ((1, 5), -2),
          ((2, 5), -2)]


def _tridiag(rng, shape):
    """A random diagonally dominant system, as tests/test_kernels.py's."""
    a = (rng.random(shape) * 0.4 - 0.5).astype(np.float32)
    c = (rng.random(shape) * 0.4 - 0.5).astype(np.float32)
    b = (np.abs(a) + np.abs(c) + rng.random(shape) + 0.5).astype(np.float32)
    d = (rng.random(shape) * 2.0 - 1.0).astype(np.float32)
    return a, b, c, d


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _close(got, want, tol):
    g, w_ = got.numpy(), np.asarray(want)
    assert g.shape == w_.shape and np.isfinite(g).all()
    np.testing.assert_allclose(g, w_, atol=tol, rtol=0)


@pytest.fixture(scope="module")
def systems():
    """Each shape's system and pde_tpu's scan solution of it, once."""
    rng = np.random.default_rng(7)
    out = {}
    for shape, axis in SHAPES:
        abcd = _tridiag(rng, shape)
        out[(shape, axis)] = abcd, np.asarray(
            jtdma.thomas_solve_scan(*(jnp.asarray(x) for x in abcd), axis=axis))
    return out


@pytest.mark.parametrize("shape,axis", SHAPES)
def test_plain_scan_and_factor_match_jax_scan(systems, shape, axis):
    (a, b, c, d), want = systems[(shape, axis)]
    a, b, c, d = _t(a, b, c, d)
    _close(tdma.thomas_solve_scan(a, b, c, d, axis), want, SCAN_TOL)
    fac = tdma.tridiag_factor(a, b, c, axis)
    _close(tdma.tridiag_solve(fac, d, axis), want, SCAN_TOL)
    # the CPU dispatch is the plain version, bit for bit
    got = dispatch.thomas_solve(a, b, c, d, axis)
    np.testing.assert_array_equal(got.numpy(), tdma.thomas_solve(a, b, c, d, axis).numpy())
    _close(got, want, SCAN_TOL)


@pytest.mark.parametrize("shape,axis", SHAPES)
def test_plain_cr_matches_scan(systems, shape, axis):
    (a, b, c, d), want = systems[(shape, axis)]
    a, b, c, d = _t(a, b, c, d)
    _close(tdma.thomas_solve_cr(a, b, c, d, axis), want, CR_TOL)
    fac = tdma.tridiag_factor(a, b, c, axis, method="cr")
    _close(tdma.tridiag_solve(fac, d, axis), want, CR_TOL)


def test_plain_cr_matches_jax_cr(systems):
    (a, b, c, d), _ = systems[((7, 130), -2)]
    want = jtdma.thomas_solve_cr(*(jnp.asarray(x) for x in (a, b, c, d)), axis=-2)
    _close(tdma.thomas_solve_cr(*_t(a, b, c, d), axis=-2), want, CR_TOL)


def test_plain_matches_pallas_cr_kernel_interpret(rng):
    """The VMEM-resident Pallas kernel (tdma_pallas._cr_kernel) in
    interpret mode, at a non-power-of-two height and an unaligned width."""
    h, w = 100, 140
    a = rng.standard_normal((h, w)).astype(np.float32) * 0.3
    c = rng.standard_normal((h, w)).astype(np.float32) * 0.3
    b = 2.0 + np.abs(a) + np.abs(c)
    d = rng.standard_normal((h, w)).astype(np.float32)
    want = tridiag_cr_pallas(*(jnp.asarray(x) for x in (a, b, c, d)), interpret=True)
    _close(dispatch.thomas_solve(*_t(a, b, c, d), axis=-2), want, PALLAS_TOL)


def test_junk_corner_coefficients_are_ignored(systems):
    """a[0] and c[-1] may hold anything (inf, NaN): the solve zeroes them,
    as tridiag_factor and the kernel do."""
    (a, b, c, d), want = systems[((64, 80), -2)]
    a_j, c_j = a.copy(), c.copy()
    a_j[0] = np.inf
    c_j[-1] = np.nan
    a_j, b, c_j, d = _t(a_j, b, c_j, d)
    _close(tdma.thomas_solve(a_j, b, c_j, d, -2), want, SCAN_TOL)
    _close(tdma.thomas_solve_cr(a_j, b, c_j, d, -2), want, CR_TOL)
    fac = tdma.tridiag_factor(a_j, b, c_j, -2)
    assert float(fac.a[0].abs().max()) == 0.0
    _close(tdma.tridiag_solve(fac, d, -2), want, SCAN_TOL)


@pytest.mark.parametrize("vertical", [True, False])
def test_parity_line_solves_match_reference(rng, vertical):
    """pcg_pde4's case: (H, W) off-diagonals shared by a (C, H, W)
    diagonal, an odd line count; each parity's lines against pde_tpu's,
    and bit for bit against the full solve's lines (lines are independent
    systems, so the per-line arithmetic is the same)."""
    a, b, c, d = _tridiag(rng, (3, 25, 31))
    a, c = a[0], c[0]
    jf = jtdma.line_factors(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), vertical)
    facs = dispatch.line_factors(*_t(a, b, c), vertical)
    full = tdma.thomas_solve(*_t(a, b, c, d), axis=-2 if vertical else -1)
    for parity in (0, 1):
        got = dispatch.line_solve(facs, _t(d)[0], parity, vertical)
        _close(got, jtdma.line_solve(jf, jnp.asarray(d), parity, vertical), SCAN_TOL)
        np.testing.assert_array_equal(
            got.numpy(), tdma.slice_lines(full, parity, vertical).numpy())
        z = torch.zeros(d.shape)
        back = tdma.scatter_lines(z, got, parity, vertical)
        np.testing.assert_array_equal(tdma.slice_lines(back, parity, vertical).numpy(),
                                      got.numpy())
        assert float(z.abs().max()) == 0.0  # scatter_lines copies


def _fields(rng, names, shape=(24, 30)):
    """Unit-scale solver fields as in tests/test_kernels.py, 5% NaN in Cu
    and Du (the missing-data sentinel)."""
    out = {}
    for n in names:
        if n in ("duc", "dvc", "trace"):
            out[n] = rng.random(shape) + 1.0
        elif n == "m":
            out[n] = rng.random(shape) * 0.01
        elif n in ("wnw", "wne", "wse", "wsw"):  # the tensor stencil's: both signs
            out[n] = rng.random(shape) * 0.3 - 0.15
        elif n.startswith("w"):
            out[n] = rng.random(shape) + 0.1
        else:
            out[n] = rng.random(shape) * 0.2
    for n in ("cu", "duc"):
        if n in out:
            out[n] = np.where(rng.random(shape) < 0.05, np.nan, out[n])
    if "trace" in out:
        out["trace"] = out["trace"] + sum(out[n] for n in ("ww", "wn", "we", "ws"))
        out["trace"] = np.where(rng.random(shape) < 0.05, np.nan, out["trace"])
    return [out[n].astype(np.float32) for n in names]


W4 = ("ww", "wn", "we", "ws")
W8 = ("ww", "wnw", "wn", "wne", "we", "wse", "ws", "wsw")
ALR_CASES = {
    "alr_flow_llin4": ("u", "v", "du", "dv", "m", "cu", "cv", "duc", "dvc") + W4,
    "alr_flow_elin4": ("u", "v", "m", "cu", "cv", "duc", "dvc") + W4,
    "alr_disp_llin4": ("u", "du", "cu", "duc") + W4,
    "alr_pde4": ("x", "trace", "b") + W4,
    "alr_flow_llin8": ("u", "v", "du", "dv", "m", "cu", "cv", "duc", "dvc") + W8,
    "alr_pde8": ("x", "trace", "b") + W8,
}


@pytest.mark.parametrize("name", sorted(ALR_CASES))
def test_alr_matches_reference(rng, name):
    f = _fields(rng, ALR_CASES[name])
    want = getattr(jtdma, name)(*(jnp.asarray(x) for x in f), 3, 1.9)
    got = getattr(tdma, name)(*_t(*f), 3, 1.9)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, w_ in zip(got, want):
        _close(g, w_, ALR_TOL)


def test_dispatch_cpu_is_plain_and_launches_nothing(rng):
    a, b, c, d = _t(*_tridiag(rng, (2, 9, 12)))
    before = dict(tdma_cuda.LAUNCHES)
    want = tdma.thomas_solve(a, b, c, d, -1)
    with dispatch.plain_solvers():
        fac = dispatch.tridiag_factor(a, b, c, -1)
        got = dispatch.tridiag_solve(fac, d, -1)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(
        dispatch.tridiag_solve(dispatch.tridiag_factor(a, b, c, -1), d, -1).numpy(),
        want.numpy())
    assert tdma_cuda.LAUNCHES == before


def test_cuda_wrapper_rejects_cpu_tensors_before_building(rng, monkeypatch):
    def no_build(name):
        raise AssertionError("the wrapper must check its inputs before it builds")

    monkeypatch.setattr(build, "load", no_build)
    a, b, c, d = _t(*_tridiag(rng, (9, 12)))
    before = dict(tdma_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        tdma_cuda.thomas_solve(a, b, c, d)
    with pytest.raises(ValueError, match="CUDA"):
        tdma_cuda.tridiag_factor(a, b, c)
    with pytest.raises(ValueError, match="factor of the kernel"):
        tdma_cuda.tridiag_solve(tdma.tridiag_factor(a, b, c), d)
    with pytest.raises(ValueError, match="axis"):
        tdma_cuda._vertical(0, 3)
    assert tdma_cuda.LAUNCHES == before


def test_library_name_follows_source_hash():
    path = build.library_path(tdma_cuda.SOURCE)
    assert path.parent == build.BUILD_DIR and path.name.startswith("libtridiag_")
    assert (build.CSRC / f"{tdma_cuda.SOURCE}.cu").is_file()


@pytest.mark.parametrize("fn", ["thomas_solve", "tridiag_factor"])
def test_cuda_wrappers_check_fields_before_building(rng, monkeypatch, fn):
    """Another dtype, a non-contiguous field or a mismatched shape raises
    before anything is built, for the whole solve and the factor."""
    def no_build(name):
        raise AssertionError("the wrapper must check its inputs before it builds")

    monkeypatch.setattr(build, "load", no_build)
    a, b, c, d = _t(*_tridiag(rng, (9, 12)))
    call = getattr(tdma_cuda, fn)
    rest = (d,) if fn == "thomas_solve" else ()
    before = dict(tdma_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="float32"):
        call(a.double(), b, c, *rest)
    with pytest.raises(ValueError, match="contiguous"):
        call(a, b.t().contiguous().t(), c, *rest)
    with pytest.raises(ValueError, match="shape"):
        call(a, b[:, :11].contiguous(), c, *rest)
    assert tdma_cuda.LAUNCHES == before


# the line plan's variant: lines whose forward results do not fit in a
# block's shared memory at G = 1 (the longest staged line is ~28,000
# elements) take the global-rows variant, from the shape alone
ZEBRA_FORMS = [(False, False), (True, False), (False, True), (True, True)]


@pytest.mark.parametrize("length", [641, 28_000, 30_000, 65_536, 100_000])
@pytest.mark.parametrize("vertical", [True, False])
def test_line_plan_takes_any_length(length, vertical):
    h, w = (length, 3) if vertical else (3, length)
    for mode in tdma_cuda.MODES:
        for parity in ((0, 1) if mode == "zebra" else (None, 0)):
            for coupled, diag in (ZEBRA_FORMS if mode == "zebra" else [(False, False)]):
                pl = tdma_cuda.plan_lines(2, h, w, vertical, parity, mode, coupled, diag)
                staged_g1 = tdma_cuda.smem_bytes(mode, length, 1, pl.r, pl.stages, coupled,
                                                 diag)
                assert pl.global_rows == (staged_g1 > tdma_cuda.MAX_SMEM)
                assert pl.global_rows == (length >= 30_000)
                assert pl.smem_bytes == tdma_cuda.smem_bytes(
                    mode, length, pl.g, pl.r, pl.stages, coupled, diag, pl.global_rows)
                assert pl.smem_bytes <= tdma_cuda.MAX_SMEM
                n_lines = 3 if parity is None else len(range(parity, 3, 2))
                assert pl.blocks * pl.g >= 2 * n_lines
                if pl.global_rows:
                    # no resident rows in shared memory; cp staged as a tile
                    # by solve and zebra
                    tiles = {"thomas": 4, "factor": 3, "solve": 4}.get(
                        mode, 6 + 2 * coupled + 4 * diag)
                    window = (2 * pl.g + 1) * (pl.r + 4) if mode == "zebra" else 0
                    assert pl.smem_bytes == 4 * pl.stages * (tiles * pl.g * (pl.r + 4)
                                                             + window)
                    assert pl.g == tdma_cuda.GROUP[mode]


def test_line_plan_override_keeps_the_shapes_variant():
    """A (g, r, stages) override (the plan sweep's) leaves the variant to the
    shape: a long line stays in the global-rows one, a short line staged."""
    pl = tdma_cuda.plan_lines(1, 30_000, 4, True, None, "thomas", override=(1, 64, 2))
    assert pl.global_rows and pl.g == 1 and pl.smem_bytes == 4 * 2 * 4 * 1 * 68
    assert not tdma_cuda.plan_lines(1, 64, 4, True, None, "thomas", override=(4, 64, 2)).global_rows


def test_line_plan_takes_a_batch_over_65535():
    """The batch is folded into the grid's x: 70,000 systems of short lines
    plan as one launch, in every mode."""
    for mode in tdma_cuda.MODES:
        pl = tdma_cuda.plan_lines(70_000, 3, 5, True, 0 if mode == "zebra" else None, mode)
        n_lines = 3 if mode == "zebra" else 5
        assert not pl.global_rows and pl.blocks == 70_000 * -(-n_lines // pl.g)
    with pytest.raises(ValueError, match="does not take"):
        tdma_cuda.plan_lines(2**31, 3, 5, True, None, "thomas")


def test_row_scratch_holds_two_rows_a_line():
    pl = tdma_cuda.plan_lines(2, 30_000, 5, True, 1, "solve")
    rows = tdma_cuda.row_scratch(pl, 2, 2, 30_000, "cpu")
    pitch = tdma_cuda.row_pitch(30_000)
    assert pitch >= 30_000 and pitch % 8 == 4
    assert rows.dtype == torch.float32 and rows.numel() == 2 * 2 * 2 * pitch
    assert tdma_cuda.row_scratch(tdma_cuda.plan_lines(2, 64, 5, True, 1, "solve"), 2, 2, 64,
                                 "cpu") is None


@pytest.mark.parametrize("axis", [-2, -1])
def test_long_line_plain_solve_matches_reference(rng, monkeypatch, axis):
    """The CPU path solves a line longer than the staged kernel holds, as
    ``pde_tpu``'s ``thomas_solve`` does; the kernel's wrapper refuses the
    CPU tensors before it builds anything."""
    def no_build(name):
        raise AssertionError("the wrapper must check its inputs before it builds")

    monkeypatch.setattr(build, "load", no_build)
    shape = (30_000, 2) if axis == -2 else (2, 30_000)
    a, b, c, d = _tridiag(rng, shape)
    want = np.asarray(jtdma.thomas_solve(*(jnp.asarray(x) for x in (a, b, c, d)), axis=axis))
    before = dict(tdma_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        tdma_cuda.thomas_solve(*_t(a, b, c, d), axis)
    with pytest.raises(ValueError, match="CUDA"):
        tdma_cuda.tridiag_factor(*_t(a, b, c), axis)
    assert tdma_cuda.LAUNCHES == before
    got = dispatch.thomas_solve(*_t(a, b, c, d), axis)
    _close(got, want, SCAN_TOL)
