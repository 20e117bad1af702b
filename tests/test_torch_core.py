"""Parity of ``pde_tpu_torch.core`` (and the package's import hygiene)
with ``pde_tpu.core`` on the same seeded inputs.

Per op the bound is max-abs <= 1e-5 on unit-scale fields; the ops that
only move or select values (shifts, median) must agree exactly.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pde_tpu import config as jconfig
from pde_tpu.core import conv as jconv
from pde_tpu.core import grid as jgrid
from pde_tpu.core import median as jmedian
from pde_tpu.core import pyramid as jpyramid
from pde_tpu.core import resize as jresize
from pde_tpu.ops.derivatives import FST_DERIVATOR5
from pde_tpu_torch import config
from pde_tpu_torch.core import conv, grid, median, pyramid, resize

torch.set_num_threads(1)

ATOL = 1e-5
REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "pde_tpu_torch"


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def _close(got, want, atol=ATOL):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("name", ["shift_w", "shift_e", "shift_n", "shift_s",
                                  "replicate_border"])
def test_grid_moves_match_exactly(rng, name):
    x = rng.random((2, 7, 9)).astype(np.float32)
    got = getattr(grid, name)(_t(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(getattr(jgrid, name)(jnp.asarray(x))))


def test_grid_masks_match():
    for parity in (0, 1):
        np.testing.assert_array_equal(grid.checkerboard(5, 6, parity).numpy(),
                                      np.asarray(jgrid.checkerboard(5, 6, parity)))
    np.testing.assert_array_equal(grid.interior_mask(5, 6).numpy(),
                                  np.asarray(jgrid.interior_mask(5, 6)))


KERNELS = {
    "gauss5x5": jconv.gaussian_kernel_2d(5, 1.25),
    "row_deriv": FST_DERIVATOR5[None, :],
    "col_deriv": FST_DERIVATOR5[:, None],
    "grad_1d": np.array([1.0, 0.0, -1.0], np.float32),
    "cdiff_col": np.array([[0.25], [0.0], [-0.25]], np.float32),
}


@pytest.mark.parametrize("kname", sorted(KERNELS))
def test_imfilter_replicate_matches(rng, kname):
    x = rng.random((3, 17, 23)).astype(np.float32)
    k = KERNELS[kname]
    _close(conv.imfilter_replicate(_t(x), k), jconv.imfilter_replicate(jnp.asarray(x), k))


@pytest.mark.parametrize("kname", ["row_deriv", "col_deriv", "grad_1d"])
def test_imfilter_nan_at_zero_centre_tap_stays_local(rng, kname):
    """A NaN under a zero centre tap must not reach that pixel's output
    (conv2d would spread it): the NaN mask equals the JAX one."""
    x = rng.random((12, 14)).astype(np.float32)
    x[5, 6] = np.nan
    x[0, 0] = np.nan
    k = KERNELS[kname]
    got = conv.imfilter_replicate(_t(x), k)
    assert np.isfinite(got.numpy()[5, 6])
    _close(got, jconv.imfilter_replicate(jnp.asarray(x), k))


def test_separable_filter_and_gaussians_match(rng):
    x = rng.random((2, 19, 21)).astype(np.float32)
    kv = jconv.gaussian_kernel_1d(5, 1.0)
    kh = FST_DERIVATOR5
    _close(conv.separable_filter(_t(x), kv, kh),
           jconv.separable_filter(jnp.asarray(x), kv, kh))
    _close(conv.separable_filter(_t(x), None, kh),
           jconv.separable_filter(jnp.asarray(x), None, kh))
    np.testing.assert_array_equal(conv.gaussian_kernel_2d(5, 1.25),
                                  jconv.gaussian_kernel_2d(5, 1.25))
    np.testing.assert_array_equal(conv.gaussian_kernel_1d(7, 2.0),
                                  jconv.gaussian_kernel_1d(7, 2.0))


@pytest.mark.parametrize("shape,out,method", [
    ((37, 53), (28, 40), "bilinear"),       # pyramid downscale (antialiased)
    ((3, 28, 40), (37, 53), "triangle"),    # flow upscale, leading channel dim
    ((20, 27), (41, 13), "bilinear"),       # up along H, down along W
])
def test_imresize_matches(rng, shape, out, method):
    x = rng.random(shape).astype(np.float32)
    _close(resize.imresize(_t(x), out, method), jresize.imresize(jnp.asarray(x), out, method))


def test_imresize_scale_and_matrix_match(rng):
    x = rng.random((2, 36, 44)).astype(np.float32)
    _close(resize.imresize_scale(_t(x), 0.75), jresize.imresize_scale(jnp.asarray(x), 0.75))
    for n_in, n_out in [(44, 33), (33, 44), (7, 7)]:
        for kernel in ("triangle", "cubic"):
            np.testing.assert_array_equal(resize.resize_matrix(n_in, n_out, kernel=kernel),
                                          jresize.resize_matrix(n_in, n_out, kernel=kernel))


def test_imresize_rejects_unported_method(rng):
    """Every method of pde_tpu is ported: 'bicubic' (flow_hs's upscale,
    antialiased on downscale) matches it, and any other name takes the
    triangle kernel there and here alike."""
    for shape, out in (((3, 21, 24), (28, 32)), ((28, 32), (21, 17))):
        x = rng.random(shape).astype(np.float32)
        _close(resize.imresize(_t(x), out, "bicubic"),
               jresize.imresize(jnp.asarray(x), out, "bicubic"))
    x = rng.random((8, 8)).astype(np.float32)
    _close(resize.imresize(_t(x), (4, 4), "nearest"),
           jresize.imresize(jnp.asarray(x), (4, 4), "nearest"))


def test_pyramid_matches(rng):
    a = (rng.random((3, 36, 44)) * 255).astype(np.float32)
    b = (rng.random((3, 36, 44)) * 255).astype(np.float32)
    assert pyramid.pyramid_scales(480, 640, 0.75, 20) == jpyramid.pyramid_scales(480, 640, 0.75, 20)
    got = pyramid.build_pyramid([_t(a) / 255.0, _t(b) / 255.0], 0.75, 20)
    want = jpyramid.build_pyramid([jnp.asarray(a) / 255.0, jnp.asarray(b) / 255.0], 0.75, 20)
    assert len(got) == len(want) == len(pyramid.pyramid_scales(36, 44, 0.75, 20))
    for lg, lw in zip(got, want):
        for g, w_ in zip(lg, lw):
            _close(g, w_)


def test_medfilt2_symmetric_borders_match_exactly(rng):
    """'symmetric' repeats the edge pixel; outliers on the border rows and
    columns make any other padding visible."""
    x = rng.random((2, 9, 11)).astype(np.float32)
    x[:, 0, ::2] = 5.0
    x[:, ::3, -1] = -5.0
    got = median.medfilt2_3x3(_t(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmedian.medfilt2_3x3(jnp.asarray(x))))


def test_with_overrides_rejects_unknown_like_reference():
    from pde_tpu.models.flow_nd import FlowNDParams as JParams
    from pde_tpu_torch.models.flow_nd import FlowNDParams

    assert config.with_overrides(FlowNDParams(), iter=7).iter == 7
    for with_overrides, cfg in ((config.with_overrides, FlowNDParams()),
                                (jconfig.with_overrides, JParams())):
        with pytest.raises(TypeError, match="bogus"):
            with_overrides(cfg, bogus=1)


def test_package_sources_import_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|pde_tpu)(\s|\.|$)", re.M)
    for path in PKG.rglob("*.py"):
        assert not pat.search(path.read_text()), path


def test_import_pulls_no_jax_and_builds_nothing():
    build_dir = PKG / "_build"
    before = sorted(os.listdir(build_dir)) if build_dir.exists() else None
    code = ("import sys, pde_tpu_torch, pde_tpu_torch.kernels.build, "
            "pde_tpu_torch.kernels.sor_cuda, pde_tpu_torch.kernels.dispatch, "
            "pde_tpu_torch.kernels.tdma_cuda, pde_tpu_torch.models.flow_nd, "
            "pde_tpu_torch.models.flow_hs, pde_tpu_torch.models.diffusion, "
            "pde_tpu_torch.models.flow_fmg, pde_tpu_torch.models.gac, "
            "pde_tpu_torch.parallel, pde_tpu_torch.parallel.tiled, "
            "pde_tpu_torch.parallel.model; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'pde_tpu.'))"
            " or m == 'pde_tpu']; "
            "assert not bad, bad; print('ok')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
    after = sorted(os.listdir(build_dir)) if build_dir.exists() else None
    assert after == before
