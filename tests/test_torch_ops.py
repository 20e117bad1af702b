"""Parity of ``pde_tpu_torch.ops`` with ``pde_tpu.ops`` on the same seeded
inputs: derivatives, warps (NaN masks must be identical) and diffusion
weights. Per op the bound is max-abs <= 1e-5 on unit-scale fields.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pde_tpu.ops import derivatives as jder
from pde_tpu.ops import warp as jwarp
from pde_tpu.ops import weights as jweights
from pde_tpu_torch.ops import derivatives, warp, weights

torch.set_num_threads(1)

ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def _close(got, want, atol=ATOL, rtol=0.0):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _pair_with_holes(rng, shape=(3, 20, 24)):
    """Unit-scale image pair; the second frame carries NaN holes, as an
    out-of-image warp leaves them."""
    a = rng.random(shape).astype(np.float32)
    b = rng.random(shape).astype(np.float32)
    b[..., 0, 3] = np.nan
    b[..., 9, 11] = np.nan
    b[..., -1, -1] = np.nan
    return a, b


def test_fst_derivatives5_matches(rng):
    a, b = _pair_with_holes(rng)
    got = derivatives.fst_derivatives5(_t(a), _t(b))
    want = jder.fst_derivatives5(jnp.asarray(a), jnp.asarray(b))
    for g, w_ in zip(got, want):
        _close(g, w_)


def test_snd_derivatives5_matches(rng):
    a, b = _pair_with_holes(rng)
    got = derivatives.snd_derivatives5(_t(a), _t(b))
    want = jder.snd_derivatives5(jnp.asarray(a), jnp.asarray(b))
    for g, w_ in zip(got, want):
        _close(g, w_)


@pytest.mark.parametrize("shape", [(3, 20, 24), (20, 24)])
def test_rgb2grad_interleave_matches(rng, shape):
    x = rng.random(shape).astype(np.float32)
    x[..., 7, 8] = np.nan  # under the zero centre tap of [1 0 -1]
    got = derivatives.rgb2grad(_t(x))
    _close(got, jder.rgb2grad(jnp.asarray(x)))
    assert got.shape[0] == (2 * shape[0] if len(shape) == 3 else 2)


def test_identity_grid_matches():
    for g, w_ in zip(warp.identity_grid(5, 7), jwarp.identity_grid(5, 7)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


@pytest.mark.parametrize("shape", [(3, 18, 22), (18, 22)])
def test_warp_by_flow_nan_mask_and_values_match(rng, shape):
    """Flows up to 6 px push samples off every edge: the NaN masks must be
    identical and the values agree."""
    img = rng.random(shape).astype(np.float32)
    u = (rng.random(shape[-2:]) * 12.0 - 6.0).astype(np.float32)
    v = (rng.random(shape[-2:]) * 12.0 - 6.0).astype(np.float32)
    got = warp.warp_by_flow(_t(img), _t(u), _t(v))
    want = jwarp.warp_by_flow(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v))
    assert np.isnan(got.numpy()).any() and not np.isnan(got.numpy()).all()
    _close(got, want)


def test_bilinear_warp_edge_coordinates_match(rng):
    """Coordinates exactly on and just past the last cell, where the corner
    fetch clamps and floor(coord-1) decides validity."""
    img = rng.random((6, 8)).astype(np.float32)
    x = np.tile(np.array([0.999, 1.0, 4.5, 7.999, 8.0, 8.001, 9.0, -3.0], np.float32), (6, 1))
    y = np.tile(np.array([1.0, 2.5, 5.999, 6.0, 6.5, 0.5], np.float32)[:, None], (1, 8))
    _close(warp.bilinear_warp(_t(img), _t(x), _t(y)),
           jwarp.bilinear_warp(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y)))


def test_warp_window_matches(rng):
    img = rng.random((2, 16, 20)).astype(np.float32)
    u = (rng.random((16, 20)) * 10.0 - 5.0).astype(np.float32)
    v = (rng.random((16, 20)) * 10.0 - 5.0).astype(np.float32)
    got = warp.warp_window(_t(img), _t(u), _t(v), 3)
    _close(got, jwarp.warp_window(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v), 3))


@pytest.mark.parametrize("combine,zero_borders", [("sum", False), ("max", True)])
def test_diffusion_weights_4_matches(rng, combine, zero_borders):
    """Weights are 1/sqrt(.), not unit scale: held at 1e-5 relative."""
    f = (rng.random((2, 15, 19)) * 0.5).astype(np.float32)
    got = weights.diffusion_weights_4(_t(f), eps=1e-5, combine=combine,
                                      zero_borders=zero_borders)
    want = jweights.diffusion_weights_4(jnp.asarray(f), eps=1e-5, combine=combine,
                                        zero_borders=zero_borders)
    for g, w_ in zip(got, want):
        _close(g, w_, atol=ATOL, rtol=1e-5)


def _textured(rng, shape):
    """A smooth random texture with oblique edges (so the tensor's
    diagonal weights take both signs) and a flat patch (zero gradient)."""
    x = rng.random(shape).astype(np.float32)
    x = x + np.roll(x, 1, axis=-1) + np.roll(x, 1, axis=-2)
    x[..., 2:6, 3:8] = 0.5
    return x


@pytest.mark.parametrize("shape", [(14, 17), (3, 14, 17)])
@pytest.mark.parametrize("operator", ["alvarez", "sobel"])
@pytest.mark.parametrize("zero_borders", [False, True])
def test_tensor_diffusion_weights_8_matches(rng, shape, operator, zero_borders):
    f = _textured(rng, shape)
    got = weights.tensor_diffusion_weights_8(_t(f), quantile=0.9, operator=operator,
                                             zero_borders=zero_borders)
    want = jweights.tensor_diffusion_weights_8(jnp.asarray(f), quantile=0.9,
                                               operator=operator, zero_borders=zero_borders)
    assert len(got) == len(want) == 8
    for g, w_ in zip(got, want):
        _close(g, w_)
    assert float(torch.stack(got).min()) < 0.0  # oblique gradients: negative diagonals


def test_tensor_weights_channel_ties_take_the_first(rng):
    """Two channels with equal gradient norms of opposite sign: the first
    channel's gradient drives the tensor, as jnp.argmax's first maximum."""
    f = _textured(rng, (12, 13))
    pair = np.stack([f, -f])
    got = weights.tensor_diffusion_weights_8(_t(pair))
    want = jweights.tensor_diffusion_weights_8(jnp.asarray(pair))
    first = weights.tensor_diffusion_weights_8(_t(f))
    for g, w_, g1 in zip(got, want, first):
        _close(g, w_)
        np.testing.assert_array_equal(g.numpy(), g1.numpy())


def _quantile_cases():
    rng = np.random.default_rng(7)
    x = rng.random((37, 53)).astype(np.float32) ** 2
    sparse = x.copy()
    sparse[rng.random(x.shape) < 0.3] = 0.0
    ties = np.repeat(np.arange(1, 6, dtype=np.float32), 7)  # 35 entries, repeated values
    half = np.concatenate([np.zeros(3, np.float32), np.arange(1, 6, dtype=np.float32)])
    return [(x, 0.9), (sparse, 0.5), (ties, 0.9), (ties, 0.3),
            (half, 0.5),  # nz*q = 2.5 rounds half to even, to 2
            (half, 0.7),  # nz*q = 3.5 rounds to 4
            (np.zeros((6, 7), np.float32), 0.9)]  # nothing non-zero: 1.0


@pytest.mark.parametrize("x,q", _quantile_cases())
def test_quantile_nonzero_matches_exactly(x, q):
    got = weights._quantile_nonzero(_t(x), q)
    want = jweights._quantile_nonzero(jnp.asarray(x), q)
    assert got.ndim == 0 and got.dtype == torch.float32
    assert float(got) == float(want)
