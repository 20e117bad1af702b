"""The port's ``tv_denoise4`` and ``tv_denoise8`` held against
``pde_tpu``'s on a noisy 32x32 image, 2-D and 3-channel, at reduced
iteration counts: the partial pyramid, each level's lagged-diffusivity
solve from the same input, and the whole result; and ``tv_denoise4`` and
``tv_denoise8`` at reference defaults against the oracle goldens
``tests/golden/tv4_beanbags.npz`` and ``tv8_ctour.npz`` with the bounds of
``tests/test_golden.py``.

The bound is relative: where u == f the data weight PsiData is
1/sqrt(eps) ~ 6.7e7 (eps is float64's, added to a float32 square), so
TRACE and B reach ~1e8 there, and float32 rounding moves u by an amount
relative to the image's values.
"""

import dataclasses
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_tpu.core.resize import imresize as jimresize
from pde_tpu_torch.kernels import interior_cuda

jtv = importlib.import_module("pde_tpu.models.tv_denoise")
ttv = importlib.import_module("pde_tpu_torch.models.tv_denoise")

torch.set_num_threads(1)

REL_TOL = 1e-4  # max |Δu| over the input image's value range
ITERS = dict(outer_iter=2, inner_iter=3)
CPU = dict(device="cpu")


def _noisy(rng, channels=None):
    shape = (32, 32) if channels is None else (channels, 32, 32)
    clean = np.zeros(shape, dtype=np.float32)
    clean[..., 8:24, 8:24] = 1.0
    return clean + 0.2 * rng.standard_normal(shape).astype(np.float32)


def _rel_err(want, got, scale) -> float:
    want, got = np.asarray(want), got.numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / scale)


@pytest.mark.parametrize("channels", [None, 3])
def test_tv_denoise4_levels_match_reference(rng, channels):
    img = _noisy(rng, channels)
    scale = float(img.max() - img.min())
    p = ttv.TVDenoise4Params(**ITERS)
    x = img[None] if channels is None else img
    jlevels = jtv._partial_pyramid(jnp.asarray(x), p.scl, p.scl_factor, 7, 2.0)
    tlevels = ttv._partial_pyramid(torch.from_numpy(x), p.scl, p.scl_factor, 7, 2.0)
    assert len(jlevels) == len(tlevels) >= 3
    for lj, lt in zip(jlevels, tlevels):
        assert _rel_err(lj, lt, scale) <= REL_TOL
    # each level from the reference's input to it
    iout = jlevels[-1]
    for lvl in range(len(jlevels) - 1, -1, -1):
        want = jtv._tv4_level(iout, jlevels[lvl], p.alpha, p.omega, p.outer_iter,
                              p.inner_iter, p.solver)
        got = ttv._tv4_level(torch.from_numpy(np.array(iout)),
                             torch.from_numpy(np.array(jlevels[lvl])),
                             p.alpha, p.omega, p.outer_iter, p.inner_iter)
        assert _rel_err(want, got, scale) <= REL_TOL
        if lvl > 0:
            iout = jimresize(want, jlevels[lvl - 1].shape[-2:], "bilinear")
    want = np.asarray(jtv.tv_denoise4(img, **ITERS))
    out = ttv.tv_denoise4(img, **CPU, **ITERS)
    assert out.shape == img.shape and out.device.type == "cpu"
    assert _rel_err(want, out, scale) <= REL_TOL


def test_tv_denoise4_pcg_matches_reference(rng):
    """solver=2: pcg_pde4 over the three channels jointly, each level from
    the reference's input to it and the whole result; scl=0.75 keeps two
    levels (each a JAX compilation)."""
    img = _noisy(rng, 3)
    scale = float(img.max() - img.min())
    kw = dict(ITERS, solver=2, scl=0.75)
    p = ttv.TVDenoise4Params(**kw)
    jlevels = jtv._partial_pyramid(jnp.asarray(img), p.scl, p.scl_factor, 7, 2.0)
    assert len(jlevels) == 2
    iout = jlevels[-1]
    for lvl in (1, 0):
        want = jtv._tv4_level(iout, jlevels[lvl], p.alpha, p.omega, p.outer_iter,
                              p.inner_iter, p.solver)
        got = ttv._tv4_level(torch.from_numpy(np.array(iout)),
                             torch.from_numpy(np.array(jlevels[lvl])),
                             p.alpha, p.omega, p.outer_iter, p.inner_iter, p.solver)
        assert _rel_err(want, got, scale) <= REL_TOL
        iout = jimresize(want, jlevels[0].shape[-2:], "bilinear")
    want = np.asarray(jtv.tv_denoise4(img, **kw))
    assert _rel_err(want, ttv.tv_denoise4(img, **CPU, **kw), scale) <= REL_TOL


def test_tv_denoise4_suppresses_flat_noise_on_cpu_without_kernel(rng):
    """Default parameters, a CPU tensor in: noise in a flat region falls to
    under a fifth, as pde_tpu's own test asks at reduced counts."""
    img = _noisy(rng)
    before = dict(interior_cuda.LAUNCHES)
    out = ttv.tv_denoise4(torch.from_numpy(img))
    assert out.device.type == "cpu" and out.shape == (32, 32)
    flat = np.s_[2:7, 2:30]
    assert float(out[flat].std()) < 0.2 * float(img[flat].std())
    assert interior_cuda.LAUNCHES == before
    np.testing.assert_array_equal(ttv.tv_denoise4_fused(img, **CPU).numpy(), out.numpy())


def test_params_round_trip_with_reference():
    ref = jtv.TVDenoise4Params(alpha=3.0, inner_iter=2)
    port = ttv.params_from_reference(ref)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert jtv.TVDenoise4Params(**dataclasses.asdict(port)) == ref
    assert dataclasses.asdict(ttv.TVDenoise4Params()) == dataclasses.asdict(jtv.TVDenoise4Params())
    with pytest.raises(TypeError, match="bogus"):
        ttv.params_from_reference({"alpha": 0.1, "bogus": 2})


def test_unported_solver_and_numpy_without_device_raise(rng, monkeypatch):
    img = _noisy(rng)
    # solver 1 and 2 are ported; any other raises
    with pytest.raises(ValueError, match="solver=3"):
        ttv.tv_denoise4(img, solver=3, **CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttv.tv_denoise4(img)


ITERS8 = dict(outer_iter=2, inner_iter=3)
# the whole result, one outer iteration per level: the two pyramids'
# coarsest levels differ by an ulp (the resize products sum in another
# order), and the data weight's amplification grows that to 2e-6 of the
# range after one outer iteration, 3e-5 to 1.04e-4 after two and ~7e-3
# after three, as far apart as pde_tpu's own jitted and op-by-op runs are
# there (~1e-2)
WHOLE8 = dict(outer_iter=0, inner_iter=3)


@pytest.mark.parametrize("channels", [None, 3])
@pytest.mark.parametrize("solver", [1, 2])
def test_tv_denoise8_levels_match_reference(rng, channels, solver):
    """Both levels of the default partial pyramid (scl = 0.75), each from
    the reference's input to it, and the whole result (at WHOLE8), with the reference
    run op by op (``jax.disable_jit()``): its jitted level differs from its
    own op-by-op one by ~1e-3 of the range after two outer iterations
    (XLA's fused kernels round the 8-term stencil sums otherwise, and
    where u == f PsiData ~6.7e7 turns an ulp of u - f into a 1% change of
    the next data weight), while the port, each op rounded alone, agrees
    with the op-by-op reference to ~1e-7."""
    img = _noisy(rng, channels)
    scale = float(img.max() - img.min())
    kw = dict(ITERS8, solver=solver)
    p = ttv.TVDenoise8Params(**kw)
    x = img[None] if channels is None else img
    jlevels = jtv._partial_pyramid(jnp.asarray(x), p.scl, p.scl_factor, 5, 1.25,
                                   smooth_last=False)
    tlevels = ttv._partial_pyramid(torch.from_numpy(x), p.scl, p.scl_factor, 5, 1.25,
                                   smooth_last=False)
    assert len(jlevels) == len(tlevels) == 2
    for lj, lt in zip(jlevels, tlevels):
        assert _rel_err(lj, lt, scale) <= REL_TOL
    iout = jlevels[-1]
    for lvl in (1, 0):
        with jax.disable_jit():
            want = jtv._tv8_level(iout, jlevels[lvl], p.alpha, p.omega, p.quantile,
                                  p.outer_iter, p.inner_iter, p.solver, p.operator)
        got = ttv._tv8_level(torch.from_numpy(np.array(iout)),
                             torch.from_numpy(np.array(jlevels[lvl])), p.alpha, p.omega,
                             p.quantile, p.outer_iter, p.inner_iter, p.solver, p.operator)
        assert _rel_err(want, got, scale) <= REL_TOL
        iout = jimresize(want, jlevels[0].shape[-2:], "bilinear")
    kw = dict(WHOLE8, solver=solver)
    with jax.disable_jit():
        want = np.asarray(jtv.tv_denoise8(img, **kw))
    before = dict(interior_cuda.LAUNCHES)
    out = ttv.tv_denoise8(img, **CPU, **kw)
    assert interior_cuda.LAUNCHES == before
    assert out.shape == img.shape and out.device.type == "cpu"
    assert _rel_err(want, out, scale) <= REL_TOL


def test_tv_denoise4_matches_oracle_golden():
    """Reference defaults on the gray 96x128 crop of the beanbags image,
    against the literal oracle (TVdenoise4.m), within the bounds
    tests/test_golden.py holds pde_tpu to; a CPU tensor in, so the plain
    solver and no card (the gray case of the resident pde4 kernel's)."""
    g = np.load(Path(__file__).parent / "golden" / "tv4_beanbags.npz")
    out = ttv.tv_denoise4(torch.from_numpy(g["img"])).numpy()
    ref = g["out"]
    span = ref.max() - ref.min()
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert np.abs(out - ref).max() < 0.08 * span
    assert np.sqrt(np.mean((out - ref) ** 2)) < 0.02 * span


def test_tv_denoise8_matches_oracle_golden():
    """Reference defaults on the gray 96x128 crop of the denoising demo
    input, against the literal oracle (TVdenoise8.m), within the bounds
    tests/test_golden.py holds pde_tpu to; a CPU tensor in, so no card."""
    g = np.load(Path(__file__).parent / "golden" / "tv8_ctour.npz")
    out = ttv.tv_denoise8(torch.from_numpy(g["img"])).numpy()
    ref = g["out"]
    span = ref.max() - ref.min()
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert np.abs(out - ref).max() < 0.10 * span
    assert np.sqrt(np.mean((out - ref) ** 2)) < 0.02 * span
    np.testing.assert_array_equal(ttv.tv_denoise8_fused(g["img"], **CPU).numpy(), out)


def test_tv8_params_round_trip_with_reference():
    ref = jtv.TVDenoise8Params(alpha=300.0, quantile=0.6, operator="sobel")
    port = ttv.params8_from_reference(ref)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert jtv.TVDenoise8Params(**dataclasses.asdict(port)) == ref
    assert dataclasses.asdict(ttv.TVDenoise8Params()) == dataclasses.asdict(jtv.TVDenoise8Params())
    # each converter keeps its own defaults
    assert ttv.params_from_reference({}) == ttv.TVDenoise4Params()
    assert ttv.params8_from_reference({}) == ttv.TVDenoise8Params()
    with pytest.raises(TypeError, match="quantile"):
        ttv.params_from_reference({"quantile": 0.5})
    with pytest.raises(TypeError, match="bogus"):
        ttv.params8_from_reference({"alpha": 0.1, "bogus": 2})


def test_tv_denoise8_other_solver_and_numpy_without_device_raise(rng, monkeypatch):
    img = _noisy(rng)
    with pytest.raises(ValueError, match="solver=3"):
        ttv.tv_denoise8(img, solver=3, **CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in (ttv.tv_denoise8, ttv.tv_denoise8_fused):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(img)
