"""The port's level-set pieces held against ``pde_tpu``'s: the
reinitialisation (``solvers/reinit.py``: ``blurred_sign``,
``godunov_upwind_sq``, ``reinit``, ``reinit_t``), the AOS steps
(``solvers/aos.py``: ``cv_aos_step``, ``ac_aos_step``, whose line solves go
through ``kernels/dispatch.thomas_solve``) and the geodesic active contours
(``models/gac.py``: ``gac_a``, ``gac_b`` and their stopping function).

Bounds: max |Δ| <= 1e-5 of the range for the reinitialisation and the AOS
steps (per op), <= 1e-4 of φ's range for every ``collect_every`` chunk of
an evolution (per solver call, ROADMAP tolerances).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from pde_tpu_torch.kernels import tdma_cuda

jreinit = importlib.import_module("pde_tpu.solvers.reinit")
treinit = importlib.import_module("pde_tpu_torch.solvers.reinit")
jaos = importlib.import_module("pde_tpu.solvers.aos")
taos = importlib.import_module("pde_tpu_torch.solvers.aos")
jgac = importlib.import_module("pde_tpu.models.gac")
tgac = importlib.import_module("pde_tpu_torch.models.gac")

torch.set_num_threads(1)

OP_TOL = 1e-5      # of the range, per op
CHUNK_TOL = 1e-4   # of phi's range, per chunk of steps
CPU = dict(device="cpu")


def _rel(got, want) -> float:
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max()) / float(want.max() - want.min())


def _circle_phi(rng, h=48, w=48, r=14.0, noise=0.3):
    yy, xx = np.mgrid[:h, :w]
    phi = r - np.sqrt((xx - w / 2.0) ** 2 + (yy - h / 2.0) ** 2)
    return (phi + noise * rng.standard_normal((h, w))).astype(np.float32)


def _disc_image(rng, h=48, w=48):
    """The textured disc of ``tests/test_models.py``'s GAC check."""
    yy, xx = np.mgrid[:h, :w]
    img = 20.0 * rng.random((h, w)).astype(np.float32)
    img[(xx - w // 2) ** 2 + (yy - h // 2) ** 2 < 8 ** 2] += 200.0
    return ndi.gaussian_filter(img, 1.0)


def test_blurred_sign_and_upwind_gradients_match_reference(rng):
    phi = _circle_phi(rng)
    want_s = jreinit.blurred_sign(jnp.asarray(phi))
    got_s = treinit.blurred_sign(torch.from_numpy(phi))
    assert _rel(got_s, want_s) <= OP_TOL
    for w_, g_ in zip(jreinit.godunov_upwind_sq(jnp.asarray(phi), want_s),
                      treinit.godunov_upwind_sq(torch.from_numpy(phi), got_s)):
        assert _rel(g_, w_) <= OP_TOL


@pytest.mark.parametrize("steps", [1, 40])
def test_reinit_matches_reference(rng, steps):
    """A noisy circle (2-D) and a batch of two level sets (3-D)."""
    phi = np.stack([_circle_phi(rng), _circle_phi(rng, r=9.0)])
    for x in (phi[0], phi):
        want = jreinit.reinit(jnp.asarray(x), steps=steps)
        assert _rel(treinit.reinit(torch.from_numpy(x), steps=steps), want) <= OP_TOL
    want = jreinit.reinit_t(jnp.asarray(phi[0]), 0.25 * steps)
    assert _rel(treinit.reinit_t(torch.from_numpy(phi[0]), 0.25 * steps), want) <= OP_TOL
    assert torch.equal(treinit.reinit_t(torch.from_numpy(phi[0]), 0.0), torch.from_numpy(phi[0]))


def _aos_inputs(rng, shape):
    """phi beyond the clamp bounds in places, a data term, a positive
    gradient norm and a diffusivity with zero pixels (frozen)."""
    phi = (rng.random(shape) * 14.0 - 7.0).astype(np.float32)
    data = (rng.random(shape) - 0.5).astype(np.float32)
    grad = (rng.random(shape) + 0.1).astype(np.float32)
    diff = (rng.random(shape) + 0.05).astype(np.float32)
    diff[..., 5, 7] = 0.0
    diff[..., 11, 3:9] = 0.0
    return phi, data, grad, diff


@pytest.mark.parametrize("shape", [(24, 30), (2, 24, 30)])
@pytest.mark.parametrize("step", ["cv_aos_step", "ac_aos_step"])
def test_aos_steps_match_reference(rng, shape, step):
    phi, data, grad, diff = _aos_inputs(rng, shape)
    # a weak smoothing (nu = 2) leaves values beyond the clamp bounds
    want = getattr(jaos, step)(*(jnp.asarray(x) for x in (phi, data, grad, diff)), 0.25, 2.0)
    before = dict(tdma_cuda.LAUNCHES)
    got = getattr(taos, step)(*(torch.from_numpy(x) for x in (phi, data, grad, diff)), 0.25,
                              2.0)
    assert tdma_cuda.LAUNCHES == before
    assert _rel(got, want) <= OP_TOL
    frozen = diff == 0.0
    np.testing.assert_array_equal(got.numpy()[frozen], phi[frozen])
    if step == "cv_aos_step":
        # clamped to [-5, 5] wherever the step moves phi; frozen pixels keep
        # their input, which goes beyond
        moved = got.numpy()[~frozen]
        assert np.abs(moved).max() <= taos.PHI_MAX and (np.abs(moved) == taos.PHI_MAX).any()


def test_quantile_index_is_the_reference_float32_round():
    """round(0.7 N) in float32, half to even, as ``jnp.round`` computes it
    in ``pde_tpu``'s stopping function."""
    for n in range(1, 3000):
        want = max(int(jnp.round(0.7 * n).astype(jnp.int32)) - 1, 0)
        assert tgac._quantile_index(n) == want, n


@pytest.mark.parametrize("lam", [-1.0, 40.0])
def test_stopping_function_matches_reference(rng, lam):
    img = np.stack([_disc_image(rng), _disc_image(rng) * 0.5])
    want = jgac._stopping_function(jnp.asarray(img), lam)
    assert _rel(tgac._stopping_function(torch.from_numpy(img), lam), want) <= OP_TOL


def test_stopping_function_floors_a_zero_quantile(rng):
    """A mostly flat image puts the 0.7 quantile of |grad I|^2 at 0; lambda
    is floored at float64's eps, so the flat region gets g = 1."""
    img = np.zeros((48, 48), np.float32)
    img[20:26, 20:26] = 100.0
    want = np.asarray(jgac._stopping_function(jnp.asarray(img), -1.0))
    got = tgac._stopping_function(torch.from_numpy(img), -1.0)
    assert np.isfinite(want).all() and want[0, 0] == 1.0
    assert _rel(got, want) <= OP_TOL and float(got[0, 0]) == 1.0


@pytest.mark.parametrize("model", ["gac_a", "gac_b"])
def test_gac_chunks_match_reference(rng, model):
    """Every 5-step chunk of ITER = 20 on the disc image, contour started
    outside the disc; the result is the last chunk and stays on the CPU."""
    img = _disc_image(rng)
    yy, xx = np.mgrid[:48, :48]
    phi0 = (18.0 - np.sqrt((xx - 24.0) ** 2 + (yy - 24.0) ** 2)).astype(np.float32)
    want, got = [], []
    getattr(jgac, model)(img, phi0, ITER=20, collect=want, collect_every=5)
    before = dict(tdma_cuda.LAUNCHES)
    out = getattr(tgac, model)(torch.from_numpy(img), phi0, ITER=20, collect=got,
                               collect_every=5)
    assert tdma_cuda.LAUNCHES == before
    assert len(got) == len(want) == 4 and out is got[-1] and out.device.type == "cpu"
    for k, (w_, g_) in enumerate(zip(want, got)):
        assert _rel(g_, w_) <= CHUNK_TOL, f"chunk {k}"
    assert 0 < int((out > 0).sum()) < int((torch.from_numpy(phi0) > 0).sum())
    assert float(out[24, 24]) > 0


def test_gac_on_the_golden_initial_contour(rng):
    """``gac_ctour.npz``'s phi0 (320x400, the reference demo's size; the
    golden has no image) with a synthetic image: a bright textured band;
    three steps of each model, and the fused forms equal the plain ones."""
    phi0 = np.load("tests/golden/gac_ctour.npz")["phi0"]
    h, w = phi0.shape
    yy, xx = np.mgrid[:h, :w]
    img = 30.0 * rng.random((3, h, w)).astype(np.float32)
    img[:, np.abs(yy - 0.4 * xx - 100) < 25] += 150.0
    img = ndi.gaussian_filter(img, (0, 1.5, 1.5))
    for model in ("gac_a", "gac_b"):
        want = getattr(jgac, model)(img, phi0, ITER=3)
        got = getattr(tgac, model)(img, phi0, ITER=3, **CPU)
        assert got.shape == (h, w) and _rel(got, want) <= CHUNK_TOL
        p = tgac.params_from_reference(jgac.GACParams(ITER=3))
        fused = getattr(tgac, f"{model}_fused")(img, phi0, p, **CPU)
        assert torch.equal(fused, got)


def test_gac_numpy_input_without_a_card_raises(rng, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgac.gac_a(_disc_image(rng), _circle_phi(rng), ITER=1)
    with pytest.raises(TypeError, match="unknown"):
        tgac.gac_b(_disc_image(rng), _circle_phi(rng), ITER=1, iters=2, **CPU)
