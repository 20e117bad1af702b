"""The port's RANSAC (``ops/ransac.py``) held against ``pde_tpu``'s on the
same hypotheses: the port is handed, through ``idx=``, the pixel indices
that ``jax.random.categorical`` draws inside ``pde_tpu``'s fit from the same
key over the same mask.

Bounds: the winning model <= 1e-4 of max|model|, the winner's squared
residual field <= 1e-4 of its range, and the same winning hypothesis. The
least squares (an SVD pseudo-inverse with jnp.linalg.lstsq's cutoff) per
system within 8 float32 eps times the condition number of the singular
values kept, of max(max|x|, max|b| / the least singular value kept) (two
LAPACK builds agree that far; random quadric draws reach condition numbers
of 1e10, where a fixed bound means nothing), including rank-deficient
draws. On noiseless data the residual field is itself rounding, so its
bound has a floor of (8 eps max|data|)^2.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jr = importlib.import_module("pde_tpu.ops.ransac")
tr = importlib.import_module("pde_tpu_torch.ops.ransac")
tseg = importlib.import_module("pde_tpu_torch.models.segmentation")

torch.set_num_threads(1)

MODEL_TOL = 1e-4   # of max|model|
ERR_TOL = 1e-4     # of the residual field's range
LSQ_EPS = 8 * float(np.finfo(np.float32).eps)  # times the kept condition number

PLANE = np.array([0.2, -0.1, 3.0], np.float32)
QUADRIC = np.array([1e-3, -2e-3, 5e-4, 0.2, -0.1, 3.0], np.float32)


def _surface(h, w, model, noise, rng):
    feats = np.asarray(jr.surface_features(h, w, 1 if len(model) == 3 else 2))
    data = feats @ model + noise * rng.standard_normal((h, w))
    return data.astype(np.float32)


def _jax_idx(key, mask, iters, k):
    """The indices pde_tpu's ransac_surface draws from ``key`` over ``mask``."""
    logits = jnp.where(jnp.asarray(mask).ravel(), 0.0, -jnp.inf)
    return np.asarray(jax.random.categorical(key, logits, shape=(iters, k + 1)))


def _winner(candidates_n, model, h, w, k):
    """Index of the hypothesis whose model (back in pixel coordinates) is
    nearest the returned one."""
    cx, sx, cy, sy = tr._norm_params(h, w)
    back = tr._model_from_norm(torch.as_tensor(np.asarray(candidates_n)), cx, sx, cy, sy, k)
    return int(np.argmin(np.abs(back.numpy() - np.asarray(model)).max(axis=1)))


def _fit_both(rng, h, w, model, noise, density, iters, seed, cset=0.5, warm=None):
    k = len(model)
    order = 1 if k == 3 else 2
    data = _surface(h, w, model, noise, rng)
    mask = rng.random((h, w)) < density
    key = jax.random.PRNGKey(seed)
    jfeats = jr.surface_features(h, w, order)
    warm_j = None if warm is None else jnp.asarray(warm)
    m_j, e_j = jr.ransac_surface(key, jnp.asarray(data), jnp.asarray(mask), jfeats, 0.7, cset,
                                 iters, model_in=warm_j)
    idx = _jax_idx(key, mask, iters, k)
    warm_t = None if warm is None else torch.from_numpy(warm)
    m_t, e_t = tr.ransac_surface(None, torch.from_numpy(data), torch.from_numpy(mask),
                                 tr.surface_features(h, w, order), 0.7, cset, iters,
                                 model_in=warm_t, idx=torch.from_numpy(idx))
    return data, mask, idx, (np.asarray(m_j), np.asarray(e_j)), (m_t.numpy(), e_t.numpy())


def _rel(got, want):
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def test_features_and_normalisation_match_reference(rng):
    for order in (1, 2):
        want = np.asarray(jr.surface_features(7, 9, order))
        np.testing.assert_array_equal(tr.surface_features(7, 9, order).numpy(), want)
    for h, w in ((7, 9), (1, 1), (40, 50)):
        assert tr._norm_params(h, w) == jr._norm_params(h, w)
        p = tr._norm_params(h, w)
        for k in (3, 6):
            m = rng.standard_normal((5, k)).astype(np.float32)
            for name in ("_model_to_norm", "_model_from_norm"):
                want = np.stack([np.asarray(getattr(jr, name)(jnp.asarray(r), *p, k)) for r in m])
                got = getattr(tr, name)(torch.from_numpy(m), *p, k).numpy()
                assert _rel(got, want) <= 1e-6, (name, k)
    f = tr.surface_features(5, 6, 1)
    np.testing.assert_array_equal(tr.surface_eval(f, torch.from_numpy(PLANE)).numpy(),
                                  np.asarray(jr.surface_eval(jr.surface_features(5, 6, 1),
                                                             jnp.asarray(PLANE))))


@pytest.mark.parametrize("k", [3, 6])
def test_lstsq_matches_jnp_lstsq_with_its_cutoff(rng, k):
    """Full-rank draws, collinear draws (rank 2 for the plane) and one point
    repeated (rank 1): the cutoff drops the same singular values."""
    feats = np.asarray(tr._norm_features(20, 30, k, torch.device("cpu")))
    idx = rng.integers(0, 600, size=(40, k + 1))
    idx[0] = 37  # one pixel k+1 times: rank 1
    idx[1] = [5 * 30 + j for j in (2, 9, 17, 25, 28, 29, 3)][:k + 1]  # one row: collinear
    a, b = feats[idx], rng.standard_normal((40, k + 1)).astype(np.float32)
    want = np.asarray(jax.vmap(lambda x, y: jnp.linalg.lstsq(x, y)[0])(jnp.asarray(a),
                                                                          jnp.asarray(b)))
    got = tr.lstsq_pinv(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    s = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    cut = np.finfo(np.float32).eps * (k + 1) * s[:, :1]
    s_kept = np.where(s >= cut, s, np.inf).min(axis=1)
    cond = s[:, 0] / s_kept
    for i in range(40):
        scale = max(np.abs(want[i]).max(), np.abs(b[i]).max() / s_kept[i])
        assert np.abs(got[i] - want[i]).max() <= LSQ_EPS * cond[i] * scale, i
    # the degenerate systems are truncated: the minimum-norm solution, finite
    assert (s[:2, -1] < cut[:2, 0]).all() and np.isfinite(got).all()


@pytest.mark.parametrize("model", [PLANE, QUADRIC], ids=["plane", "quadric"])
@pytest.mark.parametrize("noise", [0.0, 0.05])
def test_ransac_matches_reference_on_its_draws(rng, model, noise):
    h, w, iters = 30, 40, 60
    k = len(model)
    data, mask, idx, (m_j, e_j), (m_t, e_t) = _fit_both(rng, h, w, model, noise, 0.7, iters,
                                                        seed=3)
    assert _rel(m_t, m_j) <= MODEL_TOL
    floor = (LSQ_EPS * float(np.abs(data).max())) ** 2
    assert np.abs(e_t - e_j).max() <= ERR_TOL * float(e_j.max() - e_j.min()) + floor
    np.testing.assert_allclose(m_t, model, atol=0.05 + 2 * noise)
    if noise > 0:
        # the same hypothesis wins; on noiseless data every hypothesis fits to
        # rounding and the error sums that rank them are rounding residues
        feats = np.asarray(tr._norm_features(h, w, k, torch.device("cpu")))
        cands = np.asarray(jax.vmap(lambda x, y: jnp.linalg.lstsq(x, y)[0])(
            jnp.asarray(feats[idx]), jnp.asarray(data.ravel()[idx])))
        assert _winner(cands, m_t, h, w, k) == _winner(cands, m_j, h, w, k)


def test_ransac_degenerate_draws_truncate_alike(rng):
    """Every hypothesis drawn from one image row (collinear: the plane's
    system has rank 2): both packages keep the same minimum-norm models."""
    h, w, iters = 12, 40, 30
    data = _surface(h, w, PLANE, 0.01, rng)
    mask = np.zeros((h, w), bool)
    mask[6, :] = True
    key = jax.random.PRNGKey(11)
    m_j, e_j = jr.ransac_surface(key, jnp.asarray(data), jnp.asarray(mask),
                                 jr.surface_features(h, w, 1), 0.7, 0.5, iters)
    idx = _jax_idx(key, mask, iters, 3)
    m_t, e_t = tr.ransac_surface(None, torch.from_numpy(data), torch.from_numpy(mask),
                                 tr.surface_features(h, w, 1), 0.7, 0.5, iters,
                                 idx=torch.from_numpy(idx))
    assert _rel(m_t.numpy(), np.asarray(m_j)) <= MODEL_TOL
    e_j = np.asarray(e_j)
    assert np.abs(e_t.numpy() - e_j).max() <= ERR_TOL * float(e_j.max() - e_j.min())
    # the row's own residuals are small: the fit follows the row
    assert e_t.numpy()[6].mean() < 0.01


@pytest.mark.parametrize("warm_kind", ["true", "zeros", "nan"])
def test_warm_model_competes_as_hypothesis_zero(rng, warm_kind):
    """A finite non-zero warm model joins as hypothesis 0; zeros or NaN mean
    none (the reference's empty model)."""
    warm = {"true": PLANE.copy(), "zeros": np.zeros(3, np.float32),
            "nan": np.full(3, np.nan, np.float32)}[warm_kind]
    _, _, _, (m_j, e_j), (m_t, e_t) = _fit_both(rng, 25, 33, PLANE, 0.05, 0.6, 20, seed=5,
                                                warm=warm)
    assert _rel(m_t, m_j) <= MODEL_TOL
    assert np.abs(e_t - e_j).max() <= ERR_TOL * float(e_j.max() - e_j.min())


def test_no_licit_model_falls_back_to_the_largest_count(rng):
    """cset = 1.0 with noise: no hypothesis holds every pixel, so the one with
    the most inliers wins (ransac.c:189-211)."""
    _, _, _, (m_j, e_j), (m_t, e_t) = _fit_both(rng, 20, 24, PLANE, 0.5, 0.8, 25, seed=9,
                                                cset=1.0)
    assert _rel(m_t, m_j) <= MODEL_TOL


def test_batched_fit_equals_the_reference_vmap(rng):
    """Leading mask dimensions are independent fits: against pde_tpu's
    ransac_surface vmapped over keys, masks and warm models, as its region
    competition calls it."""
    h, w, iters, s = 24, 30, 10, 3
    data = _surface(h, w, PLANE, 0.05, rng)
    masks = rng.random((s, h, w)) < np.array([0.2, 0.5, 0.0])[:, None, None]
    warm = np.stack([PLANE, np.zeros(3, np.float32), PLANE * 1.01]).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(4), s)
    feats = jr.surface_features(h, w, 1)
    m_j, e_j = jax.vmap(lambda k_, m_, w_: jr.ransac_surface(
        k_, jnp.asarray(data), m_, feats, 1.0, 0.7, iters, model_in=w_))(
        keys, jnp.asarray(masks), jnp.asarray(warm))
    idx = np.stack([_jax_idx(keys[i], masks[i], iters, 3) for i in range(s)])
    m_t, e_t = tr.ransac_surface(None, torch.from_numpy(data), torch.from_numpy(masks),
                                 tr.surface_features(h, w, 1), 1.0, 0.7, iters,
                                 model_in=torch.from_numpy(warm), idx=torch.from_numpy(idx))
    assert m_t.shape == (s, 3) and e_t.shape == (s, h, w)
    for i in range(s):
        e = np.asarray(e_j[i])
        assert _rel(m_t[i].numpy(), np.asarray(m_j[i])) <= MODEL_TOL, i
        assert np.abs(e_t[i].numpy() - e).max() <= ERR_TOL * float(e.max() - e.min()), i


def test_torch_draws_sample_the_mask_only():
    """The default draw source: uniform with replacement over the mask's
    pixels, one stream a leading row, reproducible from its seed; an empty
    mask draws valid indices instead of raising."""
    masks = torch.zeros((3, 10, 12), dtype=torch.bool)
    masks[0, 2:5, 3:9] = True
    masks[1, 7, 1] = True
    draws = tseg.TorchDraws(7, "cpu")
    idx = draws.categorical(masks, 50, 4)
    assert idx.shape == (3, 50, 4) and idx.dtype == torch.int64
    assert bool(masks[0].reshape(-1)[idx[0]].all())
    assert bool((idx[1] == 7 * 12 + 1).all())
    assert int(idx[2].min()) >= 0 and int(idx[2].max()) < 120
    assert len(torch.unique(idx[0])) > 12  # spread over the 18 pixels
    again = tseg.TorchDraws(7, "cpu").categorical(masks, 50, 4)
    assert torch.equal(idx, again)
    state = draws.state()
    a = draws.categorical(masks[0], 5, 4)
    draws.set_state(state)
    assert torch.equal(a, draws.categorical(masks[0], 5, 4))
    assert draws.split() is draws and draws.split(3) is draws
