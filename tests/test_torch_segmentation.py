"""The port's disparity segmentation (``models/segmentation.py``) and its
prefilters held against ``pde_tpu``'s.

The port draws ``pde_tpu``'s RANSAC samples through a draw source backed by
``jax.random`` (``JaxDraws`` below, the private ``_draws=`` of the entry
points), which splits ``PRNGKey(rng_seed)`` at the points where
``pde_tpu`` splits its key. The maps and reduced loop counts are
``tests/test_segmentation.py``'s.

Bounds, each variant's from its readings (``scripts/seg_rounding.py``
prints them):
- ``nanmedfilt2``: bit for bit; ``imresize_nan``: the same NaN positions,
  values <= 1e-5 of max|x|.
- The whole pipeline: the same segment count, SEG equal on >= 99.5% of the
  pixels, SParam <= 1e-3 of max|SParam|, and mean |dphi| <= 3e-3 (dense,
  reading 2.23e-3), 0.05 (sparse, 0.0402) and 1e-3 (warm start, 2.07e-4).
- Each pyramid stage of seeding and of region competition, on pde_tpu's own
  inputs to it, with the reference's exp and log substituted in the port's
  likelihood (``_likelihood``, ``_log_ratio``): the same dead and alive
  flags, models <= 1e-3 of their largest coefficient, the sign of phi equal
  on >= 99.5% of the pixels where |phi| > 1e-5 (below, its sign is the
  resize's summation order), and max |dphi| / mean |dphi| over the live
  stages <= 0.02 / 3.5e-3 (dense, readings 0.0133 / 2.34e-3), 0.015 /
  1.2e-3 (sparse, 9.52e-3 / 7.41e-4) and 6e-3 / 7e-4 (warm start, 3.86e-3
  / 4.39e-4).

Why phi's bounds are looser than 1e-4 (ROADMAP F8): two places where the
reference turns one ulp into O(0.1-1).
- The zero-diffusivity freeze of the AOS step keeps a pixel whose |grad phi|
  is exactly 0. A flat +-5 region after the bicubic resize is flat or not
  by one ulp, which the matmul's summation order decides, so a stage
  freezes other pixels in each package. pde_tpu against itself with its
  resize's sums reversed moves by mean |dphi| 2.23e-3 (dense, one flipped
  pixel, max 2.69), exactly as far as the port lies from it; pde_tpu's own
  stage with its input moved by one ulp at a tenth of the pixels moves by
  more than the port's stage lies from it.
- The DATA term log((p1 + eps) / (p0 + eps)), p0 = norm - p1, cancels at
  pixels on or near the fitted surface: one ulp of exp moves DATA there by
  O(0.01-10). pde_tpu with its exp one ulp lower moves by mean |dphi|
  0.0414 (sparse), as far as the port lies from it (0.0402).
The stage tests substitute the reference's exp and log, which leaves the
freeze: the in-stage AOS, SVD and resize round otherwise.
"""

import importlib
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jseg = importlib.import_module("pde_tpu.models.segmentation")
tseg = importlib.import_module("pde_tpu_torch.models.segmentation")
jmed = importlib.import_module("pde_tpu.core.median")
tmed = importlib.import_module("pde_tpu_torch.core.median")
jres = importlib.import_module("pde_tpu.core.resize")
tres = importlib.import_module("pde_tpu_torch.core.resize")
pde_tpu_torch = importlib.import_module("pde_tpu_torch")

torch.set_num_threads(1)

SEG_AGREE = 0.995   # share of pixels with the same SEG id / sign of phi
SPARAM_TOL = 1e-3   # of max|SParam|
# mean |dphi| of the whole pipeline, a variant's reading beside it (F8)
PHI_MEAN_TOL = {"dense": 3e-3,     # 2.23e-3
                "sparse": 0.05,    # 0.0402
                "warm": 1e-3}      # 2.07e-4
# (max |dphi|, mean |dphi|) of one stage, the worst readings over the live
# stages beside them (F8)
STAGE_TOL = {"dense": (0.02, 3.5e-3),     # 0.0133, 2.34e-3
             "sparse": (0.015, 1.2e-3),   # 9.52e-3, 7.41e-4
             "warm": (6e-3, 7e-4)}        # 3.86e-3, 4.39e-4
MODEL_TOL = 1e-3    # of a model's largest coefficient
CPU = dict(device="cpu")


class JaxDraws:
    """A draw source backed by ``jax.random``: ``split`` as pde_tpu splits its
    key, ``categorical`` as its ransac_surface draws (vmapped over leading
    mask dimensions, one key each)."""

    def __init__(self, key):
        self.key = key

    def split(self, n=None):
        if n is None:
            self.key, sub = jax.random.split(self.key)
            return JaxDraws(sub)
        return JaxDraws(jax.random.split(self.key, n))

    def categorical(self, mask, iters, ns):
        m = jnp.asarray(mask.cpu().numpy())
        lead = m.shape[:-2]
        m = m.reshape(*lead, -1)

        def draw(k, mm):
            return jax.random.categorical(k, jnp.where(mm, 0.0, -jnp.inf), shape=(iters, ns))

        for _ in lead:
            draw = jax.vmap(draw)
        return torch.from_numpy(np.asarray(draw(self.key, m)).astype(np.int64))

    def state(self):
        return np.asarray(self.key)

    def set_state(self, state):
        self.key = jnp.asarray(state)


def _two_planes(h=40, w=50, noise=0.02, rng=None):
    """Left half: plane 0.1x+0.05y+2; right half: plane -0.05x+0.02y+8 (as
    tests/test_segmentation.py)."""
    rng = rng or np.random.default_rng(0)
    y, x = np.mgrid[1:h + 1, 1:w + 1].astype(np.float32)
    d = np.where(x <= w // 2, 0.1 * x + 0.05 * y + 2.0, -0.05 * x + 0.02 * y + 8.0)
    return (d + noise * rng.standard_normal((h, w))).astype(np.float32)


def _case(variant):
    """(din, entry point name, keyword arguments) of tests/test_segmentation.py."""
    rng = np.random.default_rng(42)
    if variant == "dense":
        return _two_planes(40, 50, rng=rng), "disp_segmentation", dict(
            seeds=3, seed_iterations=6, rc_iterations=6, rc_iterations2=4, ransac_first=200,
            ransac_rest=50)
    if variant == "sparse":
        d = _two_planes(36, 44, rng=rng)
        d[rng.random(d.shape) < 0.15] = np.nan
        return d, "disp_segmentation_sparse", dict(
            seeds=2, seed_iterations=5, rc_iterations=4, rc_iterations2=3, ransac_first=200,
            ransac_rest=50)
    d = _two_planes(32, 40, rng=rng)
    phi0 = -np.ones((1, 32, 40), np.float32)
    phi0[0, 4:28, 4:18] = 1.0
    return d, "disp_segmentation", dict(phi=phi0, seed_iterations=4, rc_iterations2=3,
                                        ransac_first=100, ransac_rest=50)


def _host(x):
    return np.asarray(x) if not torch.is_tensor(x) else x.numpy()


@pytest.fixture(scope="module", params=["dense", "sparse", "warm"])
def reference(request):
    """pde_tpu's run of one variant, with every stage call recorded: (inputs,
    static arguments, outputs) of ``_seed_stage`` and ``_rc_stage``."""
    d, entry, kw = _case(request.param)
    calls = {"seed": [], "rc": []}
    real = {"seed": jseg._seed_stage, "rc": jseg._rc_stage}

    def recorder(kind):
        def run(*args, **static):
            out = real[kind](*args, **static)
            calls[kind].append(([_host(a) for a in args], static, [_host(o) for o in out]))
            return out
        return run

    collect = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jseg, "_seed_stage", recorder("seed"))
        mp.setattr(jseg, "_rc_stage", recorder("rc"))
        phi, seg, sparam = getattr(jseg, entry)(d, collect=collect, **kw)
    return dict(variant=request.param, din=d, entry=entry, kw=kw, calls=calls,
                out=(np.asarray(phi), np.asarray(seg), np.asarray(sparam)),
                collect=[(n, np.asarray(s)) for n, s in collect])


def test_nanmedfilt2_matches_reference_bit_for_bit(rng):
    """NaN holes, a block of all-NaN windows and the zero-padded border; a
    batch of two maps and k = 3."""
    x = (rng.standard_normal((2, 29, 37)) * 10).astype(np.float32)
    x[rng.random(x.shape) < 0.3] = np.nan
    x[0, 8:16, 10:20] = np.nan
    for k in (5, 3):
        for arr in (x[0], x):
            want = np.asarray(jmed.nanmedfilt2(jnp.asarray(arr), k))
            got = tmed.nanmedfilt2(torch.from_numpy(arr), k).numpy()
            np.testing.assert_array_equal(got, want)
            assert np.isnan(want).any() and not np.isnan(want[..., 0, 0]).all()


@pytest.mark.parametrize("size", [(21, 26), (50, 61)])
def test_imresize_nan_matches_reference(rng, size):
    x = (rng.standard_normal((36, 44)) * 5 + 20).astype(np.float32)
    x[rng.random(x.shape) < 0.03] = np.nan
    x[30:, :6] = np.nan
    want = np.asarray(jres.imresize_nan(jnp.asarray(x), size, "bicubic"))
    got = tres.imresize_nan(torch.from_numpy(x), size, "bicubic").numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert 0 < np.isnan(want).mean() < 0.8
    ok = ~np.isnan(want)
    assert np.abs(got[ok] - want[ok]).max() <= 1e-5 * np.nanmax(np.abs(x))


def test_pipeline_matches_reference(reference):
    """The whole entry point on pde_tpu's draws, and each phase's SEG
    snapshot (``collect``)."""
    ref = reference
    collect = []
    phi, seg, sparam = getattr(tseg, ref["entry"])(
        ref["din"], collect=collect, _draws=JaxDraws(jax.random.PRNGKey(0)), **ref["kw"], **CPU)
    phi_j, seg_j, sparam_j = ref["out"]
    assert phi.dtype == torch.float32 and seg.dtype == torch.int32
    assert phi.shape == phi_j.shape and sparam.shape == sparam_j.shape and phi.shape[0] >= 1
    assert torch.isfinite(phi).all()
    assert (seg.numpy() == seg_j).mean() >= SEG_AGREE
    assert np.abs(sparam.numpy() - sparam_j).max() <= SPARAM_TOL * np.abs(sparam_j).max()
    assert np.abs(phi.numpy() - phi_j).mean() <= PHI_MEAN_TOL[ref["variant"]]
    # the phases' snapshots, named and shaped alike; their SEG maps are not
    # held to 99.5%: an intermediate phase shows F8 before the competition
    # pulls the runs together (sparse: 75% equal after the first seeding)
    assert [n for n, _ in collect] == [n for n, _ in ref["collect"]]
    for (name, s_t), (_, s_j) in zip(collect, ref["collect"]):
        assert s_t.dtype == torch.int32 and s_t.shape == s_j.shape, name


def _reference_exp_log(mp):
    """The port's likelihood with pde_tpu's exp and log (F8: one ulp of either
    moves DATA by O(1) where p0 cancels)."""
    def likelihood(dist, cov):
        norm = 1.0 / torch.sqrt(2.0 * np.pi * cov)
        e = np.asarray(jnp.exp(jnp.asarray((-dist / (2.0 * cov)).numpy())))
        return norm, norm * torch.from_numpy(e)

    def log_ratio(p, q):
        r = ((p + tseg._EPS) / (q + tseg._EPS)).numpy()
        return torch.from_numpy(np.asarray(jnp.log(jnp.asarray(r))))

    mp.setattr(tseg, "_likelihood", likelihood)
    mp.setattr(tseg, "_log_ratio", log_ratio)


def _check_phi(got, want, variant, what):
    assert got.shape == want.shape and np.isfinite(got).all(), what
    diff = np.abs(got - want)
    max_tol, mean_tol = STAGE_TOL[variant]
    assert diff.max() <= max_tol and diff.mean() <= mean_tol, (what, diff.max(), diff.mean())
    # where pde_tpu's phi is a rounding residue of zero (the bicubic upscale
    # of a +-5 step at its midpoint), its sign is the matmul's summation order
    signed = np.abs(want) > 1e-5
    assert ((got >= 0) == (want >= 0))[signed].mean() >= SEG_AGREE, what


def _check_model(got, want, what):
    assert np.abs(got - want).max() <= MODEL_TOL * max(np.abs(want).max(), 1e-6), what


def test_seed_stages_match_reference(reference, monkeypatch):
    """Every ``_seed_stage`` call of pde_tpu's run (peel, mask init, the
    mid-pyramid biggest component and minimum-variance reset, dead seeds,
    the upscale), rerun by the port from its inputs and key."""
    _reference_exp_log(monkeypatch)
    for i, (args, static, out) in enumerate(reference["calls"]["seed"]):
        key, phi, d, d_fit, include, h1eq, min_cov, dead, gamma, rcons, tau = args
        t = [torch.from_numpy(np.array(x)) for x in (phi, d, d_fit, include, h1eq, min_cov, dead)]
        phi_t, h1eq_t, min_cov_t, dead_t = tseg._seed_stage(
            JaxDraws(jnp.asarray(key)), *t, float(gamma), [float(r) for r in rcons], float(tau),
            **static)
        _, phi_j, h1eq_j, min_cov_j, dead_j = out
        what = f"seed stage {i} {static}"
        assert bool(dead_t) == bool(dead_j), what
        if bool(dead_j):
            continue  # a dead seed's phi and model are discarded
        _check_phi(phi_t.numpy(), phi_j, reference["variant"], what)
        _check_model(h1eq_t.numpy(), h1eq_j, what)
        assert abs(float(min_cov_t) - float(min_cov_j)) <= MODEL_TOL * float(min_cov_j), what


def test_competition_stages_match_reference(reference, monkeypatch):
    """Every ``_rc_stage`` call of pde_tpu's run (purge, recompute on even
    iterations with one stream a segment, the CV step of the stack, the
    upscale), rerun by the port from its inputs and key."""
    _reference_exp_log(monkeypatch)
    assert reference["calls"]["rc"]
    for i, (args, static, out) in enumerate(reference["calls"]["rc"]):
        key, phi, d, d_fit, surface, alive, min_cov, cset, tau, gamma, thr = args
        t = [torch.from_numpy(np.array(x)) for x in (phi, d, d_fit, surface, alive, min_cov)]
        phi_t, surface_t, alive_t = tseg._rc_stage(
            JaxDraws(jnp.asarray(key)), *t, float(cset), float(tau), float(gamma), float(thr),
            **static)
        _, phi_j, surface_j, alive_j = out
        what = f"competition stage {i}"
        np.testing.assert_array_equal(alive_t.numpy(), alive_j, err_msg=what)
        _check_phi(phi_t.numpy(), phi_j, reference["variant"], what)
        _check_model(surface_t.numpy(), surface_j, what)


@pytest.mark.parametrize("strategy", ["surface", "greedy", "inverse"])
def test_recompute_strategies_match_reference(strategy):
    """``_rc_recompute``'s three competition strategies on one stack, a slot
    dead: surfaces, variances, dH and |grad phi|; DATA <= 1e-5 of its largest
    magnitude, for 'inverse' where its rival keeps 2^-10 of p (F8)."""
    rng = np.random.default_rng(5)
    d = _two_planes(24, 30, rng=rng)
    yy, xx = np.mgrid[:24, :30]
    phi = np.stack([np.where(xx < 15, 2.0, -2.0), np.where(xx >= 13, 1.5, -3.0),
                    -np.ones((24, 30))]).astype(np.float32)
    phi += 0.3 * rng.standard_normal(phi.shape).astype(np.float32)
    surface = np.array([[0.1, 0.05, 2.0], [0, 0, 0], [0, 0, 0]], np.float32)
    alive = np.array([True, True, False])
    key = jax.random.PRNGKey(8)
    want = jseg._rc_recompute(key, jnp.asarray(phi), jnp.asarray(d), jnp.asarray(d),
                              jnp.asarray(surface), jnp.float32(1.5), jnp.float32(0.7),
                              jnp.asarray(alive), order=1, strategy=strategy,
                              inlier_lt_100=False)
    got = tseg._rc_recompute(JaxDraws(key), torch.from_numpy(phi), torch.from_numpy(d),
                             torch.from_numpy(d), torch.from_numpy(surface),
                             torch.tensor(1.5), 0.7, torch.from_numpy(alive), order=1,
                             strategy=strategy, inlier_lt_100=False)
    data_j, dh_j, grad_j, surf_j, cov_j = (np.asarray(x) for x in want)
    data_t, dh_t, grad_t, surf_t, cov_t = (x.numpy() for x in got)
    assert np.abs(dh_t - dh_j).max() <= 1e-6 and np.abs(grad_t - grad_j).max() <= 1e-5
    _check_model(surf_t, surf_j, "surface")
    assert np.abs(cov_t - cov_j).max() <= 1e-4 * np.abs(cov_j).max()
    assert (surf_t[2] == 0).all()
    # 'inverse' cancels norm - p where p is near its peak: DATA > 10 ln 2 means
    # the rival keeps under 2^-10 of p, and there its bits are gone (F8)
    err = np.abs(data_t - data_j)
    tol = 1e-5 * np.abs(data_j).max()
    well = data_j <= 10 * np.log(2.0)
    assert well.mean() > 0.5 and err[well].max() <= tol
    if strategy != "inverse":
        assert err.max() <= tol


def test_defaults_and_exports_match_reference():
    assert tseg.DispSegParams() == tseg.DispSegParams(**vars(jseg.DispSegParams()))
    assert vars(tseg.sparse_defaults()) == vars(jseg.sparse_defaults())
    for name in ("disp_segmentation", "disp_segmentation_sparse", "DispSegParams"):
        assert getattr(pde_tpu_torch, name) is getattr(tseg, name)
        assert getattr(pde_tpu_torch.models, name) is getattr(tseg, name)


# ---------------------------------------------------------------------------
# The port alone: the default draw source, checkpoints, collect, devices
# ---------------------------------------------------------------------------

KW = dict(seeds=2, seed_iterations=4, rc_iterations=3, rc_iterations2=2, ransac_first=50,
          ransac_rest=20)


def _run(d, **kw):
    return tseg.disp_segmentation(d, **KW, **CPU, **kw)


def _equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_default_draws_find_both_planes():
    """The torch generator's draws, seeded by rng_seed: reproducible, and the
    two generating planes recovered (tests/test_segmentation.py's check)."""
    d = _two_planes(rng=np.random.default_rng(42))
    kw = dict(seeds=3, seed_iterations=6, rc_iterations=6, rc_iterations2=4,
              ransac_first=200, ransac_rest=50)
    phi, seg, sparam = tseg.disp_segmentation(d, **kw, **CPU)
    _equal((phi, seg, sparam), tseg.disp_segmentation(d, **kw, **CPU))
    assert phi.shape[0] >= 1 and torch.isfinite(phi).all()
    assert (phi > 0).any(dim=0).float().mean() > 0.3
    for plane in ([0.1, 0.05, 2.0], [-0.05, 0.02, 8.0])[:phi.shape[0]]:
        assert (sparam - torch.tensor(plane)).abs().amax(dim=1).min() < 0.5


@pytest.mark.parametrize("phase", [0, 1, 2])
def test_resume_from_each_phase_is_bit_for_bit(tmp_path, monkeypatch, phase):
    """Interrupted after the checkpoint of phase 0 (seeds), 1 (first
    competition) or 2 (second seeding), a resumed run equals an uninterrupted
    one bit for bit, and the finished run removes its checkpoint."""
    d = _two_planes(rng=np.random.default_rng(42))
    full = _run(d)
    ck = str(tmp_path / "seg.npz")
    # the call that follows the phase's checkpoint, and its ordinal
    target, nth = {0: ("_region_competition", 1), 1: ("_generate_seeds", 2),
                   2: ("_region_competition", 2)}[phase]
    real = getattr(tseg, target)
    calls = {"n": 0}

    def interrupt(*a, **k):
        calls["n"] += 1
        if calls["n"] == nth:
            raise RuntimeError("simulated preemption")
        return real(*a, **k)

    monkeypatch.setattr(tseg, target, interrupt)
    with pytest.raises(RuntimeError, match="preemption"):
        _run(d, checkpoint_path=ck)
    monkeypatch.setattr(tseg, target, real)
    assert os.path.exists(ck)
    assert int(np.load(ck)["leaf_2"]) == phase  # leaves in sorted key order: fp, key, phase
    _equal(full, _run(d, checkpoint_path=ck))
    assert not os.path.exists(ck)


def test_stale_or_broken_checkpoint_is_ignored(tmp_path):
    d = _two_planes(rng=np.random.default_rng(42))
    ref = _run(d)
    ck = str(tmp_path / "seg.npz")
    importlib.import_module("pde_tpu_torch.utils.checkpoint").save_state(ck, {
        "phase": 2, "phi": np.full((1,) + d.shape, -1.0, np.float32),
        "sparam": np.zeros((1, 3), np.float32), "key": tseg.TorchDraws(0, "cpu").state(),
        "fp": np.zeros(40, np.uint8)})
    for _ in range(2):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            got = _run(d, checkpoint_path=ck)
        assert any("ignoring checkpoint" in str(w.message) for w in rec)
        _equal(ref, got)
        with open(ck, "wb") as f:  # the next round: a file that is no npz
            f.write(b"not a checkpoint")


def test_warm_start_neither_reads_nor_writes_a_checkpoint(tmp_path):
    d = _two_planes(32, 40, rng=np.random.default_rng(42))
    phi0 = -np.ones((1, 32, 40), np.float32)
    phi0[0, 4:28, 4:18] = 1.0
    ck = tmp_path / "seg.npz"
    ck.write_bytes(b"sentinel")
    a = _run(d, phi=phi0)
    b = _run(d, phi=phi0, checkpoint_path=str(ck))
    _equal(a, b)
    assert ck.read_bytes() == b"sentinel"


def test_collect_snapshots_each_phase():
    d = _two_planes(rng=np.random.default_rng(42))
    collect = []
    phi, seg, _ = _run(d, collect=collect)
    assert [n for n, _ in collect] == ["seeds", "competition1", "seeds2"]
    for _, s in collect:
        assert s.dtype == torch.int32 and s.shape == d.shape and int(s.max()) <= 2 * KW["seeds"]
    assert seg.shape == d.shape and int(seg.max()) <= phi.shape[0] + 1
    assert torch.equal(tseg._number_segments(phi), seg)


def test_device_rule(monkeypatch):
    """A numpy map without device= needs the card (raises here); a CPU
    tensor keeps its device and numpy phi and aa follow it; unknown
    parameters raise."""
    d = _two_planes(32, 40, rng=np.random.default_rng(42))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tseg.disp_segmentation(d, **KW)
    with pytest.raises(RuntimeError, match="CUDA"):
        tseg.disp_segmentation_sparse(d, **KW)
    phi0 = -np.ones((1, 32, 40), np.float32)
    phi0[0, 4:28, 4:18] = 1.0
    aa = np.ones((32, 40), np.float32)
    aa[:, :3] = 0.0
    out = tseg.disp_segmentation(torch.from_numpy(d), phi=phi0, aa=aa, **KW)
    assert all(x.device.type == "cpu" for x in out)
    with pytest.raises(TypeError, match="unknown"):
        tseg.disp_segmentation(d, iterations=3, **CPU)
