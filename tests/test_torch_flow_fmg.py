"""The port's FAS full-multigrid flow (``pde_tpu_torch/models/flow_fmg.py``)
held against ``pde_tpu``'s: its building blocks (derivative and constancy
tensors, restriction, the smoothing and residual pass) and the whole
pipeline level by level through ``collect=``, with both solvers (2: the
line-implicit PCG, the default; 1: red-black elin4 SOR) and both cycle
indices (1: V, 2: W) on a 3-channel 40x48 pair (three levels: 40x48,
20x24, 10x12), and once at default parameters on the gray pair
``tests/test_models.py`` runs. Bound: mean |Δflow| <= 1e-3 px a level, the
bar ``pde_tpu`` sets between its own fused and per-level paths; 1e-5 of
the range for the per-op tensors.

The level-by-level runs take ``pde_tpu``'s ``flow_fmg`` with its per-level
FAS-cycle program left un-jitted (its solvers and operators stay jitted,
compiled once a shape): the same code, without a compilation of every
level's whole cycle. A W-cycle with the SOR smoother at default counts
amplifies last-bit differences, so ``pde_tpu``'s jitted program disagrees
with that run by more than the bar (ROADMAP queue 3, F7); the loop counts
of each case are ones where the reference agrees with itself, and
``test_sor_w_cycle_amplifies_rounding`` measures F7.
"""

import importlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from pde_tpu_torch.kernels import resident_cuda, sor_cuda, tdma_cuda

jfmg = importlib.import_module("pde_tpu.models.flow_fmg")
tfmg = importlib.import_module("pde_tpu_torch.models.flow_fmg")

torch.set_num_threads(1)

MEAN_TOL = 1e-3  # px, mean |Δflow|
OP_TOL = 1e-5    # per op, unit-scale fields
REDUCED = dict(firstLoop=1, iter=2)
CPU = dict(device="cpu")


def _pair(rng, channels=3, h=40, w=48):
    """A smooth random colour pattern and its 1-px right-shifted copy (wrap),
    0..255."""
    shape = (channels, h, w) if channels else (h, w)
    sigma = (0.0, 3.0, 3.0) if channels else 3.0
    base = ndi.gaussian_filter(rng.random(shape).astype(np.float32), sigma) * 255.0
    return base, np.roll(base, 1, axis=-1)


def _mean_diff(want, got) -> float:
    (uj, vj), (ut, vt) = want, got
    uj, vj, ut, vt = np.asarray(uj), np.asarray(vj), ut.numpy(), vt.numpy()
    assert ut.shape == uj.shape and np.isfinite(ut).all() and np.isfinite(vt).all()
    return float(np.mean(np.hypot(ut - uj, vt - vj)))


def _t(x):
    return torch.from_numpy(np.array(x))


def test_pyramid_tensors_and_restriction_match_reference(rng):
    """The derivative and constancy tensors of a level (0..255 input, the
    /255 in the temporal kernels) and the full-weighting restriction."""
    it0, it1 = _pair(rng)
    p = jfmg.FlowFMGParams()
    tj = jfmg._derivative_tensors(jnp.asarray(it0), jnp.asarray(it1), p)
    tt = tfmg._derivative_tensors(_t(it0), _t(it1), tfmg.FlowFMGParams())
    cj, ct = jfmg._constancy(tj, p), tfmg._constancy(tt, tfmg.FlowFMGParams())
    for name in list(tj) + list(cj):
        want, got = (tj[name], tt[name]) if name in tj else (cj[name], ct[name])
        scale = max(float(np.abs(np.asarray(want)).max()), 1.0)
        np.testing.assert_allclose(got.numpy() / scale, np.asarray(want) / scale, atol=OP_TOL,
                                   rtol=0, err_msg=name)
    x = rng.random((3, 41, 47)).astype(np.float32)
    got = tfmg._restrict(_t(x), 0.5)
    assert got.shape == (3, 21, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(jfmg._restrict(jnp.asarray(x), 0.5)),
                               atol=OP_TOL, rtol=0)


@pytest.mark.parametrize("solver", [2, 1])
def test_smooth_and_residual_pass_match_reference(rng, solver):
    """``_smooth`` with the residual pass: gd with the channel factor in the
    smoothing, without it in the residuals."""
    it0, it1 = _pair(rng)
    pj = jfmg.FlowFMGParams(solver=solver, **REDUCED)
    pt = tfmg.FlowFMGParams(solver=solver, **REDUCED)
    tj = jfmg._derivative_tensors(jnp.asarray(it0), jnp.asarray(it1), pj)
    tt = tfmg._derivative_tensors(_t(it0), _t(it1), pt)
    cj, ct = jfmg._constancy(tj, pj), tfmg._constancy(tt, pt)
    u0 = (rng.random((40, 48)).astype(np.float32) - 0.5) * 0.5
    v0 = (rng.random((40, 48)).astype(np.float32) - 0.5) * 0.5
    want = jfmg._smooth(jnp.asarray(u0), jnp.asarray(v0), tj, cj, cj["cu"], cj["cv"], pj, True)
    got = tfmg._smooth(_t(u0), _t(v0), tt, ct, ct["cu"], ct["cv"], pt, True)
    assert _mean_diff(want[:2], got[:2]) <= MEAN_TOL
    for r_want, r_got in zip(want[2:], got[2:]):
        scale = max(float(np.abs(np.asarray(r_want)).max()), 1.0)
        assert float(np.abs(r_got.numpy() - np.asarray(r_want)).mean()) / scale <= MEAN_TOL


def _contrast_pair(rng):
    """A 3-channel 40x48 pattern stretched to 0..255 and its 1-px
    right-shifted copy (wrap)."""
    base = ndi.gaussian_filter(rng.random((3, 40, 48)).astype(np.float32), (0.0, 2.0, 2.0))
    base = (base - base.min()) / (base.max() - base.min()) * 255.0
    return base, np.roll(base, 1, axis=-1)


def _reference_levels(monkeypatch, it0, it1, **kw):
    """``pde_tpu``'s ``flow_fmg`` with its FAS-cycle program un-jitted; the
    (U, V) of each top-level cycle, coarsest first."""
    with monkeypatch.context() as m:
        m.setattr(jfmg, "jax", types.SimpleNamespace(jit=lambda fn, **_: fn))
        out = []
        jfmg.flow_fmg(it0, it1, collect=out, **kw)
    return out


def _port_levels(it0, it1, **kw):
    before = (dict(sor_cuda.LAUNCHES), dict(tdma_cuda.LAUNCHES), dict(resident_cuda.LAUNCHES))
    out = []
    last = tfmg.flow_fmg(it0, it1, collect=out, **kw, **CPU)
    assert (sor_cuda.LAUNCHES, tdma_cuda.LAUNCHES, resident_cuda.LAUNCHES) == before
    assert last[0] is out[-1][0] and last[0].device.type == "cpu"
    return out


# (solver, cycle_index, firstLoop, iter): reduced counts, and the default
# counts for the PCG W-cycle, whose reduced run diverges on this 1-px pair
# (a median |U| of many px) and disagrees with itself
LEVEL_CASES = [(2, 1, 1, 2), (1, 1, 1, 2), (2, 2, 4, 4), (1, 2, 1, 2)]


@pytest.mark.parametrize("solver,cycle_index,first_loop,iters", LEVEL_CASES)
def test_flow_fmg_levels_match_reference(rng, monkeypatch, solver, cycle_index, first_loop,
                                         iters):
    """Level by level through ``collect=`` (coarsest first), three levels."""
    it0, it1 = _contrast_pair(rng)
    kw = dict(solver=solver, cycle_index=cycle_index, firstLoop=first_loop, iter=iters)
    want = _reference_levels(monkeypatch, it0, it1, **kw)
    got = _port_levels(it0, it1, **kw)
    assert [tuple(u.shape) for u, _ in got] == [(10, 12), (20, 24), (40, 48)]
    for lvl, (w_, g_) in enumerate(zip(want, got)):
        assert _mean_diff(w_, g_) <= MEAN_TOL, f"level {lvl}"


def test_sor_w_cycle_amplifies_rounding(rng, monkeypatch):
    """F7: the SOR W-cycle at default counts amplifies last-bit differences.
    ``pde_tpu``'s jitted program and its un-jitted cycle differ by more than
    the bar at the finest level, while both agree with the port at the
    coarser levels; at the finest the port lies as close to the jitted
    program as the un-jitted run does (within twice its distance)."""
    it0, it1 = _contrast_pair(rng)
    kw = dict(solver=1, cycle_index=2)
    jitted = []
    jfmg.flow_fmg(it0, it1, collect=jitted, **kw)
    unjitted = _reference_levels(monkeypatch, it0, it1, **kw)
    got = _port_levels(it0, it1, **kw)
    self_diff = _mean_diff(jitted[-1], tuple(torch.from_numpy(np.array(x)) for x in unjitted[-1]))
    port_diffs = [_mean_diff(w_, g_) for w_, g_ in zip(jitted, got)]
    # the measurement ROADMAP F7 quotes (pytest -s shows it)
    print(f"F7: finest level, pde_tpu jitted vs un-jitted {self_diff:.3g} px; port vs jitted "
          f"per level (coarsest first) {[f'{d:.3g}' for d in port_diffs]} px")
    assert self_diff > MEAN_TOL
    for lvl in range(2):
        assert port_diffs[lvl] <= MEAN_TOL, f"level {lvl}"
    assert port_diffs[-1] <= 2 * self_diff


def test_flow_fmg_default_parameters_match_reference(rng):
    """Default parameters (the PCG smoother, V-cycle, firstLoop 4, iter 4)
    on the gray 40x48 pair of ``tests/test_models.py``'s fused check; tensor
    input keeps the CPU."""
    img = (rng.random((40, 48)) * 255).astype(np.float32)
    shifted = np.roll(img, 1, axis=1)
    want = jfmg.flow_fmg(img, shifted)
    got = tfmg.flow_fmg(torch.from_numpy(img), torch.from_numpy(shifted))
    assert got[0].shape == (40, 48) and got[0].device.type == "cpu"
    assert _mean_diff(want, got) <= MEAN_TOL


def test_flow_fmg_fused_is_flow_fmg_and_params_convert(rng):
    it0, it1 = _pair(rng, channels=None, h=24, w=28)
    p = tfmg.params_from_reference(jfmg.FlowFMGParams(firstLoop=1, iter=2, solver=1))
    assert p == tfmg.FlowFMGParams(firstLoop=1, iter=2, solver=1)
    a = tfmg.flow_fmg(it0, it1, p, **CPU)
    b = tfmg.flow_fmg_fused(it0, it1, p, **CPU)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(TypeError, match="unknown"):
        tfmg.params_from_reference({"secondLoop": 2})
    with pytest.raises(ValueError, match="solver"):
        tfmg.flow_fmg(it0, it1, solver=3, **CPU)


def test_flow_fmg_numpy_input_without_a_card_raises(rng, monkeypatch):
    """With no CUDA card, a numpy input without ``device=`` raises instead
    of running on the CPU."""
    it0, it1 = _pair(rng, channels=None, h=24, w=28)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfmg.flow_fmg(it0, it1, firstLoop=1, iter=1)
