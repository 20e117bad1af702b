"""The port's ``flow_nd`` held against ``pde_tpu``'s level by level
(``collect=``) on the 36x44 shifted pair of ``tests/test_models.py`` at
firstLoop = secondLoop = 2: mean |Δflow| <= 1e-3 px at every level, the
bar ``pde_tpu`` sets between its own fused and per-level paths. Plus the
entry points that have no JAX counterpart to compare with.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from pde_tpu_torch.kernels import sor_cuda, tdma_cuda

# the packages' models/__init__ export the function flow_nd under the
# module's name, so fetch the modules themselves
jflow = importlib.import_module("pde_tpu.models.flow_nd")
tflow = importlib.import_module("pde_tpu_torch.models.flow_nd")

torch.set_num_threads(1)

MEAN_TOL = 1e-3  # px, mean |Δflow| per level
LOOPS = dict(firstLoop=2, secondLoop=2)
CPU = dict(device="cpu")  # numpy inputs run on the card unless asked otherwise


def _shifted_pair(rng, h=36, w=44, dx=1.0, channels=None):
    """Smooth random pattern and its 1-px right-shifted copy (wrap)."""
    shape = (h, w) if channels is None else (channels, h, w)
    sigma = 3.0 if channels is None else (0.0, 3.0, 3.0)
    base = ndi.gaussian_filter(rng.random(shape).astype(np.float32), sigma) * 255.0
    return base, np.roll(base, int(dx), axis=-1)


def _levels_agree(want, got, min_levels=3):
    assert len(want) == len(got) >= min_levels
    for (uj, vj), (ut, vt) in zip(want, got):
        uj, vj, ut, vt = np.asarray(uj), np.asarray(vj), ut.numpy(), vt.numpy()
        assert ut.shape == uj.shape and np.isfinite(ut).all() and np.isfinite(vt).all()
        err = float(np.mean(np.hypot(ut - uj, vt - vj)))
        assert err <= MEAN_TOL, err


@pytest.mark.parametrize("fst,snd,channels", [
    ("grad", "none", None),
    ("grad", "gradmag", None),
    ("grad", "gradmag", 3),
    ("rgb", "rgb", 3),
])
def test_flow_nd_levels_match_reference(rng, fst, snd, channels):
    it0, it1 = _shifted_pair(rng, channels=channels)
    want, got = [], []
    jflow.flow_nd(it0, it1, fst, snd, collect=want, **LOOPS)
    u, v = tflow.flow_nd(it0, it1, fst, snd, collect=got, **CPU, **LOOPS)
    _levels_agree(want, got)
    assert u is got[-1][0] and v is got[-1][1]


def test_flow_nd_pcg_levels_match_reference(rng):
    """solver=2, the line-implicit PCG, at one warp and one reweighting per
    level on the two finest levels (each level is a JAX compilation)."""
    it0, it1 = _shifted_pair(rng)
    loops = dict(firstLoop=1, secondLoop=1, solver=2, scales=2)
    want, got = [], []
    jflow.flow_nd(it0, it1, "grad", "none", collect=want, **loops)
    before = dict(tdma_cuda.LAUNCHES)
    tflow.flow_nd(it0, it1, "grad", "none", collect=got, **CPU, **loops)
    assert tdma_cuda.LAUNCHES == before
    assert len(want) == len(got) == 2
    _levels_agree(want, got, min_levels=2)


def test_flow_nd_prior_levels_match_reference(rng):
    it0, it1 = _shifted_pair(rng)
    us = np.full((36, 44), 0.8, np.float32)
    vs = (rng.random((36, 44)) * 0.2 - 0.1).astype(np.float32)
    us[3, 4] = np.nan  # NaN in a prior is read as 0
    want, got = [], []
    jflow.flow_nd(it0, it1, "grad", "none", us=us, vs=vs, collect=want, **LOOPS)
    tflow.flow_nd(it0, it1, "grad", "none", us=us, vs=vs, collect=got, **CPU, **LOOPS)
    _levels_agree(want, got)


def test_flow_nd_recovers_shift_on_cpu_without_kernel(rng):
    """Default loop counts: the reduced ones stop well short of the shift."""
    it0, it1 = _shifted_pair(rng)
    before = dict(sor_cuda.LAUNCHES)
    u, v = tflow.flow_nd(torch.from_numpy(it0), torch.from_numpy(it1), "grad", "none")
    assert u.device.type == "cpu" and u.dtype == torch.float32 and u.shape == (36, 44)
    assert abs(float(u[8:-8, 8:-8].median()) - 1.0) < 0.3
    assert abs(float(v[8:-8, 8:-8].median())) < 0.2
    assert sor_cuda.LAUNCHES == before


def test_flow_nd_sequence_and_fused_match_pairs(rng):
    f0 = (rng.random((24, 28)) * 255).astype(np.float32)
    frames = np.stack([f0, np.roll(f0, 1, axis=1), np.roll(f0, 2, axis=1)])
    p = tflow.FlowNDParams(**LOOPS)
    us, vs = tflow.flow_nd_sequence(frames, "grad", "none", p, **CPU)
    assert us.shape == vs.shape == (2, 24, 28)
    for t in range(2):
        u, v = tflow.flow_nd(frames[t], frames[t + 1], "grad", "none", p, **CPU)
        np.testing.assert_allclose(us[t].numpy(), u.numpy(), atol=1e-6)
        np.testing.assert_allclose(vs[t].numpy(), v.numpy(), atol=1e-6)
    uf, vf = tflow.flow_nd_fused(frames[0], frames[1], "grad", "none", p, **CPU)
    np.testing.assert_allclose(uf.numpy(), us[0].numpy(), atol=1e-6)
    np.testing.assert_allclose(vf.numpy(), vs[0].numpy(), atol=1e-6)


def test_warp_window_param_matches_gather_path(rng):
    """The true shift is 1 px, far inside r=6."""
    it0, it1 = _shifted_pair(rng, 24, 28)
    u1, v1 = tflow.flow_nd(it0, it1, "grad", "none", **CPU, **LOOPS)
    u2, v2 = tflow.flow_nd(it0, it1, "grad", "none", warp_window=6, **CPU, **LOOPS)
    np.testing.assert_allclose(u1.numpy(), u2.numpy(), atol=1e-3)
    np.testing.assert_allclose(v1.numpy(), v2.numpy(), atol=1e-3)


def test_params_round_trip_with_reference():
    ref = jflow.FlowNDParams(alpha=0.05, iter=3, warp_window=2)
    port = tflow.params_from_reference(ref)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert jflow.FlowNDParams(**dataclasses.asdict(port)) == ref
    assert tflow.params_from_reference({"omega": 1.5}) == tflow.FlowNDParams(omega=1.5)
    assert dataclasses.asdict(tflow.FlowNDParams()) == dataclasses.asdict(jflow.FlowNDParams())
    with pytest.raises(TypeError, match="bogus"):
        tflow.params_from_reference({"alpha": 0.1, "bogus": 2})


def test_unknown_override_and_unported_solver_raise(rng):
    it0, it1 = _shifted_pair(rng, 24, 28)
    with pytest.raises(TypeError, match="bogus"):
        tflow.flow_nd(it0, it1, bogus=1, **CPU)
    # solver 1 and 2 are ported; any other raises
    with pytest.raises(ValueError, match="solver=3"):
        tflow.flow_nd(it0, it1, solver=3, **CPU)


@pytest.mark.parametrize("entry", ["flow_nd", "flow_nd_fused", "flow_nd_sequence"])
def test_numpy_input_without_device_needs_cuda(rng, monkeypatch, entry):
    """A numpy input runs on the card unless device= says otherwise; with
    no card that raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    it0, it1 = _shifted_pair(rng, 24, 28)
    args = (np.stack([it0, it1]),) if entry == "flow_nd_sequence" else (it0, it1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(tflow, entry)(*args)
