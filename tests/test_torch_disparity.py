"""The port's stereo models held against ``pde_tpu``'s level by level
(``collect=``) on a 36x44 shifted pair at reduced loop counts: mean |ΔU|
<= 1e-3 px at every level, the bar ``pde_tpu`` sets between its own fused
and per-level paths. Plus the entry points that have no JAX counterpart
to compare with, and the device rule.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from pde_tpu_torch.kernels import interior_cuda

# the packages' models/__init__ export the function disparity_sym under
# the module's name, so fetch the modules themselves
jdisp = importlib.import_module("pde_tpu.models.disparity")
tdisp = importlib.import_module("pde_tpu_torch.models.disparity")
jsym = importlib.import_module("pde_tpu.models.disparity_sym")
tsym = importlib.import_module("pde_tpu_torch.models.disparity_sym")

torch.set_num_threads(1)

MEAN_TOL = 1e-3  # px, mean |ΔU| per level
LOOPS = dict(firstLoop=2, secondLoop=2, iter=3)
# the three coarsest levels: each level is a JAX compilation of its own
LEVELS = dict(LOOPS, scales=3)
CPU = dict(device="cpu")


def _shifted_pair(rng, h=36, w=44, dx=2.0, channels=None):
    """Smooth random pattern and its right-shifted copy (wrap), 0..255."""
    shape = (h, w) if channels is None else (channels, h, w)
    sigma = 3.0 if channels is None else (0.0, 3.0, 3.0)
    base = ndi.gaussian_filter(rng.random(shape).astype(np.float32), sigma) * 255.0
    return base, np.roll(base, int(dx), axis=-1)


def _mean_diff(want, got) -> float:
    want, got = np.asarray(want), got.numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.mean(np.abs(got - want)))


def _levels_agree(want, got):
    assert len(want) == len(got) == 3
    for uj, ut in zip(want, got):
        err = _mean_diff(uj, ut)
        assert err <= MEAN_TOL, err


@pytest.mark.parametrize("snd,channels,prior", [
    ("none", None, False),
    ("gradmag", 3, False),
    ("gradmag", None, True),
])
def test_disparity_nd_levels_match_reference(rng, snd, channels, prior):
    il, ir = _shifted_pair(rng, channels=channels)
    us = None
    if prior:
        us = np.full((36, 44), 1.5, np.float32)
        us[3, 4] = np.nan  # NaN in a prior is read as 0
    want, got = [], []
    jdisp.disparity_nd(il, ir, "grad", snd, us=us, collect=want, **LEVELS)
    u = tdisp.disparity_nd(il, ir, "grad", snd, us=us, collect=got, **CPU, **LEVELS)
    _levels_agree(want, got)
    assert u is got[-1]


def test_disparity_pcg_levels_match_reference(rng):
    """solver=2: disparity_nd's 2-D PCG (pde_tpu with its secondLoop as a
    fori_loop, which computes the same) and disparity_sym's pair, one PCG
    whose CG scalars are per field (pde_tpu vmaps it), on the two finest
    levels."""
    il, ir = _shifted_pair(rng, channels=3)
    want, got = [], []
    jdisp.disparity_nd(il, ir, "grad", "gradmag", collect=want, solver=2, scales=2,
                       fori=True, **LOOPS)
    tdisp.disparity_nd(il, ir, "grad", "gradmag", collect=got, solver=2, scales=2, **CPU,
                       **LOOPS)
    assert len(want) == len(got) == 2
    for uj, ut in zip(want, got):
        assert _mean_diff(uj, ut) <= MEAN_TOL
    loops = dict(firstLoop=1, secondLoop=1, iter=3, solver=2, scales=2)
    want, got = [], []
    jsym.disparity_sym(il, ir, collect=want, **loops)
    tsym.disparity_sym(il, ir, collect=got, **CPU, **loops)
    assert len(want) == len(got) == 2
    for (u0j, u1j), (u0t, u1t) in zip(want, got):
        assert _mean_diff(u0j, u0t) <= MEAN_TOL
        assert _mean_diff(u1j, u1t) <= MEAN_TOL


def test_disparity_sym_levels_match_reference(rng):
    il, ir = _shifted_pair(rng, channels=3)
    want, got = [], []
    jsym.disparity_sym(il, ir, collect=want, **LEVELS)
    out = tsym.disparity_sym(il, ir, collect=got, **CPU, **LEVELS)
    assert len(want) == len(got) == 3
    for (u0j, u1j), (u0t, u1t) in zip(want, got):
        assert _mean_diff(u0j, u0t) <= MEAN_TOL
        assert _mean_diff(u1j, u1t) <= MEAN_TOL
    assert out.shape == (2, 36, 44)
    np.testing.assert_array_equal(out[0].numpy(), got[-1][0].numpy())


def test_disparity_nd_recovers_shift_on_cpu_without_kernel(rng):
    """Tensors on the CPU take the CPU path; default loop counts."""
    il, ir = _shifted_pair(rng)
    before = dict(interior_cuda.LAUNCHES)
    u = tdisp.disparity_nd(torch.from_numpy(il), torch.from_numpy(ir), "grad", "none")
    assert u.device.type == "cpu" and u.dtype == torch.float32 and u.shape == (36, 44)
    assert abs(float(u[8:-8, 8:-8].median()) - 2.0) < 0.5
    assert interior_cuda.LAUNCHES == before


def test_warp_window_param_matches_gather_path(rng):
    """The true shift is 2 px, inside r=6."""
    il, ir = _shifted_pair(rng, 24, 28)
    u1 = tdisp.disparity_nd(il, ir, "grad", "none", **CPU, **LOOPS)
    u2 = tdisp.disparity_nd(il, ir, "grad", "none", warp_window=6, **CPU, **LOOPS)
    np.testing.assert_allclose(u1.numpy(), u2.numpy(), atol=1e-3)


def test_aliases_equal_disparity_nd(rng):
    il, ir = _shifted_pair(rng, 24, 28)
    p = tdisp.DisparityParams(**LOOPS)
    u = tdisp.disparity_nd(il, ir, "grad", "none", p, **CPU).numpy()
    for alias in (tdisp.disparity_nd_fused, tdisp.disparity_nd_split,
                  tdisp.disparity_nd_chunked, tdisp.disparity_nd_hybrid):
        np.testing.assert_array_equal(alias(il, ir, "grad", "none", p, **CPU).numpy(), u)
    sp = tsym.DisparitySymParams(firstLoop=1, secondLoop=1, iter=2)
    np.testing.assert_array_equal(tsym.disparity_sym_fused(il, ir, sp, **CPU).numpy(),
                                  tsym.disparity_sym(il, ir, sp, **CPU).numpy())


@pytest.mark.parametrize("jmod,tmod,cls,kw", [
    (jdisp, tdisp, "DisparityParams", dict(alpha=0.05, iter=3, warp_window=2, fori=True)),
    (jsym, tsym, "DisparitySymParams", dict(beta=0.3, secondLoop=2)),
])
def test_params_round_trip_with_reference(jmod, tmod, cls, kw):
    ref = getattr(jmod, cls)(**kw)
    port = tmod.params_from_reference(ref)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert getattr(jmod, cls)(**dataclasses.asdict(port)) == ref
    assert dataclasses.asdict(getattr(tmod, cls)()) == dataclasses.asdict(getattr(jmod, cls)())
    with pytest.raises(TypeError, match="bogus"):
        tmod.params_from_reference({"alpha": 0.1, "bogus": 2})


def test_unknown_override_and_unported_solver_raise(rng):
    il, ir = _shifted_pair(rng, 24, 28)
    with pytest.raises(TypeError, match="bogus"):
        tdisp.disparity_nd(il, ir, bogus=1, **CPU)
    # solver 1 and 2 are ported; any other raises
    with pytest.raises(ValueError, match="solver=3"):
        tdisp.disparity_nd(il, ir, solver=3, **CPU)
    with pytest.raises(ValueError, match="solver=0"):
        tsym.disparity_sym(il, ir, solver=0, **CPU)


def test_numpy_input_without_device_needs_cuda(rng, monkeypatch):
    """A numpy input runs on the card unless device= says otherwise; with
    no card that raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    il, ir = _shifted_pair(rng, 24, 28)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdisp.disparity_nd(il, ir)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsym.disparity_sym(il, ir)
