"""The port's ``flow_ad`` (anisotropic-tensor warping flow) held against
``pde_tpu``'s level by level (``collect=``) on the 36x44 shifted pair of
``tests/test_torch_flow_nd.py``, on the two finest levels, for both
diffusion tensors and both solvers: mean |Δflow| <= 1e-3 px at every
level, the bar ``pde_tpu`` sets between its own fused and per-level
paths. Plus the entry points that have no JAX counterpart to compare
with.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from pde_tpu_torch.kernels import sor_cuda, tdma_cuda

jad = importlib.import_module("pde_tpu.models.flow_ad")
tad = importlib.import_module("pde_tpu_torch.models.flow_ad")

torch.set_num_threads(1)

MEAN_TOL = 1e-3  # px, mean |Δflow| per level
# two levels, one warp and two reweightings each: 'flow' recomputes its
# tensor at the second
LOOPS = dict(firstLoop=1, secondLoop=2, scales=2)
CPU = dict(device="cpu")


def _shifted_pair(rng, h=36, w=44):
    """Smooth random pattern and its 1-px right-shifted copy (wrap)."""
    base = ndi.gaussian_filter(rng.random((h, w)).astype(np.float32), 3.0) * 255.0
    return base, np.roll(base, 1, axis=-1)


@pytest.mark.parametrize("diffusion", ["image", "flow"])
@pytest.mark.parametrize("solver", [1, 2])
def test_flow_ad_levels_match_reference(rng, diffusion, solver):
    it0, it1 = _shifted_pair(rng)
    kw = dict(LOOPS, diffusion=diffusion, solver=solver)
    want, got = [], []
    jad.flow_ad(it0, it1, "grad", "gradmag", collect=want, **kw)
    before = (dict(sor_cuda.LAUNCHES), dict(tdma_cuda.LAUNCHES))
    u, v = tad.flow_ad(it0, it1, "grad", "gradmag", collect=got, **CPU, **kw)
    assert (sor_cuda.LAUNCHES, tdma_cuda.LAUNCHES) == before
    assert len(want) == len(got) == 2
    for (uj, vj), (ut, vt) in zip(want, got):
        uj, vj, ut, vt = np.asarray(uj), np.asarray(vj), ut.numpy(), vt.numpy()
        assert ut.shape == uj.shape and np.isfinite(ut).all() and np.isfinite(vt).all()
        err = float(np.mean(np.hypot(ut - uj, vt - vj)))
        assert err <= MEAN_TOL, err
    assert u is got[-1][0] and v is got[-1][1]


def test_flow_ad_fused_is_flow_ad(rng):
    it0, it1 = _shifted_pair(rng, 24, 28)
    p = tad.FlowADParams(**LOOPS)
    u, v = tad.flow_ad(it0, it1, "grad", "none", p, **CPU)
    uf, vf = tad.flow_ad_fused(torch.from_numpy(it0), torch.from_numpy(it1), "grad", "none", p)
    assert uf.device.type == "cpu" and uf.shape == (24, 28)
    np.testing.assert_array_equal(uf.numpy(), u.numpy())
    np.testing.assert_array_equal(vf.numpy(), v.numpy())


def test_params_round_trip_with_reference():
    ref = jad.FlowADParams(quantile=0.8, diffusion="flow", iter=3)
    port = tad.params_from_reference(ref)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert jad.FlowADParams(**dataclasses.asdict(port)) == ref
    assert dataclasses.asdict(tad.FlowADParams()) == dataclasses.asdict(jad.FlowADParams())
    with pytest.raises(TypeError, match="bogus"):
        tad.params_from_reference({"alpha": 0.1, "bogus": 2})


def test_other_solver_and_numpy_without_device_raise(rng, monkeypatch):
    it0, it1 = _shifted_pair(rng, 24, 28)
    with pytest.raises(ValueError, match="solver=3"):
        tad.flow_ad(it0, it1, solver=3, **CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in (tad.flow_ad, tad.flow_ad_fused):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(it0, it1)
