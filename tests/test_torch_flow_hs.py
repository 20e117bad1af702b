"""The port's Horn & Schunck flow (``pde_tpu_torch/models/flow_hs.py``) held
against ``pde_tpu``'s with both solvers (2: the line-implicit PCG, the
default; 1: red-black elin4 SOR): each pyramid level's solve from the
reference's input to it and the whole result, on a 3-channel pair over two
levels and a 2-D pair on one (each level is a JAX compilation). Bound:
mean |Δflow| <= 1e-3 px, the bar ``pde_tpu`` sets between its own fused
and per-level paths.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from pde_tpu.core.pyramid import build_pyramid as jbuild_pyramid
from pde_tpu_torch.kernels import sor_cuda, tdma_cuda

jhs = importlib.import_module("pde_tpu.models.flow_hs")
ths = importlib.import_module("pde_tpu_torch.models.flow_hs")

torch.set_num_threads(1)

MEAN_TOL = 1e-3  # px, mean |Δflow|
CPU = dict(device="cpu")


def _shifted_pair(rng, h, w, channels=None, dx=1.0):
    """Smooth random pattern and its 1-px right-shifted copy (wrap), 0..255."""
    shape = (h, w) if channels is None else (channels, h, w)
    sigma = 3.0 if channels is None else (0.0, 3.0, 3.0)
    base = ndi.gaussian_filter(rng.random(shape).astype(np.float32), sigma) * 255.0
    return base, np.roll(base, int(dx), axis=-1)


def _mean_diff(want, got) -> float:
    (uj, vj), (ut, vt) = want, got
    uj, vj, ut, vt = np.asarray(uj), np.asarray(vj), ut.numpy(), vt.numpy()
    assert ut.shape == uj.shape and np.isfinite(ut).all() and np.isfinite(vt).all()
    return float(np.mean(np.hypot(ut - uj, vt - vj)))


@pytest.mark.parametrize("solver", [2, 1])
def test_flow_hs_levels_match_reference(rng, solver):
    it0, it1 = _shifted_pair(rng, 28, 32, channels=3)
    p = ths.FlowHSParams(solver=solver, scales=2)
    levels = jbuild_pyramid([jnp.asarray(it0) / 255.0, jnp.asarray(it1) / 255.0],
                            p.scl_factor, 20, 5, 1.25, p.scales)
    assert len(levels) == 2
    u = v = jnp.zeros(levels[-1][0].shape[-2:], jnp.float32)
    for l0, l1 in reversed(levels):
        if u.shape != l0.shape[-2:]:
            u, v = (jhs.imresize(jhs.medfilt2_3x3(x / p.scl_factor), l0.shape[-2:], "bicubic")
                    for x in (u, v))
        got = ths._hs_level(*(torch.from_numpy(np.array(x)) for x in (u, v, l0, l1)),
                            p.alpha * 3, p.b1, p.b2, p.omega, p.iter, p.solver)
        u, v = jhs._hs_level(u, v, l0, l1, p.alpha * 3, p.b1, p.b2, p.omega, p.iter,
                             p.solver)
        assert _mean_diff((u, v), got) <= MEAN_TOL
    before = (dict(sor_cuda.LAUNCHES), dict(tdma_cuda.LAUNCHES))
    want = jhs.flow_hs(it0, it1, solver=solver, scales=2)
    got = ths.flow_hs(it0, it1, solver=solver, scales=2, **CPU)
    assert got[0].device.type == "cpu" and got[0].shape == (28, 32)
    assert _mean_diff(want, got) <= MEAN_TOL
    assert (sor_cuda.LAUNCHES, tdma_cuda.LAUNCHES) == before


@pytest.mark.parametrize("solver", [2, 1])
def test_flow_hs_2d_matches_reference(rng, solver):
    it0, it1 = _shifted_pair(rng, 28, 32)
    want = jhs.flow_hs(it0, it1, solver=solver, scales=1)
    got = ths.flow_hs(torch.from_numpy(it0), torch.from_numpy(it1), solver=solver, scales=1)
    assert _mean_diff(want, got) <= MEAN_TOL


def test_flow_hs_recovers_shift_on_cpu(rng):
    """Default parameters (the PCG) and a CPU tensor in: the 1-px shift."""
    it0, it1 = _shifted_pair(rng, 36, 44)
    u, v = ths.flow_hs(torch.from_numpy(it0), torch.from_numpy(it1))
    assert u.device.type == "cpu" and u.dtype == torch.float32
    assert abs(float(u[8:-8, 8:-8].median()) - 1.0) < 0.3
    assert abs(float(v[8:-8, 8:-8].median())) < 0.2


def test_params_round_trip_with_reference():
    ref = jhs.FlowHSParams(alpha=0.3, iter=7, solver=1)
    port = ths.params_from_reference(ref)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert jhs.FlowHSParams(**dataclasses.asdict(port)) == ref
    assert dataclasses.asdict(ths.FlowHSParams()) == dataclasses.asdict(jhs.FlowHSParams())
    with pytest.raises(TypeError, match="bogus"):
        ths.params_from_reference({"alpha": 0.1, "bogus": 2})


def test_unknown_solver_and_numpy_without_device_raise(rng, monkeypatch):
    it0, it1 = _shifted_pair(rng, 24, 28)
    with pytest.raises(ValueError, match="solver=3"):
        ths.flow_hs(it0, it1, solver=3, **CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ths.flow_hs(it0, it1)
