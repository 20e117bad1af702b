"""The plain 8-neighbour SOR solvers (``sor_flow_llin8`` and ``sor_pde8``
in ``pde_tpu_torch/solvers/sor.py``), the CUDA kernels' reference, held
against ``pde_tpu``'s XLA solvers and its Pallas stripe kernel in
interpret mode, with diagonal weights of both signs (the tensor stencil's
are negative where the image gradient is oblique); and the dispatch and
wrapper rules that can be checked without a card.

The kernels themselves run only on the card: ``chip_smoke.py`` compares
them with the plain versions there.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pde_tpu.kernels import sweeps
from pde_tpu.kernels.tiled import tiled_relax
from pde_tpu.solvers import sor as jsor
from pde_tpu_torch.kernels import build, dispatch, interior_cuda, sor_cuda
from pde_tpu_torch.solvers import sor

torch.set_num_threads(1)

ATOL = 1e-5
W8 = ("ww", "wnw", "wn", "wne", "we", "wse", "ws", "wsw")
DIAG = ("wnw", "wne", "wse", "wsw")
LLIN8 = ("u", "v", "du", "dv", "m", "cu", "cv", "duc", "dvc") + W8
PDE8 = ("x", "trace", "b") + W8


def _field(rng, name, shape):
    if name in ("duc", "dvc", "trace"):
        return rng.random(shape) + 1.0
    if name == "m":
        return rng.random(shape) * 0.01
    if name in DIAG:
        return rng.random(shape) * 0.3 - 0.15
    if name.startswith("w"):
        return rng.random(shape) + 0.1
    return rng.random(shape) * 0.2


def _fields(rng, names, shape, nan_names=(), shared=()):
    """Unit-scale solver fields as in tests/test_kernels.py, diagonal
    weights in [-0.15, 0.15); 5% NaN in ``nan_names``; the names in
    ``shared`` are one (H, W) plane. TRACE exceeds the weights' absolute
    sum, as tv_denoise8's does (PsiData + alpha Σw, the tensor keeping the
    axis weights above the diagonal ones), so the iterates stay
    unit-scale."""
    out = {n: _field(rng, n, shape[-2:] if n in shared else shape) for n in names}
    if "trace" in out:
        out["trace"] = out["trace"] + sum(np.abs(out[n]) for n in W8)
    for n in nan_names:
        out[n] = np.where(rng.random(out[n].shape) < 0.05, np.nan, out[n])
    return [out[n].astype(np.float32) for n in names]


def _t(fields):
    return [torch.from_numpy(f) for f in fields]


def _close(got, want):
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, w_ in zip(got, want):
        g, w_ = g.numpy(), np.asarray(w_)
        assert g.shape == w_.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w_, atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape", [(37, 53), (1, 9), (9, 1), (2, 2)])
@pytest.mark.parametrize("nan_names", [(), ("cu", "duc"), ("cu", "cv", "duc", "dvc")])
def test_plain_llin8_matches_xla_solver(rng, shape, nan_names):
    """Every pixel is relaxed, so 1xN and Nx1 systems are edges only."""
    f = _fields(rng, LLIN8, shape, nan_names)
    want = jsor.sor_flow_llin8(*(jnp.asarray(x) for x in f), 5, 1.9)
    _close(sor.sor_flow_llin8(*_t(f), 5, 1.9), want)


@pytest.mark.parametrize("shape", [(37, 53), (48, 65)])
def test_plain_llin8_matches_stripe_pallas_kernel(rng, shape):
    """3- or 4-stripe plan with k=2 sweeps per pass, iters % k != 0."""
    u, v, du, dv, *const = _fields(rng, LLIN8, shape, ("cu", "duc"))
    prepare, sweep = sweeps.flow_llin8_sweep(1.9)
    want = tiled_relax(tuple(jnp.asarray(x) for x in (du, dv, u, v, *const)), sweep, 2, 5,
                       prepare_fn=prepare, interpret=True, plan_override=(2, 16))
    _close(sor.sor_flow_llin8(*_t([u, v, du, dv, *const]), 5, 1.9), tuple(want))


@pytest.mark.parametrize("shape", [(37, 53), (3, 37, 53), (2, 9), (3, 3)])
@pytest.mark.parametrize("nan", [False, True])
def test_plain_pde8_matches_xla_solver(rng, shape, nan):
    f = _fields(rng, PDE8, shape, ("trace",) if nan else ())
    want = jsor.sor_pde8(*(jnp.asarray(x) for x in f), 5, 1.75)
    _close(sor.sor_pde8(*_t(f), 5, 1.75), want)


@pytest.mark.parametrize("nan", [False, True])
def test_plain_pde8_shared_weights_match_xla_solver(rng, nan):
    """(C, H, W) unknowns with one (H, W) plane per weight, as tv_denoise8
    hands them over."""
    f = _fields(rng, PDE8, (3, 21, 30), ("trace",) if nan else (), shared=W8)
    want = jsor.sor_pde8(*(jnp.asarray(x) for x in f), 4, 1.75)
    _close(sor.sor_pde8(*_t(f), 4, 1.75), want)


@pytest.mark.parametrize("shape", [(37, 53), (48, 65)])
def test_plain_pde8_matches_stripe_pallas_kernel(rng, shape):
    f = _fields(rng, PDE8, shape, ("trace",))
    prepare, sweep = sweeps.pde8_sweep(1.75)
    (want,) = tiled_relax(tuple(jnp.asarray(x) for x in f), sweep, 1, 5,
                          prepare_fn=prepare, interpret=True, plan_override=(2, 16))
    _close(sor.sor_pde8(*_t(f), 5, 1.75), want)


def test_diagonal_neighbours_update_as_jacobi_within_a_colour():
    """One colour's pixels see the state before their half-sweep: a lone
    non-zero pixel of colour 0 with only diagonal weights leaves its
    colour-0 diagonal neighbours at the value they get from the old state,
    whatever order the pixels are visited in."""
    h, w = 7, 7
    x = torch.zeros((h, w))
    x[3, 3] = 1.0
    zero = torch.zeros((h, w))
    diag = torch.full((h, w), 0.25)
    trace = torch.ones((h, w))
    out = sor.sor_pde8(x, trace, zero, zero, diag, zero, diag, zero, diag, zero, diag, 1, 1.0)
    # colour 0 relaxes (3, 3) to 0 and its diagonals to 0.25 in the same
    # half-sweep, from the old x; colour 1 has no diagonal coupling to them
    assert float(out[3, 3]) == 0.0
    for i, j in ((2, 2), (2, 4), (4, 2), (4, 4)):
        assert float(out[i, j]) == 0.25


@pytest.mark.parametrize("system", ["llin8", "pde8"])
def test_dispatch_cpu_is_plain_and_launches_nothing(rng, system):
    before = (dict(sor_cuda.LAUNCHES), dict(interior_cuda.LAUNCHES))
    if system == "llin8":
        args = _t(_fields(rng, LLIN8, (21, 30), ("cu",)))
        got, want = dispatch.sor_flow_llin8(*args, 4, 1.9), sor.sor_flow_llin8(*args, 4, 1.9)
        with dispatch.plain_solvers():
            forced = dispatch.sor_flow_llin8(*args, 4, 1.9)
    else:
        args = _t(_fields(rng, PDE8, (3, 21, 30), ("trace",), shared=W8))
        got, want = dispatch.sor_pde8(*args, 4, 1.75), sor.sor_pde8(*args, 4, 1.75)
        with dispatch.plain_solvers():
            forced = dispatch.sor_pde8(*args, 4, 1.75)
    got, want, forced = ((x,) if torch.is_tensor(x) else x for x in (got, want, forced))
    for g, f_, w_ in zip(got, forced, want):
        np.testing.assert_array_equal(g.numpy(), w_.numpy())
        np.testing.assert_array_equal(f_.numpy(), w_.numpy())
    assert (sor_cuda.LAUNCHES, interior_cuda.LAUNCHES) == before


def _no_build(name):
    raise AssertionError("the wrapper must check its inputs before it builds")


def test_cuda_wrappers_reject_cpu_tensors_before_building(rng, monkeypatch):
    monkeypatch.setattr(build, "load", _no_build)
    before = (dict(sor_cuda.LAUNCHES), dict(interior_cuda.LAUNCHES))
    with pytest.raises(ValueError, match="CUDA"):
        sor_cuda.flow_llin8_sor(*_t(_fields(rng, LLIN8, (8, 9))), 4, 1.9)
    with pytest.raises(ValueError, match="CUDA"):
        interior_cuda.pde8_sor(*_t(_fields(rng, PDE8, (8, 9))), 4, 1.75)
    assert (sor_cuda.LAUNCHES, interior_cuda.LAUNCHES) == before


@pytest.mark.parametrize("shape", [(1, 9), (9, 1), (2, 1, 9)])
def test_pde8_wrapper_rejects_h_or_w_of_one(monkeypatch, shape):
    """As pde4_sor: the plain version's border fill empties an H or W of
    1, so the kernel takes H, W >= 2 only, checked before the device."""
    monkeypatch.setattr(build, "load", _no_build)
    x = torch.zeros(shape)
    with pytest.raises(ValueError, match="H, W >= 2"):
        interior_cuda.pde8_sor(*([x] * 11), 4, 1.75)
