"""The plain interior-update SOR solvers (``sor_disp_llin4``,
``sor_disp_llin_sym4``, ``sor_pde4`` in ``pde_tpu_torch/solvers/sor.py``),
the CUDA kernel's reference, held against ``pde_tpu``'s XLA solvers and
its Pallas stripe kernel in interpret mode; ``warp_x_window``; and the
dispatch and wrapper rules that can be checked without a card.

The kernel itself runs only on the card: ``chip_smoke.py`` compares it with
the plain version there.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pde_tpu.kernels import sweeps
from pde_tpu.kernels.tiled import tiled_relax
from pde_tpu.ops import warp as jwarp
from pde_tpu.solvers import sor as jsor
from pde_tpu_torch.kernels import build, dispatch, interior_cuda
from pde_tpu_torch.ops import warp
from pde_tpu_torch.solvers import sor

torch.set_num_threads(1)

ATOL = 1e-5
DISP = ("u", "du", "cu", "duc", "ww", "wn", "we", "ws")
PDE4 = ("x", "trace", "b", "ww", "wn", "we", "ws")
# odd shapes, a 2-row and a 2-column system (border only), a 3x3 one
SHAPES = [(37, 53), (40, 33), (2, 9), (9, 2), (3, 3)]


def _field(rng, name, shape):
    if name in ("duc", "trace"):
        return rng.random(shape) + 1.0
    if name.startswith("w"):
        return rng.random(shape) + 0.1
    return rng.random(shape) * 0.2


def _fields(rng, names, shape, nan_names=(), shared=()):
    """Unit-scale solver fields as in tests/test_kernels.py; 5% NaN in
    ``nan_names``; the names in ``shared`` are one (H, W) plane. TRACE
    exceeds the weights' sum, as tv_denoise4's does (PsiData + Σw), so the
    pde4 iterates stay unit-scale."""
    out = {n: _field(rng, n, shape[-2:] if n in shared else shape) for n in names}
    if "trace" in out:
        out["trace"] = out["trace"] + sum(out[n] for n in ("ww", "wn", "we", "ws"))
    for n in nan_names:
        out[n] = np.where(rng.random(out[n].shape) < 0.05, np.nan, out[n])
    return [out[n].astype(np.float32) for n in names]


def _close(got, want):
    g, w_ = got.numpy(), np.asarray(want)
    assert g.shape == w_.shape and np.isfinite(g).all()
    np.testing.assert_allclose(g, w_, atol=ATOL, rtol=0)


def _t(fields):
    return [torch.from_numpy(f) for f in fields]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("nan", [False, True])
def test_plain_disp_matches_xla_solver(rng, shape, nan):
    f = _fields(rng, DISP, shape, ("cu", "duc") if nan else ())
    want = jsor.sor_disp_llin4(*(jnp.asarray(x) for x in f), 5, 1.9)
    _close(sor.sor_disp_llin4(*_t(f), 5, 1.9), want)


@pytest.mark.parametrize("shape", [(37, 53), (2, 9)])
def test_plain_disp_sym_matches_xla_solver(rng, shape):
    f0 = _fields(rng, DISP, shape, ("cu", "duc"))
    f1 = _fields(rng, DISP, shape, ("cu",))
    want = jsor.sor_disp_llin_sym4(*(jnp.asarray(x) for x in f0 + f1), 4, 1.9)
    got = sor.sor_disp_llin_sym4(*_t(f0 + f1), 4, 1.9)
    for g, w_ in zip(got, want):
        _close(g, w_)


@pytest.mark.parametrize("shape", SHAPES + [(3, 37, 53), (3, 2, 9)])
@pytest.mark.parametrize("nan", [False, True])
def test_plain_pde4_matches_xla_solver(rng, shape, nan):
    f = _fields(rng, PDE4, shape, ("trace",) if nan else ())
    want = jsor.sor_pde4(*(jnp.asarray(x) for x in f), 5, 1.75)
    _close(sor.sor_pde4(*_t(f), 5, 1.75), want)


@pytest.mark.parametrize("nan", [False, True])
def test_plain_pde4_shared_weights_match_xla_solver(rng, nan):
    """(C, H, W) unknowns with one (H, W) weight plane, as tv_denoise4
    hands them over."""
    f = _fields(rng, PDE4, (3, 21, 30), ("trace",) if nan else (),
                shared=("ww", "wn", "we", "ws"))
    want = jsor.sor_pde4(*(jnp.asarray(x) for x in f), 4, 1.75)
    _close(sor.sor_pde4(*_t(f), 4, 1.75), want)


@pytest.mark.parametrize("shape", [(37, 53), (48, 65)])
def test_plain_disp_matches_stripe_pallas_kernel(rng, shape):
    """3- or 4-stripe plan with k=2 sweeps per pass, iters % k != 0."""
    u, du, cu, duc, *wts = _fields(rng, DISP, shape, ("cu", "duc"))
    prepare, sweep = sweeps.disp_llin4_sweep(1.9)
    (want,) = tiled_relax(tuple(jnp.asarray(x) for x in (du, u, cu, duc, *wts)), sweep, 1, 5,
                          prepare_fn=prepare, interpret=True, plan_override=(2, 16))
    _close(sor.sor_disp_llin4(*_t([u, du, cu, duc, *wts]), 5, 1.9), want)


@pytest.mark.parametrize("shape", [(37, 53), (48, 65)])
def test_plain_pde4_matches_stripe_pallas_kernel(rng, shape):
    f = _fields(rng, PDE4, shape, ("trace",))
    prepare, sweep = sweeps.pde4_sweep(1.75)
    (want,) = tiled_relax(tuple(jnp.asarray(x) for x in f), sweep, 1, 5,
                          prepare_fn=prepare, interpret=True, plan_override=(2, 16))
    _close(sor.sor_pde4(*_t(f), 5, 1.75), want)


@pytest.mark.parametrize("shape", [(3, 24, 31), (24, 31)])
def test_warp_x_window_matches(rng, shape):
    img = (rng.random(shape) * 255).astype(np.float32)
    # disparities from -5 to 5 px with r=3: some beyond the window, some
    # beyond the image, as NaN in both
    u = ((rng.random(shape[-2:]) - 0.5) * 10).astype(np.float32)
    want = np.asarray(jwarp.warp_x_window(jnp.asarray(img), jnp.asarray(u), 3))
    got = warp.warp_x_window(torch.from_numpy(img), torch.from_numpy(u), 3).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want).any() and np.isfinite(want).any()
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok] / 255.0, want[ok] / 255.0, atol=ATOL, rtol=0)


@pytest.mark.parametrize("system", ["disp", "sym", "pde4"])
def test_dispatch_cpu_is_plain_and_launches_nothing(rng, system):
    before = dict(interior_cuda.LAUNCHES)
    if system == "disp":
        args = _t(_fields(rng, DISP, (21, 30), ("cu",)))
        got, want = dispatch.sor_disp_llin4(*args, 4, 1.9), sor.sor_disp_llin4(*args, 4, 1.9)
    elif system == "sym":
        args = _t(_fields(rng, DISP, (21, 30)) + _fields(rng, DISP, (21, 30)))
        got = torch.stack(dispatch.sor_disp_llin_sym4(*args, 4, 1.9))
        want = torch.stack(sor.sor_disp_llin_sym4(*args, 4, 1.9))
    else:
        args = _t(_fields(rng, PDE4, (3, 21, 30), shared=("ww", "wn", "we", "ws")))
        got, want = dispatch.sor_pde4(*args, 4, 1.75), sor.sor_pde4(*args, 4, 1.75)
        with dispatch.plain_solvers():
            np.testing.assert_array_equal(dispatch.sor_pde4(*args, 4, 1.75).numpy(),
                                          want.numpy())
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert interior_cuda.LAUNCHES == before


def _no_build(name):
    raise AssertionError("the wrapper must check its inputs before it builds")


def test_cuda_wrapper_rejects_cpu_tensors_before_building(rng, monkeypatch):
    monkeypatch.setattr(build, "load", _no_build)
    before = dict(interior_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        interior_cuda.disp_llin4_sor(*_t(_fields(rng, DISP, (8, 9))), 4, 1.9)
    with pytest.raises(ValueError, match="CUDA"):
        interior_cuda.pde4_sor(*_t(_fields(rng, PDE4, (8, 9))), 4, 1.75)
    assert interior_cuda.LAUNCHES == before


@pytest.mark.parametrize("shape", [(1, 9), (9, 1), (2, 1, 9)])
def test_cuda_wrapper_rejects_h_or_w_of_one(monkeypatch, shape):
    """The plain version's border fill empties an H or W of 1 (as
    pde_tpu's does), so the kernel takes H, W >= 2 only; the wrapper
    checks the shape first, before the device and the build."""
    monkeypatch.setattr(build, "load", _no_build)
    x = torch.zeros(shape)
    with pytest.raises(ValueError, match="H, W >= 2"):
        interior_cuda.disp_llin4_sor(*([x] * 8), 4, 1.9)
    with pytest.raises(ValueError, match="H, W >= 2"):
        interior_cuda.pde4_sor(*([x] * 7), 4, 1.75)
