"""The port's line-implicit PCG solvers (``pde_tpu_torch/solvers/krylov.py``)
held against ``pde_tpu``'s on seeded 24x30 fields with NaN data, including
both reduction scopes: the symmetric pair's per-member CG (``pde_tpu``
vmaps ``pcg_disp_llin4``) and ``pcg_pde4``'s and ``pcg_pde8``'s joint CG
over channels that share their weights. The 8-neighbour systems get
diagonal weights of both signs, as the tensor stencil's.

Bound: 1e-4 per solver call (ROADMAP tolerances) on unit-scale fields. The
CG dot products are reduced in another order by XLA and by torch, so the
step lengths differ in their last bits and the iterates drift apart a
little with every iteration.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_tpu.solvers import krylov as jkrylov
from pde_tpu_torch.kernels import tdma_cuda
from pde_tpu_torch.solvers import krylov

torch.set_num_threads(1)

TOL = 1e-4
ITERS = 5
SHAPE = (24, 30)
W4 = ("ww", "wn", "we", "ws")
W8 = ("ww", "wnw", "wn", "wne", "we", "wse", "ws", "wsw")
DIAG = ("wnw", "wne", "wse", "wsw")
FLOW = ("m", "cu", "cv", "duc", "dvc") + W4


def _fields(rng, names, shape=SHAPE, shared=()):
    """Unit-scale solver fields as in tests/test_kernels.py; 5% NaN in Cu,
    Cv and Du (the missing-data sentinel; Cu and Cv share their pattern, as
    in the models) and in TRACE; the names in ``shared`` are one (H, W)
    plane."""
    out = {}
    for n in names:
        s = shape[-2:] if n in shared else shape
        if n in ("duc", "dvc", "trace"):
            out[n] = rng.random(s) + 1.0
        elif n == "m":
            out[n] = rng.random(s) * 0.01
        elif n in DIAG:
            out[n] = rng.random(s) * 0.3 - 0.15
        elif n.startswith("w"):
            out[n] = rng.random(s) + 0.1
        else:
            out[n] = rng.random(s) * 0.2
    missing = rng.random(shape) < 0.05
    for n in ("cu", "cv", "trace"):
        if n in out:
            out[n] = np.where(missing, np.nan, out[n])
    if "duc" in out:
        out["duc"] = np.where(rng.random(shape) < 0.05, np.nan, out["duc"])
    return [out[n].astype(np.float32) for n in names]


def _close(got, want):
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, w_ in zip(got, want):
        g, w_ = g.numpy(), np.asarray(w_)
        assert g.shape == w_.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w_, atol=TOL, rtol=0)


def _run(fn_name, fields):
    want = getattr(jkrylov, fn_name)(*(jnp.asarray(x) for x in fields), ITERS, 1.9)
    got = getattr(krylov, fn_name)(*(torch.from_numpy(x) for x in fields), ITERS, 1.9)
    return got, want


@pytest.mark.parametrize("name,fields", [
    ("pcg_flow_elin4", ("u", "v") + FLOW),
    ("pcg_flow_llin4", ("u", "v", "du", "dv") + FLOW),
    ("pcg_flow_llin8", ("u", "v", "du", "dv", "m", "cu", "cv", "duc", "dvc") + W8),
])
def test_flow_pcg_matches_reference(rng, name, fields):
    got, want = _run(name, _fields(rng, fields))
    _close(got, want)


def test_disp_pcg_pair_has_per_member_scalars(rng):
    """disparity_sym's pair: one call on (2, H, W) fields equals pde_tpu's
    vmap of the 2-D solver, and each member solved alone."""
    names = ("u", "du", "cu", "duc") + W4
    f = _fields(rng, names, (2,) + SHAPE)
    want = jax.vmap(lambda *a: jkrylov.pcg_disp_llin4(*a, ITERS, 1.9))(
        *(jnp.asarray(x) for x in f))
    got = krylov.pcg_disp_llin4(*(torch.from_numpy(x) for x in f), ITERS, 1.9)
    _close(got, want)
    for k in range(2):
        alone = krylov.pcg_disp_llin4(*(torch.from_numpy(x[k]) for x in f), ITERS, 1.9)
        np.testing.assert_allclose(got[k].numpy(), alone.numpy(), atol=1e-6, rtol=0)


def test_pde4_pcg_solves_channels_jointly(rng):
    """tv_denoise4's call: (3, H, W) X, TRACE and B with one shared (H, W)
    plane per weight; the dot products run over all channels."""
    f = _fields(rng, ("x", "trace", "b") + W4, (3,) + SHAPE, shared=W4)
    f[1] = f[1] + sum(f[3:])  # TRACE above the weights' sum, as PsiData + Σw
    got, want = _run("pcg_pde4", f)
    _close(got, want)


@pytest.mark.parametrize("shape,shared", [((3,) + SHAPE, W8), (SHAPE, ())])
def test_pde8_pcg_matches_reference(rng, shape, shared):
    """tv_denoise8's call, (3, H, W) with shared (H, W) weights, and a
    single (H, W) system."""
    f = _fields(rng, ("x", "trace", "b") + W8, shape, shared=shared)
    f[1] = f[1] + sum(np.abs(x) for x in f[3:])  # TRACE above the weights' absolute sum
    got, want = _run("pcg_pde8", f)
    _close(got, want)


def test_cpu_solve_launches_nothing(rng):
    before = dict(tdma_cuda.LAUNCHES)
    f = _fields(rng, ("u", "du", "cu", "duc") + W4, (12, 14))
    out = krylov.pcg_disp_llin4(*(torch.from_numpy(x) for x in f), 2, 1.9)
    assert out.shape == (12, 14) and torch.isfinite(out).all()
    assert tdma_cuda.LAUNCHES == before


@pytest.mark.parametrize("name,fields,shape", [
    ("pcg_flow_elin4", ("u", "v") + FLOW, (17, 23)),
    ("pcg_disp_llin4", ("u", "du", "cu", "duc") + W4, (17, 23)),
    ("pcg_pde8", ("x", "trace", "b") + W8, (3, 17, 23)),
])
def test_fused_preconditioner_pcg_matches_reference(rng, name, fields, shape):
    """Every preconditioner step is one fused zebra pass
    (``dispatch.zebra_pass``); the solvers still agree with pde_tpu at an
    odd shape (an odd line count of each parity, both directions), with the
    tolerance above."""
    shared = W8 if name == "pcg_pde8" else ()
    f = _fields(rng, fields, shape, shared=shared)
    if name == "pcg_pde8":
        f[1] = f[1] + sum(np.abs(x) for x in f[3:])  # TRACE above the weights' absolute sum
    got, want = _run(name, f)
    _close(got, want)
