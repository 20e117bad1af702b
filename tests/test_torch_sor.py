"""The plain llin4 and elin4 SOR (``pde_tpu_torch/solvers/sor.py``), the
CUDA kernel's reference, held against ``pde_tpu``'s XLA solvers and the
Pallas kernels run in interpret mode, as ``tests/test_kernels.py`` runs
them; and the dispatch, wrapper and build rules that can be checked
without a card.

The kernel itself runs only on the card: ``chip_smoke.py`` compares it with
the plain version there.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pde_tpu.kernels import sweeps
from pde_tpu.kernels.sor_pallas import pallas_sor_flow_llin4
from pde_tpu.kernels.tiled import tiled_relax
from pde_tpu.solvers import sor as jsor
from pde_tpu_torch.kernels import build, dispatch, interior_cuda, sor_cuda, tdma_cuda
from pde_tpu_torch.solvers import sor

torch.set_num_threads(1)

ATOL = 1e-5
NAMES = ("u", "v", "du", "dv", "m", "cu", "cv", "duc", "dvc", "ww", "wn", "we", "ws")


def _fields(rng, h, w, nan_names=("cu", "duc")):
    """Unit-scale llin4 fields as in tests/test_kernels.py, 5% NaN in
    ``nan_names`` (the missing-data sentinel)."""
    out = {}
    for n in NAMES:
        if n in ("duc", "dvc"):
            x = rng.random((h, w)) + 1.0
        elif n == "m":
            x = rng.random((h, w)) * 0.01
        elif n.startswith("w"):
            x = rng.random((h, w)) + 0.1
        else:
            x = rng.random((h, w)) * 0.2
        out[n] = x.astype(np.float32)
    for n in nan_names:
        out[n] = np.where(rng.random((h, w)) < 0.05, np.nan, out[n]).astype(np.float32)
    return [out[n] for n in NAMES]


def _plain(fields, iters, omega):
    return sor.sor_flow_llin4(*(torch.from_numpy(f) for f in fields), iters, omega)


def _assert_close(got, want):
    for g, w_ in zip(got, want):
        g, w_ = g.numpy(), np.asarray(w_)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w_, atol=ATOL, rtol=0)


@pytest.mark.parametrize("h,w", [(37, 53), (48, 65)])
@pytest.mark.parametrize("nan_names", [("cu", "duc"), ("cu", "cv", "duc", "dvc")])
def test_plain_matches_xla_solver(rng, h, w, nan_names):
    fields = _fields(rng, h, w, nan_names)
    want = jsor.sor_flow_llin4(*(jnp.asarray(f) for f in fields), 5, 1.9)
    _assert_close(_plain(fields, 5, 1.9), want)


@pytest.mark.parametrize("h,w", [(37, 53), (48, 65)])
def test_plain_matches_resident_pallas_kernel(rng, h, w):
    fields = _fields(rng, h, w)
    want = pallas_sor_flow_llin4(*(jnp.asarray(f) for f in fields), 5, 1.9, interpret=True)
    _assert_close(_plain(fields, 5, 1.9), want)


@pytest.mark.parametrize("h,w", [(37, 53), (48, 65)])
def test_plain_matches_stripe_pallas_kernel(rng, h, w):
    """3- or 4-stripe plan with k=2 sweeps per pass, iters % k != 0."""
    fields = _fields(rng, h, w)
    u, v, du, dv, *const = (jnp.asarray(f) for f in fields)
    prepare, sweep = sweeps.flow_llin4_sweep(1.9)
    want = tiled_relax((du, dv, u, v, *const), sweep, 2, 5, prepare_fn=prepare,
                       interpret=True, plan_override=(2, 16))
    _assert_close(_plain(fields, 5, 1.9), want)


ELIN = ("u", "v", "m", "cu", "cv", "duc", "dvc", "ww", "wn", "we", "ws")


def _elin_fields(rng, h, w):
    f = dict(zip(NAMES, _fields(rng, h, w, ("cu", "cv", "duc"))))
    return [f[n] for n in ELIN]


@pytest.mark.parametrize("h,w", [(37, 53), (48, 65)])
def test_plain_elin4_matches_xla_solver_and_stripe_kernel(rng, h, w):
    """elin4 against the XLA solver and the stripe engine with
    sweeps.flow_elin4_sweep (3- or 4-stripe plan, k=2, iters % k != 0)."""
    fields = _elin_fields(rng, h, w)
    got = sor.sor_flow_elin4(*(torch.from_numpy(f) for f in fields), 5, 1.9)
    jf = [jnp.asarray(f) for f in fields]
    _assert_close(got, jsor.sor_flow_elin4(*jf, 5, 1.9))
    prepare, sweep = sweeps.flow_elin4_sweep(1.9)
    want = tiled_relax(tuple(jf), sweep, 2, 5, prepare_fn=prepare, interpret=True,
                       plan_override=(2, 16))
    _assert_close(got, want)


def test_plain_zero_iters_returns_inputs(rng):
    fields = _fields(rng, 9, 11)
    got = _plain(fields, 0, 1.9)
    np.testing.assert_array_equal(got[0].numpy(), fields[2])
    np.testing.assert_array_equal(got[1].numpy(), fields[3])


def test_dispatch_cpu_is_plain_and_launches_nothing(rng):
    args = [torch.from_numpy(f) for f in _fields(rng, 21, 30)]
    before = dict(sor_cuda.LAUNCHES)
    want = sor.sor_flow_llin4(*args, 4, 1.9)
    for got in (dispatch.sor_flow_llin4(*args, 4, 1.9), _plain_ctx(args)):
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w_.numpy())
    elin = [args[NAMES.index(n)] for n in ELIN]
    for g, w_ in zip(dispatch.sor_flow_elin4(*elin, 4, 1.9), sor.sor_flow_elin4(*elin, 4, 1.9)):
        np.testing.assert_array_equal(g.numpy(), w_.numpy())
    assert sor_cuda.LAUNCHES == before


def _plain_ctx(args):
    with dispatch.plain_solvers():
        assert dispatch._FORCE_PLAIN.get()
        out = dispatch.sor_flow_llin4(*args, 4, 1.9)
    assert not dispatch._FORCE_PLAIN.get()
    return out


def test_cuda_wrapper_rejects_cpu_tensors_before_building(rng, monkeypatch):
    def no_build(name):
        raise AssertionError("the wrapper must check its inputs before it builds")

    monkeypatch.setattr(build, "load", no_build)
    args = [torch.from_numpy(f) for f in _fields(rng, 8, 9)]
    before = dict(sor_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        sor_cuda.flow_llin4_sor(*args, 4, 1.9)
    with pytest.raises(ValueError, match="CUDA"):
        sor_cuda.flow_elin4_sor(*(args[NAMES.index(n)] for n in ELIN), 4, 1.9)
    assert sor_cuda.LAUNCHES == before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.find_nvcc()


@pytest.mark.parametrize("source", [sor_cuda.SOURCE, interior_cuda.SOURCE, tdma_cuda.SOURCE])
def test_library_name_follows_source_hash(source):
    path = build.library_path(source)
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("lib" + source + "_") and path.suffix == ".so"
    assert (build.CSRC / f"{source}.cu").is_file()


# the residual and LHS operators (the multigrid building blocks), with 5%
# NaN in Cu and Du/Dv: the pure-diffusion rows
OPERATORS = {
    "residuals_elin4": ("u", "v", "m", "cu", "cv", "duc", "dvc", "ww", "wn", "we", "ws"),
    "lhs_elin4": ("u", "v", "m", "duc", "dvc", "ww", "wn", "we", "ws"),
    "residuals_llin4": NAMES,
    "lhs_llin4": ("u", "v", "du", "dv", "m", "duc", "dvc", "ww", "wn", "we", "ws"),
    "residuals_disp_llin4": ("u", "du", "cu", "duc", "ww", "wn", "we", "ws"),
}


@pytest.mark.parametrize("name", sorted(OPERATORS))
def test_residual_and_lhs_operators_match_reference(rng, name):
    fields = dict(zip(NAMES, _fields(rng, 37, 53, ("cu", "cv", "duc", "dvc"))))
    args = [fields[n] for n in OPERATORS[name]]
    want = getattr(jsor, name)(*(jnp.asarray(a) for a in args))
    got = getattr(sor, name)(*(torch.from_numpy(a) for a in args))
    want, got = (want, got) if isinstance(got, tuple) else ((want,), (got,))
    assert len(got) == len(want) and got[0].shape == (37, 53)
    _assert_close(got, want)


def test_lhs_llin4_consistent_with_residuals(rng):
    """r = b − A·x at the increment state, on the port: residuals_llin4
    equals where(valid, Cu, 0) − lhs_llin4 in the interior, for valid and
    NaN data pixels (as tests/test_solvers.py holds ``pde_tpu``'s)."""
    h, w = 12, 14
    mk = lambda: torch.from_numpy(rng.standard_normal((h, w)).astype(np.float32))  # noqa: E731
    u, v, du, dv, m = mk(), mk(), mk(), mk(), mk() * 0.1
    cu, cv = mk(), mk()
    duc = mk().abs() + 0.2
    dvc = mk().abs() + 0.2
    nanmask = torch.from_numpy(rng.random((h, w)) < 0.2)
    cu = torch.where(nanmask, torch.nan, cu)
    duc = torch.where(nanmask, torch.nan, duc)
    ww, wn, we, ws = (mk().abs() for _ in range(4))

    ru, rv = sor.residuals_llin4(u, v, du, dv, m, cu, cv, duc, dvc, ww, wn, we, ws)
    au, av = sor.lhs_llin4(u, v, du, dv, m, duc, dvc, ww, wn, we, ws)
    want_u = torch.where(nanmask, 0.0, torch.nan_to_num(cu)) - au
    want_v = cv - av
    inner = (slice(1, -1), slice(1, -1))
    np.testing.assert_allclose(ru[inner].numpy(), want_u[inner].numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(rv[inner].numpy(), want_v[inner].numpy(), rtol=1e-4, atol=1e-5)
