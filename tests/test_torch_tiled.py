"""The tile engine (``pde_tpu_torch/kernels/tiled.py``): its plain tile
schedule held exactly against the port's plain global solvers and within
``tests/test_kernels.py``'s tolerance against ``pde_tpu``'s Pallas stripe
engine in interpret mode (serial and double-buffered); the tile plan; the
wrapper's refusals; and the build rule for headers.

The kernel (``csrc/tiled_sor.cu``) runs only on the card: ``chip_smoke.py``
holds it against the plain schedule there.
"""

import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pde_tpu.kernels import sweeps as jsweeps
from pde_tpu.kernels.tiled import tiled_relax as jtiled_relax
from pde_tpu_torch.kernels import build, sweeps, tiled, tiled_cuda
from pde_tpu_torch.solvers import sor

torch.set_num_threads(1)

LLIN = ("du", "dv", "u", "v", "m", "cu", "cv", "duc", "dvc", "ww", "wn", "we", "ws")
ELIN = ("u", "v", "m", "cu", "cv", "duc", "dvc", "ww", "wn", "we", "ws")
FAMILIES = {"flow_llin4": (LLIN, sweeps.flow_llin4_sweep, jsweeps.flow_llin4_sweep),
            "flow_elin4": (ELIN, sweeps.flow_elin4_sweep, jsweeps.flow_elin4_sweep)}
NAN_ALL = ("cu", "cv", "duc", "dvc")


def _fields(rng, h, w, names, nan_names=()):
    """Unit-scale fields as tests/test_kernels.py makes them, 5% NaN in
    ``nan_names``; numpy float32, in the order of ``names``."""
    out = []
    for n in names:
        if n in ("duc", "dvc"):
            x = rng.random((h, w)) + 1.0
        elif n == "m":
            x = rng.random((h, w)) * 0.01
        elif n.startswith("w"):
            x = rng.random((h, w)) + 0.1
        else:
            x = rng.random((h, w)) * 0.2
        if n in nan_names:
            x = np.where(rng.random((h, w)) < 0.05, np.nan, x)
        out.append(x.astype(np.float32))
    return out


def _plain_global(family, t, iters):
    if family == "flow_llin4":
        du, dv, u, v, *rest = t
        return sor.sor_flow_llin4(u, v, du, dv, *rest, iters, 1.9)
    return sor.sor_flow_elin4(*t, iters, 1.9)


def _assert_equal(got, want):
    """Bit for bit, NaN where the other has NaN."""
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape
        assert torch.equal(torch.isnan(g), torch.isnan(w_))
        assert torch.equal(torch.where(torch.isnan(g), 0.0, g), torch.where(torch.isnan(w_), 0.0, w_))


# (h, w, iters, NaN fields, tiled_relax keywords)
EXACT_CASES = {
    "multi-tile, unaligned width, iters % k != 0": (48, 65, 5, (), dict(plan_override=(2, 16))),
    "rectangular tiles": (48, 65, 5, (), dict(plan_override=(2, (8, 24)))),
    "NaN data": (48, 65, 5, NAN_ALL, dict(plan_override=(2, 16))),
    "one tile, k = iters": (24, 30, 4, NAN_ALL, dict(plan_override=(4, (24, 32)))),
    "the plan's own tile, k_max = 3": (37, 53, 7, ("cu", "duc"), dict(k_max=3)),
    "1x9": (1, 9, 5, NAN_ALL, dict(plan_override=(2, 8))),
    "9x1": (9, 1, 5, NAN_ALL, dict(plan_override=(2, 8))),
    "1x1": (1, 1, 5, NAN_ALL, dict(plan_override=(2, 8))),
}


@pytest.mark.parametrize("case", sorted(EXACT_CASES))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_plain_tile_schedule_equals_plain_global_solver(rng, family, case):
    h, w, iters, nan_names, kw = EXACT_CASES[case]
    names, factory, _ = FAMILIES[family]
    t = [torch.from_numpy(x) for x in _fields(rng, h, w, names, nan_names)]
    prepare, sweep = factory(1.9)
    got = tiled.tiled_relax(t, sweep, 2, iters, prepare_fn=prepare, **kw)
    _assert_equal(got, _plain_global(family, t, iters))


@pytest.mark.parametrize("double_buffer", [False, True])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_tiled_relax_matches_pallas_stripe_engine(rng, family, double_buffer):
    """The shapes of tests/test_kernels.py's multi-stripe cases, NaN in Cu
    and Du; pde_tpu's kernel in interpret mode, 16-row stripes."""
    names, factory, jfactory = FAMILIES[family]
    f = _fields(rng, 48, 65, names, ("cu", "duc"))
    jprep, jsweep = jfactory(1.9)
    want = jtiled_relax(tuple(jnp.asarray(x) for x in f), jsweep, 2, 5, prepare_fn=jprep,
                        interpret=True, plan_override=(2, 16), double_buffer=double_buffer)
    prepare, sweep = factory(1.9)
    got = tiled.tiled_relax([torch.from_numpy(x) for x in f], sweep, 2, 5, prepare_fn=prepare,
                            plan_override=(2, 16), double_buffer=double_buffer)
    for g, w_ in zip(got, want):
        g = g.numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w_), atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("sweeps_", [3, 4096])
@pytest.mark.parametrize("double_buffer", [False, True])
@pytest.mark.parametrize("k_max", [1, 4, 8])
@pytest.mark.parametrize("h,w,n_fields", [(1024, 1024, 13), (480, 640, 13), (481, 641, 11)])
def test_plan_tiles(h, w, n_fields, k_max, double_buffer, sweeps_):
    plan = tiled.plan_tiles(h, w, n_fields, sweeps_, k_max, double_buffer=double_buffer)
    assert 1 <= plan.k <= min(k_max, sweeps_)
    assert tiled._halo_for(plan.k) == 2 * plan.k
    slot = tiled.slot_bytes(n_fields, plan.k, plan.tile_h, plan.tile_w)
    assert plan.smem_bytes == (2 if double_buffer else 1) * slot <= tiled.SMEM_PER_BLOCK
    # every pixel in exactly one tile
    cover = np.zeros((h, w), np.int32)
    origins = tiled.tile_origins(h, w, plan.tile_h, plan.tile_w)
    assert len(origins) == plan.n_tiles_h * plan.n_tiles_w
    for r0, c0 in origins:
        cover[r0:r0 + plan.tile_h, c0:c0 + plan.tile_w] += 1
    assert (cover == 1).all()


def test_plan_override_and_no_plan(rng, monkeypatch):
    seen = []

    def spy(fields, sweep_fn, prepare_fn, n_mut, iters, k, tile_h, tile_w):
        seen.append((k, tile_h, tile_w))
        return tuple(fields[:n_mut])

    monkeypatch.setattr(tiled, "plain_tiled_relax", spy)
    t = [torch.from_numpy(x) for x in _fields(rng, 20, 30, LLIN)]
    prepare, sweep = sweeps.flow_llin4_sweep(1.9)
    tiled.tiled_relax(t, sweep, 2, 5, prepare_fn=prepare, plan_override=(3, (8, 16)))
    tiled.tiled_relax(t, sweep, 2, 5, prepare_fn=prepare, plan_override=(2, 12))
    assert seen == [(3, 8, 16), (2, 12, 12)]
    assert tiled.plan_tiles(1024, 1024, 4000, 4) is None
    assert tiled.tiled_relax(t * 400, sweep, 2, 5, prepare_fn=prepare) is None


def _llin_cpu(rng, dtype=torch.float32, h=8, w=9):
    return [torch.from_numpy(x).to(dtype) for x in _fields(rng, h, w, LLIN)]


@pytest.mark.parametrize("what", ["cpu", "float64", "non-contiguous", "count"])
def test_wrapper_refuses_before_building(rng, monkeypatch, what):
    def no_build(*args, **kwargs):
        raise AssertionError("the wrapper must check its inputs before it builds")

    monkeypatch.setattr(build, "load", no_build)
    fields = _llin_cpu(rng, torch.float64 if what == "float64" else torch.float32)
    if what == "non-contiguous":
        fields[5] = torch.from_numpy(_fields(rng, 9, 8, ("cu",))[0]).t()
    if what == "count":
        fields = fields[:-1]
    match = {"cpu": "CUDA", "float64": "float32", "non-contiguous": "contiguous",
             "count": "takes 13 fields"}[what]
    before = dict(tiled_cuda.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        tiled_cuda.tiled_flow_sor("flow_llin4", fields, 4, 1.9, 2, 16, 16)
    assert tiled_cuda.LAUNCHES == before


def test_off_cpu_goes_to_the_kernel_or_raises(monkeypatch):
    """A tensor off the CPU never takes the plain schedule: a sweep the
    kernel has goes to the wrapper (which refuses a non-CUDA device), any
    other sweep raises."""
    monkeypatch.setattr(tiled, "plain_tiled_relax", None)
    meta = [torch.empty((16, 16), device="meta") for _ in LLIN]
    prepare, sweep = sweeps.flow_llin4_sweep(1.9)
    with pytest.raises(ValueError, match="CUDA"):
        tiled.tiled_relax(meta, sweep, 2, 4, prepare_fn=prepare)
    with pytest.raises(ValueError, match="tile kernel runs"):
        tiled.tiled_relax(meta, sweep, 2, 4, prepare_fn=sweeps.flow_llin4_sweep(1.5)[0])
    with pytest.raises(ValueError, match="tile kernel runs"):
        tiled.tiled_relax(meta, sweep, 2, 4, prepare_fn=None)


def test_cpu_path_and_import_build_nothing(rng, monkeypatch, tmp_path):
    def no_build(*args, **kwargs):
        raise AssertionError("nothing may be built on the CPU path")

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "build", no_build)
    monkeypatch.setattr(build, "load", no_build)
    importlib.reload(tiled)
    before = dict(tiled_cuda.LAUNCHES)
    t = _llin_cpu(rng, h=20, w=21)
    prepare, sweep = sweeps.flow_llin4_sweep(1.9)
    _assert_equal(tiled.tiled_relax(t, sweep, 2, 3, prepare_fn=prepare, plan_override=(2, 8)),
                  _plain_global("flow_llin4", t, 3))
    assert tiled_cuda.LAUNCHES == before
    assert tiled_cuda._lib.cache_info().currsize == 0


def test_library_path_follows_included_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include <cstdint>\n#include "a.cuh"\nint f();\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cuh").write_text("// not included\n")
    assert build._with_headers(tmp_path / "k.cu") == [tmp_path / n for n in ("k.cu", "a.cuh", "b.cuh")]
    first = build.library_path("k")
    assert first.name.startswith("libk_") and not first.exists()
    (tmp_path / "other.cuh").write_text("// edited\n")
    assert build.library_path("k") == first
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    assert build.library_path("k") != first


def test_tiled_source_includes_the_shared_arithmetic():
    # the global source's llin8 arithmetic is flow8_update.cuh, which the
    # resident 8-neighbour kernel shares; it includes flow_update.cuh too
    for source, headers in ((tiled_cuda.SOURCE, ["flow_update.cuh"]),
                            ("flow_llin4_sor", ["flow8_update.cuh", "flow_update.cuh"])):
        files = build._with_headers(build.CSRC / f"{source}.cu")
        assert [f.name for f in files] == [f"{source}.cu", *headers]
    path = build.library_path(tiled_cuda.SOURCE)
    assert path.parent == build.BUILD_DIR and path.name.startswith("libtiled_sor_")
