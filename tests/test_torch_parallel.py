"""The port's spatial parallelism (``pde_tpu_torch/parallel``) on a virtual
CPU mesh, against the port's plain global solvers (bit for bit) and against
``pde_tpu/parallel`` on JAX's 8 virtual CPU devices (``tests/conftest.py``)
within ``tests/test_parallel.py``'s bar of 1e-5: the mesh and its
refusals, the halo exchange, the sharded solvers of every family (NaN
data, several meshes, multichunk blocking), the windowed plain tile
schedule, the tiled PCG, ``flow_nd``/``flow_fmg`` with ``mesh=``, the
device rule, and the windowed kernel wrapper's refusals (the kernel itself
runs only on the card: ``chip_smoke.py`` holds it against the plain
schedule there). Also the sweep factories of ``kernels/sweeps.py`` against
``pde_tpu``'s.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pde_tpu.kernels import sweeps as jsweeps
from pde_tpu.kernels.tiled import _make_aux
from pde_tpu.models.flow_nd import flow_nd as jflow_nd
from pde_tpu.parallel import halo as jhalo
from pde_tpu.parallel import mesh as jmesh
from pde_tpu.parallel import tiled as jtiled
from pde_tpu_torch.kernels import build, sweeps, tiled, tiled_cuda
from pde_tpu_torch.models.flow_fmg import flow_fmg
from pde_tpu_torch.models.flow_nd import flow_nd
from pde_tpu_torch.parallel import halo, mesh as pmesh, model as pmodel
from pde_tpu_torch.parallel import tiled as ptiled
from pde_tpu_torch.solvers import sor
from pde_tpu_torch.solvers.krylov import pcg_flow_llin4

try:  # jax >= 0.4.35 moved shard_map out of experimental
    from jax import shard_map as _sm

    shard_map = _sm.shard_map if hasattr(_sm, "shard_map") else _sm
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

torch.set_num_threads(1)
# models/__init__ exports the entry points under their modules' names
fmg_mod = importlib.import_module("pde_tpu_torch.models.flow_fmg")

MESHES = [(1, 8), (2, 4), (4, 2), (1, 1)]
JAX_TOL = 1e-5  # tests/test_parallel.py's bar between pde_tpu's sharded and global solvers
H, W = 32, 48
W8 = ("ww", "wnw", "wn", "wne", "we", "wse", "ws", "wsw")


def _cpu_mesh(ty, tx):
    return pmesh.make_mesh(ty, tx, devices=["cpu"] * 8)


def _jax_mesh(ty, tx):
    return jmesh.make_mesh(ty, tx, devices=jax.devices()[:ty * tx])


def _field(rng, name, shape=(H, W)):
    """Unit-scale solver fields as tests/test_parallel.py makes them; the
    8-neighbour stencil's diagonal weights take both signs."""
    x = rng.random(shape)
    if name in ("duc", "dvc"):
        x = x + 0.5
    elif name == "trace":
        x = x + 2.5
    elif name in ("wnw", "wne", "wse", "wsw"):
        x = x * 0.3 - 0.15
    elif name.startswith("w"):
        x = x + 0.1
    elif name == "m":
        x = x * 0.05
    elif name in ("u", "v", "x"):
        x = x * 0.2
    elif name in ("du", "dv"):
        x = x * 0.0
    return x.astype(np.float32)


# family: (its fields in the solver's order, NaN-patched field, omega,
# port sharded solver, port global solver, pde_tpu sharded solver)
FAMILIES = {
    "flow_llin4": (("u", "v", "du", "dv", "m", "cu", "cv", "duc", "dvc", "ww", "wn", "we", "ws"),
                   "cu", 1.9, ptiled.tiled_sor_flow_llin4, sor.sor_flow_llin4,
                   jtiled.tiled_sor_flow_llin4),
    "flow_elin4": (("u", "v", "m", "cu", "cv", "duc", "dvc", "ww", "wn", "we", "ws"),
                   "cu", 1.9, ptiled.tiled_sor_flow_elin4, sor.sor_flow_elin4,
                   jtiled.tiled_sor_flow_elin4),
    "flow_llin8": (("u", "v", "du", "dv", "m", "cu", "cv", "duc", "dvc") + W8,
                   "cu", 1.9, ptiled.tiled_sor_flow_llin8, sor.sor_flow_llin8,
                   jtiled.tiled_sor_flow_llin8),
    "disp_llin4": (("u", "du", "cu", "duc", "ww", "wn", "we", "ws"),
                   "cu", 1.9, ptiled.tiled_sor_disp_llin4, sor.sor_disp_llin4,
                   jtiled.tiled_sor_disp_llin4),
    "pde4": (("x", "trace", "b", "ww", "wn", "we", "ws"),
             "trace", 1.75, ptiled.tiled_sor_pde4, sor.sor_pde4, jtiled.tiled_sor_pde4),
}


def _family_fields(rng, names, nan_name, shape=(H, W)):
    f = [_field(rng, n, shape) for n in names]
    i = names.index(nan_name)
    # a block of missing data across tile seams, as tests/test_parallel.py:43-54
    f[i][10:20, 5:25] = np.nan
    return f


def _assert_equal(got, want):
    """Bit for bit, NaN where the other has NaN."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape and g.device == w_.device
        assert torch.equal(g.view(torch.int32), w_.view(torch.int32))


def _close(got, want, tol):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w_ in zip(got, want):
        g = g.numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w_), atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def test_make_mesh_shape_and_refusals():
    mesh = _cpu_mesh(2, 4)
    assert mesh.shape == {"ty": 2, "tx": 4} and mesh.device == torch.device("cpu")
    assert pmesh.make_mesh(2, devices=["cpu"] * 8).shape == {"ty": 2, "tx": 4}
    assert pmesh.tile_sharding(mesh, 3).spec == (None, "ty", "tx") == pmesh.field_spec(3)
    assert pmodel.shard_spec_for(mesh, 2) == pmesh.tile_sharding(mesh, 2)
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        pmesh.make_mesh(2, 4, devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        # by default the mesh is the CUDA cards, each once
        with pytest.raises(ValueError, match="have 0"):
            pmesh.make_mesh(1, 1)
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        pmesh.Mesh([["cpu", "cuda"]])
    x = torch.arange(30.0).reshape(5, 6)
    with pytest.raises(ValueError, match="does not divide"):
        pmesh.shard(x, _cpu_mesh(2, 3))
    tiles = pmesh.shard(torch.arange(48.0).reshape(2, 4, 6), _cpu_mesh(2, 3))
    assert [[t.shape for t in row] for row in tiles] == [[(2, 2, 2)] * 3] * 2
    assert all(t.is_contiguous() for row in tiles for t in row)
    _assert_equal(pmesh.unshard(tiles, "cpu"), torch.arange(48.0).reshape(2, 4, 6))


# ---------------------------------------------------------------------------
# halo exchange
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("halo_px", [1, 4])
@pytest.mark.parametrize("ty,tx", MESHES[:3])
def test_halo_exchange_matches_pde_tpu(rng, ty, tx, halo_px):
    x = rng.random((H, W)).astype(np.float32)
    fn = shard_map(lambda t: jhalo.halo_exchange(t, halo_px), mesh=_jax_mesh(ty, tx),
                   in_specs=P("ty", "tx"), out_specs=P("ty", "tx"))
    want = np.asarray(jax.jit(fn)(jnp.asarray(x)))
    got = halo.halo_exchange(pmesh.shard(torch.from_numpy(x), _cpu_mesh(ty, tx)), halo_px)
    eh, ew = H // ty + 2 * halo_px, W // tx + 2 * halo_px
    for i in range(ty):
        for j in range(tx):
            np.testing.assert_array_equal(got[i][j].numpy(),
                                          want[i * eh:(i + 1) * eh, j * ew:(j + 1) * ew])
    # the communication-free stand-in: each tile padded with its own strips
    local = halo.halo_local(pmesh.shard(torch.from_numpy(x), _cpu_mesh(ty, tx)), halo_px)
    for i in range(ty):
        for j in range(tx):
            tile = x[i * (H // ty):(i + 1) * (H // ty), j * (W // tx):(j + 1) * (W // tx)]
            np.testing.assert_array_equal(local[i][j].numpy(),
                                          np.asarray(jhalo.halo_local(jnp.asarray(tile), halo_px)))


@pytest.mark.parametrize("halo_px", [1, 3, 7])
def test_halo_window_is_the_clipped_image_rectangle(rng, halo_px):
    """A halo wider than a tile (7 > 4 rows) takes strips from tiles further
    away; at the image's edges nothing is added."""
    x = torch.from_numpy(rng.random((2, 16, 24)).astype(np.float32))
    got = halo.halo_window(pmesh.shard(x, _cpu_mesh(4, 2)), halo_px)
    for i in range(4):
        for j in range(2):
            r0, r1 = max(0, 4 * i - halo_px), min(16, 4 * i + 4 + halo_px)
            c0, c1 = max(0, 12 * j - halo_px), min(24, 12 * j + 12 + halo_px)
            _assert_equal(got[i][j], x[..., r0:r1, c0:c1])


# ---------------------------------------------------------------------------
# the sharded solvers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ty,tx", MESHES)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_tiled_sor_equals_global_and_pde_tpu(rng, family, ty, tx):
    names, nan_name, omega, port_sharded, port_global, jax_sharded = FAMILIES[family]
    f = _family_fields(rng, names, nan_name)
    t = [torch.from_numpy(x) for x in f]
    got = port_sharded(_cpu_mesh(ty, tx), *t, 3, omega)
    _assert_equal(got, port_global(*t, 3, omega))
    _close(got, jax_sharded(_jax_mesh(ty, tx), *(jnp.asarray(x) for x in f), 3, omega), JAX_TOL)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_tiled_relax_sharded_multichunk(rng, k):
    """iters = 9 > k: several 2k-halo chunks and a remainder, each exact
    (tests/test_parallel.py:171-195)."""
    names = FAMILIES["flow_elin4"][0]
    f = [_field(rng, n, (24, 32)) for n in names]
    t = [torch.from_numpy(x) for x in f]
    got = ptiled.tiled_relax_sharded(_cpu_mesh(2, 4), sweeps.flow_elin4_sweep, t, 2, 9, 1.9, k=k)
    _assert_equal(got, sor.sor_flow_elin4(*t, 9, 1.9))
    want = jtiled.tiled_relax_sharded(_jax_mesh(2, 4), jsweeps.flow_elin4_sweep,
                                      tuple(jnp.asarray(x) for x in f), 2, 9, 1.9, k=k)
    _close(got, tuple(want), JAX_TOL)


@pytest.mark.parametrize("double_buffer", [False, True])
@pytest.mark.parametrize("family", ["flow_llin4", "flow_elin4", "flow_llin8", "disp_llin4", "pde4"])
def test_tiled_relax_sharded_under_the_tile_plan(rng, family, double_buffer, monkeypatch):
    """Each shard's chunk through ``tiled.tiled_relax(..., window=)``, the
    call the card path makes, so that the plain windowed schedule runs at
    the tiles of the kernel's default plan (several a shard) rather than one
    tile a shard, and with ``double_buffer`` at the two-slot plan of the
    double-buffered windowed kernel: 9 sweeps on a 2x2 CPU mesh, NaN data,
    bit for bit with the plain global solver."""
    calls = []

    def planned_chunk(fields, sweep, prepare, n_mut, kc, window, double_buffer):
        i0, i1, j0, j1 = window.box
        plan = tiled.plan_tiles(i1 - i0, j1 - j0, sweep.family, kc, kc,
                                double_buffer=double_buffer, exact_k=True)
        assert plan.smem_bytes == (2 if double_buffer else 1) * tiled.slot_bytes(
            sweep.family, kc, plan.tile_h, plan.tile_w)
        calls.append((plan.n_tiles_h * plan.n_tiles_w, kc))
        return tiled.tiled_relax(fields, sweep, n_mut, kc, prepare_fn=prepare, window=window,
                                 double_buffer=double_buffer)

    monkeypatch.setattr(ptiled, "_shard_chunk", planned_chunk)
    names, nan_name, omega, _, port_global, _ = FAMILIES[family]
    t = [torch.from_numpy(x) for x in _family_fields(rng, names, nan_name, (64, 96))]
    # the sweeps' field order: the relaxed fields first
    order = {"flow_llin4": [2, 3, 0, 1], "flow_llin8": [2, 3, 0, 1], "disp_llin4": [1, 0]}.get(
        family, [])
    tf = [t[i] for i in order] + t[len(order):]
    got = ptiled.tiled_relax_sharded(_cpu_mesh(2, 2), getattr(sweeps, f"{family}_sweep"), tf,
                                     tiled.LAYOUTS[family].n_mut, 9, omega,
                                     double_buffer=double_buffer)
    _assert_equal(got, port_global(*t, 9, omega))
    # 4 shards x 3 chunks (4, 4, 1 sweeps), each of several tiles
    assert len(calls) == 12 and all(n > 1 for n, _ in calls)
    assert sorted({kc for _, kc in calls}) == [1, 4]


def test_comm_false_differs_at_the_seams(rng):
    """The benchmark floor pads each tile with its own strips: wrong near
    the seams (2 iters px around them), exact away from them, and the same
    as pde_tpu's comm=False."""
    names = FAMILIES["flow_llin4"][0]
    f = [_field(rng, n) for n in names]
    t = [torch.from_numpy(x) for x in f]
    exact = ptiled.tiled_sor_flow_llin4(_cpu_mesh(2, 4), *t, 3, 1.9)
    floor = ptiled.tiled_sor_flow_llin4(_cpu_mesh(2, 4), *t, 3, 1.9, comm=False)
    rows = torch.arange(H)[:, None]
    cols = torch.arange(W)[None, :]
    near = ((rows - 16).abs() <= 6) | ((rows - 15).abs() <= 6)
    for seam in (12, 24, 36):
        near = near | ((cols - seam).abs() <= 6) | ((cols - seam + 1).abs() <= 6)
    for e, fl in zip(exact, floor):
        assert (e - fl).abs().max() > 1e-3
        assert torch.equal(torch.where(near, 0.0, e), torch.where(near, 0.0, fl))
    _close(floor, jtiled.tiled_sor_flow_llin4(_jax_mesh(2, 4), *(jnp.asarray(x) for x in f), 3,
                                              1.9, comm=False), JAX_TOL)


# (image (gh, gw), box in the image (R0, R1, C0, C1), k, tile)
WINDOW_CASES = {
    "odd origin, several tiles": ((21, 27), (5, 14, 7, 20), 2, (4, 6)),
    "one-tile box": ((21, 27), (3, 11, 9, 17), 3, (16, 16)),
    "1-px shard edge across the image": ((21, 27), (10, 11, 0, 27), 2, (8, 8)),
    "2-px shard edge down the image": ((21, 27), (0, 21, 13, 15), 1, (8, 8)),
    "the image's corner": ((21, 27), (0, 6, 20, 27), 4, (4, 4)),
    # the border's fill source lies outside the box: the 2k + 1 halo's case
    "1-px shard on the image's last row": ((21, 27), (20, 21, 0, 27), 2, (8, 8)),
    "1-px shard on the image's first column": ((21, 27), (0, 21, 0, 1), 1, (8, 8)),
}


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_windowed_plain_schedule_equals_global(rng, family, case):
    (gh, gw), (R0, R1, C0, C1), k, tile = WINDOW_CASES[case]
    names, nan_name, omega, _, port_global, _ = FAMILIES[family]
    t = [torch.from_numpy(x) for x in _family_fields(rng, names, nan_name, (gh, gw))]
    want = port_global(*t, k, omega)
    want = want if isinstance(want, tuple) else (want,)
    # the sweeps' field order: the relaxed fields first
    n_mut = len(want)
    order = {"flow_llin4": [2, 3, 0, 1], "flow_llin8": [2, 3, 0, 1], "disp_llin4": [1, 0]}.get(
        family, [])
    tf = [t[i] for i in order] + t[len(order):]
    factory = getattr(sweeps, f"{family}_sweep")
    prepare, sweep = factory(omega)
    halo_px = tiled._halo_for(family, k)  # 2k, and a pixel more with a border fill
    r0, r1 = max(0, R0 - halo_px), min(gh, R1 + halo_px)
    c0, c1 = max(0, C0 - halo_px), min(gw, C1 + halo_px)
    window = tiled.Window(r0, c0, gh, gw, (R0 - r0, R1 - r0, C0 - c0, C1 - c0))
    got = tiled.tiled_relax([x[r0:r1, c0:c1] for x in tf], sweep, n_mut, k, prepare_fn=prepare,
                            plan_override=(k, tile), window=window)
    _assert_equal(tuple(got), tuple(x[R0:R1, C0:C1] for x in want))


def test_window_refusals(rng):
    t = [torch.zeros((10, 12)) for _ in FAMILIES["flow_elin4"][0]]
    prepare, sweep = sweeps.flow_elin4_sweep(1.9)
    for window, match in ((tiled.Window(0, 0, 10, 12, (0, 11, 0, 12)), "non-empty box"),
                          (tiled.Window(2, 0, 10, 12, (0, 10, 0, 12)), "does not lie"),
                          # the box needs 4 px of halo above it, or the image's edge
                          (tiled.Window(3, 0, 20, 12, (2, 8, 0, 12)), "needs 4 pixels")):
        with pytest.raises(ValueError, match=match):
            tiled.tiled_relax(t, sweep, 2, 2, prepare_fn=prepare, window=window)
    with pytest.raises(ValueError, match="one chunk"):
        tiled.plain_tiled_relax(t, sweep, prepare, 2, 3, 2, 4, 4, tiled.whole(10, 12))


def test_tiled_pcg_matches_pde_tpu(rng):
    """The tile-local preconditioner's CG against pde_tpu's after 20
    iterations, within 1e-4 of the field's scale; and near the unsharded
    PCG's fixed point (tests/test_parallel.py's bar, 60 iterations)."""
    names = FAMILIES["flow_llin4"][0]
    f = [_field(rng, n) for n in names]
    t = [torch.from_numpy(x) for x in f]
    got = ptiled.tiled_pcg_flow_llin4(_cpu_mesh(2, 4), *t, 20)
    want = jtiled.tiled_pcg_flow_llin4(_jax_mesh(2, 4), *(jnp.asarray(x) for x in f), 20)
    for g, w_ in zip(got, want):
        w_ = np.asarray(w_)
        scale = float(np.abs(w_).max())
        np.testing.assert_allclose(g.numpy(), w_, atol=1e-4 * scale, rtol=0)
    got = ptiled.tiled_pcg_flow_llin4(_cpu_mesh(2, 4), *t, 60)
    for g, w_ in zip(got, pcg_flow_llin4(*t, 60, 1.9)):
        np.testing.assert_allclose(g.numpy(), w_.numpy(), atol=2e-3 * float(w_.abs().max()))


# ---------------------------------------------------------------------------
# the models with mesh=
# ---------------------------------------------------------------------------


def _spy(monkeypatch, module, name):
    """Count the calls of ``module.name`` by the (H, W) of their first field."""
    real, seen = getattr(module, name), []

    def spy(mesh, *args, **kw):
        seen.append(tuple(args[0].shape))
        return real(mesh, *args, **kw)

    monkeypatch.setattr(module, name, spy)
    return seen


def test_flow_nd_mesh_matches_unsharded_and_pde_tpu(rng, monkeypatch):
    """tests/test_parallel.py:216-229's case: 32x48, shard_min=16, two
    warps, two reweightings, two sweeps, on a 2x4 mesh."""
    img = (rng.random((32, 48)) * 255).astype(np.float32)
    shifted = np.roll(img, 1, axis=1)
    kw = dict(firstLoop=2, secondLoop=2, iter=2)
    want = flow_nd(img, shifted, "grad", "none", device="cpu", **kw)
    seen = _spy(monkeypatch, pmodel, "tiled_sor_flow_llin4")
    got = flow_nd(img, shifted, "grad", "none", mesh=_cpu_mesh(2, 4), shard_min=16, **kw)
    _assert_equal(got, want)
    # the two levels of >= 16 px that divide over the mesh, 4 solves each
    assert seen == [(24, 36)] * 4 + [(32, 48)] * 4
    jwant = jflow_nd(img, shifted, "grad", "none", mesh=_jax_mesh(2, 4), shard_min=16, **kw)
    _close(got, jwant, JAX_TOL)


@pytest.mark.parametrize("solver", [1, 2])
def test_flow_fmg_mesh_matches_unsharded(rng, monkeypatch, solver):
    """Fine FAS levels sharded, levels below shard_min whole; solver=2
    solves whole everywhere. Bit for bit against the unsharded call."""
    a = rng.random((48, 64)).astype(np.float32) * 255.0
    b = np.roll(a, 1, axis=1)
    kw = dict(solver=solver) if solver == 1 else dict(solver=2, firstLoop=1, iter=2)
    want = flow_fmg(a, b, device="cpu", **kw)
    seen = _spy(monkeypatch, fmg_mod, "tiled_sor_flow_elin4")
    got = flow_fmg(a, b, mesh=_cpu_mesh(2, 4), shard_min=24, **kw)
    _assert_equal(got, want)
    if solver == 1:
        # 48x64 and 24x32 are sharded: the FMG loop smooths them 2 and 4 times
        # over the FMG loop, firstLoop (4) solves a smoothing
        assert sorted(set(seen)) == [(24, 32), (48, 64)]
        assert seen.count((48, 64)) == 2 * 4 and seen.count((24, 32)) == 4 * 4
    else:
        assert seen == []


def test_device_rule(rng):
    img = (rng.random((16, 16)) * 255).astype(np.float32)
    cpu_mesh = _cpu_mesh(2, 2)
    with pytest.raises(ValueError, match="device='cuda' with a mesh of cpu"):
        flow_nd(img, img, mesh=cpu_mesh, device="cuda")
    with pytest.raises(ValueError, match="with a mesh of cpu"):
        flow_fmg(img, img, mesh=cpu_mesh, device="cuda")
    cuda_mesh = pmesh.make_mesh(1, 2, devices=["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="device='cpu' with a mesh of cuda"):
        flow_nd(img, img, mesh=cuda_mesh, device="cpu")
    with pytest.raises(ValueError, match="an input on cpu with a mesh of cuda"):
        flow_fmg(torch.from_numpy(img), torch.from_numpy(img), mesh=cuda_mesh)
    # a CPU mesh keeps everything on the CPU
    u, v = flow_nd(torch.from_numpy(img), torch.from_numpy(img), mesh=cpu_mesh, shard_min=8,
                   firstLoop=1, secondLoop=1, iter=1)
    assert u.device.type == v.device.type == "cpu"
    x = torch.zeros((16, 16))
    assert pmodel.place_level(x, cpu_mesh, 8)[1][1].shape == (8, 8)
    assert pmodel.place_level(x, cpu_mesh, 32) is not None and \
        pmodel.place_level(x, cpu_mesh, 32).shape == (16, 16)
    assert pmodel.constrain_level(x, cpu_mesh, 8) is cpu_mesh
    assert pmodel.constrain_level(torch.zeros((16, 15)), cpu_mesh, 8) is None


def test_window_wrapper_refuses_before_building(monkeypatch):
    """Off the CPU a windowed chunk goes to the kernel's wrapper, which
    checks the fields, the window and its box before the device, and builds
    nothing to refuse; a sweep without a tile kernel raises."""
    def no_build(*args, **kwargs):
        raise AssertionError("the wrapper must check its inputs before it builds")

    monkeypatch.setattr(build, "load", no_build)
    before = dict(tiled_cuda.LAUNCHES)
    meta = [torch.empty((12, 16), device="meta") for _ in FAMILIES["flow_elin4"][0]]
    good = tiled.Window(4, 0, 40, 16, (4, 8, 0, 16))
    cases = ((meta, good, "CUDA"), (meta[:-1], good, "takes 11 fields"),
             (meta, tiled.Window(4, 0, 40, 16, (2, 8, 0, 16)), "needs 4 pixels"),
             (meta, tiled.Window(4, 0, 12, 16, (4, 8, 0, 16)), "does not lie"))
    for fields, window, match in cases:
        with pytest.raises(ValueError, match=match):
            tiled_cuda.tiled_sor_window("flow_elin4", fields, 2, 1.9, window, 8, 8)
    prepare, sweep = sweeps.flow_elin4_sweep(1.9)
    with pytest.raises(ValueError, match="CUDA"):
        tiled.tiled_relax(meta, sweep, 2, 2, prepare_fn=prepare, window=good)
    # pde4's sweep with disp's prepare
    prepare, sweep = sweeps.disp_llin4_sweep(1.75)[0], sweeps.pde4_sweep(1.75)[1]
    with pytest.raises(ValueError, match="tile kernel runs"):
        tiled.tiled_relax(meta[:7], sweep, 1, 1, prepare_fn=prepare, window=good)
    assert tiled_cuda.LAUNCHES == before


# ---------------------------------------------------------------------------
# the sweep factories against pde_tpu's
# ---------------------------------------------------------------------------

SWEEPS = {
    "flow_llin4": (("du", "dv", "u", "v", "m", "cu", "cv", "duc", "dvc", "ww", "wn", "we", "ws"),
                   2, 1.9),
    "flow_elin4": (("u", "v", "m", "cu", "cv", "duc", "dvc", "ww", "wn", "we", "ws"), 2, 1.9),
    "flow_llin8": (("du", "dv", "u", "v", "m", "cu", "cv", "duc", "dvc") + W8, 2, 1.9),
    "disp_llin4": (("du", "u", "cu", "duc", "ww", "wn", "we", "ws"), 1, 1.9),
    "pde4": (("x", "trace", "b", "ww", "wn", "we", "ws"), 1, 1.75),
    "pde8": (("x", "trace", "b") + W8, 1, 1.75),
}


@pytest.mark.parametrize("family", sorted(SWEEPS))
def test_sweep_factory_matches_pde_tpu(rng, family):
    """Three sweeps of each factory over a whole 13x17 image, NaN in the
    data term: the port's plain tile schedule (one tile) against pde_tpu's
    prepare and sweeps on its whole-image aux."""
    names, n_mut, omega = SWEEPS[family]
    h, w = 13, 17
    f = [_field(rng, n, (h, w)) for n in names]
    nan_at = names.index("trace" if "trace" in names else "cu")
    f[nan_at][4:7, 3:9] = np.nan
    prepare, sweep = getattr(sweeps, f"{family}_sweep")(omega)
    got = tiled.plain_tiled_relax([torch.from_numpy(x) for x in f], sweep, prepare, n_mut, 3, 3,
                                  h, w)
    jprep, jsweep = getattr(jsweeps, f"{family}_sweep")(omega)
    ii = jnp.broadcast_to(jnp.arange(h)[:, None], (h, w))
    jj = jnp.broadcast_to(jnp.arange(w)[None, :], (h, w))
    aux = _make_aux(ii, jj, h, w)
    mut = [jnp.asarray(x) for x in f[:n_mut]]
    const = jprep([jnp.asarray(x) for x in f[n_mut:]], aux)
    for _ in range(3):
        mut = jsweep(mut, const, aux)
    _close(tuple(got), tuple(mut), 2e-6)
