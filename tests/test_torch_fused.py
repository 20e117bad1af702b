"""The fused entry points of the port and ``models/_graph.py``, which makes
each of them one replayed CUDA graph a frame on the card.

Here (no card) the graph layer is held by what it does apart from CUDA:
the signature it caches a frame under, the copies into the static inputs
and the clones it returns (with the capture replaced by a plain stand-in),
the CPU path that never touches ``torch.cuda``, the device rule for numpy
inputs. The fused entry points are held bit for bit against their eager
functions on the CPU, ``flow_nd_sequence`` against ``pde_tpu``'s, and every
frame against what a capture refuses: run twice on the meta device with
the plain solvers, the second run (the capture's) reads nothing back to
the host and copies nothing from it.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from pde_tpu_torch.kernels.dispatch import plain_solvers
from pde_tpu_torch.models import _graph

jflow = importlib.import_module("pde_tpu.models.flow_nd")
tflow = importlib.import_module("pde_tpu_torch.models.flow_nd")
tdisp = importlib.import_module("pde_tpu_torch.models.disparity")
tsym = importlib.import_module("pde_tpu_torch.models.disparity_sym")
tad = importlib.import_module("pde_tpu_torch.models.flow_ad")
ttv = importlib.import_module("pde_tpu_torch.models.tv_denoise")
tgac = importlib.import_module("pde_tpu_torch.models.gac")
tfmg = importlib.import_module("pde_tpu_torch.models.flow_fmg")

torch.set_num_threads(1)

SEQ_TOL = 1e-3  # px, tests/test_models.py's bar between pde_tpu's sequence and its pairs
LOOPS = dict(firstLoop=2, secondLoop=2)


def _frames(rng, t=3, h=24, w=28):
    f0 = (rng.random((h, w)) * 255).astype(np.float32)
    return np.stack([np.roll(f0, k, axis=1) for k in range(t)])


def _image(rng, h=24, w=28):
    return rng.random((3, h, w)).astype(np.float32)


def _phi(h=24, w=28):
    yy, xx = np.mgrid[:h, :w]
    return (8.0 - np.hypot(yy - h / 2, xx - w / 2)).astype(np.float32)


# every fused entry point: (name, entry, its eager function, the static
# arguments after the inputs, inputs from a generator)
FUSED = [
    ("flow_nd_fused", tflow.flow_nd_fused, tflow.flow_nd,
     ("grad", "gradmag", tflow.FlowNDParams(**LOOPS)), lambda r: tuple(_frames(r, 2))),
    ("disparity_nd_fused", tdisp.disparity_nd_fused, tdisp.disparity_nd,
     ("grad", "gradmag", tdisp.DisparityParams(**LOOPS)), lambda r: tuple(_frames(r, 2))),
    ("disparity_sym_fused", tsym.disparity_sym_fused, tsym.disparity_sym,
     (tsym.DisparitySymParams(firstLoop=1, secondLoop=1, iter=2),),
     lambda r: tuple(_frames(r, 2))),
    ("flow_ad_fused", tad.flow_ad_fused, tad.flow_ad,
     ("grad", "gradmag", tad.FlowADParams(**LOOPS)), lambda r: tuple(_frames(r, 2))),
    ("tv_denoise4_fused", ttv.tv_denoise4_fused, ttv.tv_denoise4,
     (ttv.TVDenoise4Params(outer_iter=2),), lambda r: (_image(r),)),
    ("tv_denoise8_fused", ttv.tv_denoise8_fused, ttv.tv_denoise8,
     (ttv.TVDenoise8Params(outer_iter=2, inner_iter=3),), lambda r: (_image(r),)),
    ("gac_a_fused", tgac.gac_a_fused, tgac.gac_a, (tgac.GACParams(ITER=3),),
     lambda r: (_image(r), _phi())),
    ("gac_b_fused", tgac.gac_b_fused, tgac.gac_b, (tgac.GACParams(ITER=3),),
     lambda r: (_image(r), _phi())),
    ("flow_fmg_fused", tfmg.flow_fmg_fused, tfmg.flow_fmg,
     (tfmg.FlowFMGParams(firstLoop=1, iter=2),), lambda r: tuple(_frames(r, 2))),
]
FUSED_IDS = [case[0] for case in FUSED]


def _outs(x):
    return x if isinstance(x, tuple) else (x,)


# --- the signature -----------------------------------------------------


def test_graph_key_separates_entry_static_params_shape_and_device():
    a, b = np.zeros((3, 8, 9), np.float32), torch.zeros(3, 8, 9)
    p = tflow.FlowNDParams()
    key = _graph.graph_key(tflow.flow_nd, ("grad", "gradmag", p), (a, b), "cuda:0")
    # the same signature: an equal params object, a tensor of another
    # dtype, a numpy array for a tensor
    assert key == _graph.graph_key(tflow.flow_nd, ("grad", "gradmag", tflow.FlowNDParams()),
                                   (b.double(), a), torch.device("cuda", 0))
    others = [
        _graph.graph_key(tad.flow_ad, ("grad", "gradmag", p), (a, b), "cuda:0"),
        _graph.graph_key(tflow.flow_nd, ("grad", "none", p), (a, b), "cuda:0"),
        _graph.graph_key(tflow.flow_nd, ("grad", "gradmag", tflow.FlowNDParams(iter=5)),
                         (a, b), "cuda:0"),
        _graph.graph_key(tflow.flow_nd, ("grad", "gradmag", None), (a, b), "cuda:0"),
        _graph.graph_key(tflow.flow_nd, ("grad", "gradmag", p), (a[:, :, :8], b), "cuda:0"),
        _graph.graph_key(tflow.flow_nd, ("grad", "gradmag", p), (a[0], b[0]), "cuda:0"),
        _graph.graph_key(tflow.flow_nd, ("grad", "gradmag", p), (a, b), "cuda:1"),
    ]
    assert len({key, *others}) == len(others) + 1


class _StandIn:
    """A captured graph's stand-in: replay runs the eager function on the
    static inputs into the static outputs, as the graph's replay does."""

    def __init__(self, fn, static, bufs, outputs):
        self.fn, self.static, self.bufs, self.outputs = fn, static, bufs, outputs
        self.replays = 0

    def replay(self):
        self.replays += 1
        for o, n in zip(_outs(self.outputs), _outs(self.fn(*self.bufs, *self.static))):
            o.copy_(n)

    def reset(self):
        pass


@pytest.fixture
def stand_in(monkeypatch):
    """``_graph`` on the CPU with every capture a ``_StandIn``, as if the
    CPU were a card; yields the list of captures."""
    captures = []

    def capture(fn, static, inputs, device, rec):
        bufs = tuple(torch.empty(_graph._shape(x), dtype=torch.float32) for x in inputs)
        new = _graph.Frame(None, bufs, None)
        new.load(inputs)
        new.outputs = fn(*bufs, *static)
        new.graph = _StandIn(fn, static, bufs, new.outputs)
        captures.append(new)
        return new

    monkeypatch.setattr(_graph, "_capture", capture)
    monkeypatch.setattr(_graph, "input_device", lambda x, device=None: torch.device("cuda", 0))
    monkeypatch.setattr(_graph, "_FRAMES", {})
    yield captures


def test_plain_solvers_is_a_signature_of_its_own(stand_in):
    """Inside ``plain_solvers()`` the dispatch picks the plain solvers while
    the frame is captured, so a frame captured there is never replayed
    outside it, nor the other way round."""
    def route(x):
        return x + float(_graph._FORCE_PLAIN.get())

    x0 = np.zeros((2, 3), np.float32)
    with plain_solvers():
        inside = _graph.replay(route, (), (x0,))
    outside = _graph.replay(route, (), (x0,))
    with plain_solvers():
        again = _graph.replay(route, (), (x0,))
    assert len(stand_in) == 2 and [f.graph.replays for f in stand_in] == [2, 1]
    assert torch.equal(inside, again) and torch.equal(inside, torch.ones(2, 3))
    assert torch.equal(outside, torch.zeros(2, 3))


def test_same_signature_replays_one_capture_and_returns_clones(stand_in):
    def double(x, scale):
        return x * scale, x + 1.0

    x0 = np.arange(6, dtype=np.float64).reshape(2, 3)
    out0 = _graph.replay(double, (2.0,), (x0,))
    # another dtype and another array of the same shape: the same frame
    out1 = _graph.replay(double, (2.0,), (torch.ones(2, 3, dtype=torch.float64),))
    assert len(stand_in) == 1 and stand_in[0].graph.replays == 2
    frame = stand_in[0]
    assert frame.inputs[0].dtype == torch.float32
    # what the first call returned is its own: the second replay left it
    np.testing.assert_array_equal(out0[0].numpy(), 2.0 * x0.astype(np.float32))
    np.testing.assert_array_equal(out1[0].numpy(), np.full((2, 3), 2.0, np.float32))
    assert all(o is not s for o, s in zip(out1, frame.outputs))
    # a new static argument or shape is a new capture
    _graph.replay(double, (3.0,), (x0,))
    _graph.replay(double, (2.0,), (x0[:, :2],))
    assert len(stand_in) == 3 and len(_graph._FRAMES) == 3
    _graph.release_graphs()
    assert _graph._FRAMES == {}


def test_sequence_replays_the_pair_frame_of_flow_nd_fused(stand_in, rng):
    """One capture a (H, W) pair serves ``flow_nd_fused`` and every pair of
    the clip; the clip's flows are each pair's."""
    frames = torch.from_numpy(_frames(rng))
    p = tflow.FlowNDParams(**LOOPS)
    us, vs = tflow.flow_nd_sequence(frames, "grad", "none", p)
    u1, v1 = tflow.flow_nd_fused(frames[1], frames[2], "grad", "none", p)
    assert len(stand_in) == 1 and stand_in[0].graph.replays == 3
    for t in range(2):
        u, v = tflow.flow_nd(frames[t], frames[t + 1], "grad", "none", p)
        assert torch.equal(us[t], u) and torch.equal(vs[t], v)
    assert torch.equal(u1, us[1]) and torch.equal(v1, vs[1])


# --- the CPU path and the device rule ----------------------------------


@pytest.mark.parametrize("name,fused,eager,static,make", FUSED, ids=FUSED_IDS)
def test_cpu_tensors_never_touch_cuda_graphs(rng, monkeypatch, name, fused, eager, static,
                                             make):
    def refuse(*args, **kwargs):
        raise AssertionError(f"{name} on CPU tensors reached torch.cuda")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    monkeypatch.setattr(torch.cuda, "graph", refuse)
    monkeypatch.setattr(torch.cuda, "Stream", refuse)
    inputs = tuple(torch.from_numpy(x) for x in make(rng))
    out = _outs(fused(*inputs, *static))
    assert all(o.device.type == "cpu" and torch.isfinite(o).all() for o in out)
    assert _graph._FRAMES == {}


# the entry points whose numpy rule no other file holds
NUMPY_RULE = [c for c in FUSED if c[0] in ("disparity_nd_fused", "disparity_sym_fused",
                                            "tv_denoise4_fused", "gac_a_fused", "gac_b_fused",
                                            "flow_fmg_fused")]


@pytest.mark.parametrize("name,fused,eager,static,make", NUMPY_RULE,
                         ids=[c[0] for c in NUMPY_RULE])
def test_numpy_input_without_a_card_raises(rng, monkeypatch, name, fused, eager, static, make):
    """The device rule of ``models/_device.py``: a numpy input goes to the
    card unless ``device=`` names another, and with no card that raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fused(*make(rng), *static)


# --- the fused entry points against their eager functions --------------


# the entry points no other file holds bit for bit against their eager
# functions: flow_nd_fused with its default terms, flow_fmg_fused with its
# default smoother (solver=2, the PCG)
NOT_HELD = [c for c in FUSED if c[0] in ("flow_nd_fused", "flow_fmg_fused")]


@pytest.mark.parametrize("name,fused,eager,static,make", NOT_HELD,
                         ids=[c[0] for c in NOT_HELD])
def test_fused_is_eager_bit_for_bit(rng, name, fused, eager, static, make):
    inputs = make(rng)
    want = _outs(eager(*inputs, *static, device="cpu"))
    got = _outs(fused(*inputs, *static, device="cpu"))
    assert len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want))


def test_flow_nd_sequence_matches_reference(rng):
    """3 frames: the port's clip against ``pde_tpu``'s one ``lax.scan``
    program."""
    frames = _frames(rng)
    want = jflow.flow_nd_sequence(jnp.asarray(frames), "grad", "none",
                                  jflow.FlowNDParams(**LOOPS))
    got = tflow.flow_nd_sequence(frames, "grad", "none", tflow.FlowNDParams(**LOOPS),
                                 device="cpu")
    for w, g in zip(want, got):
        assert g.shape == (2, 24, 28)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=SEQ_TOL)


# --- what a capture refuses --------------------------------------------


class _HostTraffic(TorchDispatchMode):
    """Records every op that reads a device value on the host (a
    ``.item()``, a data-dependent shape) or copies from the host to the
    device: a CUDA graph can capture neither."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func)
        tensors = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        from_host = any(t.device.type == "cpu" and t.dim() > 0 for t in tensors)
        to_device = any(t.device.type == "meta" for t in tensors) or (
            kwargs.get("device") is not None and torch.device(kwargs["device"]).type == "meta")
        if any(k in name for k in ("_local_scalar_dense", "nonzero", "masked_select")) or (
                from_host and to_device):
            self.found.append(name)
        return func(*args, **kwargs)


@pytest.mark.parametrize("name,fused,eager,static,make", FUSED, ids=FUSED_IDS)
def test_frame_has_no_host_read_or_copy_after_warmup(rng, name, fused, eager, static, make):
    """The eager frame each fused entry point captures, run on the meta
    device: after a first run (the warm-up, which copies the resize
    matrices), a second run makes no host sync and no host-to-device copy.
    The plain solvers stand in for the kernels, which launch on the card
    with no host traffic of their own."""
    inputs = tuple(torch.from_numpy(np.asarray(x)).to("meta") for x in make(rng))
    if name == "flow_fmg_fused":  # the plain line solves scan: one level keeps it short
        inputs = tuple(x[..., :16, :20] for x in inputs)
    with plain_solvers():
        eager(*inputs, *static)
        spy = _HostTraffic()
        with spy:
            out = _outs(eager(*inputs, *static))
    assert spy.found == []
    assert all(o.device.type == "meta" for o in out)


def test_quantile_weight_reads_no_host_value(rng):
    """The tensor weights' lambda (an order statistic at a rank computed on
    the device) is gathered on the device: ``values[k]`` with a 0-d index
    tensor is read on the host, which a capture refuses."""
    from pde_tpu_torch.ops.weights import _quantile_nonzero

    nrm = torch.from_numpy(rng.random((9, 11)).astype(np.float32))
    nrm[nrm < 0.3] = 0.0
    want = _quantile_nonzero(nrm, 0.9)
    flat = nrm.reshape(-1)
    nz = int((flat > 0).sum())
    rank = flat.numel() - nz + int(np.round(np.float32(nz * 0.9))) - 1
    assert float(want) == float(torch.sort(flat).values[rank])
    on_meta, spy = nrm.to("meta"), _HostTraffic()
    with spy:
        _quantile_nonzero(on_meta, 0.9)
    assert spy.found == []
