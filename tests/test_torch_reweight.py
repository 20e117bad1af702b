"""The reweighting step as kernels (``csrc/reweight.cu``): the robust data
terms of the warping flows and of the disparity, and the diffusion
weights, routed by ``kernels/dispatch.py``.

Here (no card): CPU tensors take the plain path and build nothing; the
routing of a tensor that is not on the CPU, and ``plain_solvers()``; the
``reweight.kernel``/``reweight.plain`` counters of a frame and of a
capture; the plain robust terms, which form the products from the
derivative planes each call, equal them on product planes made once a
warp, as ``pde_tpu`` makes them; the weights' increments.
The tests marked ``card`` hold each kernel against the plain version on the
card bit for bit, and the replayed cell frames against the eager frame;
they skip where torch sees no card. On the card (``tests/conftest.py``
imports JAX, which the card's host lacks)::

    python -m pytest tests/test_torch_reweight.py -q -m card --noconftest
"""

import importlib

import numpy as np
import pytest
import torch

from pde_tpu_torch.core.pyramid import pyramid_scales
from pde_tpu_torch.kernels import build, dispatch, reweight_cuda
from pde_tpu_torch.kernels.plain_mode import plain_solvers
from pde_tpu_torch.models import _graph
from pde_tpu_torch.ops import robust, weights
from pde_tpu_torch.utils import observe

tflow = importlib.import_module("pde_tpu_torch.models.flow_nd")
tdisp = importlib.import_module("pde_tpu_torch.models.disparity")

torch.set_num_threads(1)

FLOW_P = tflow.FlowNDParams()
DISP_P = tdisp.DisparityParams()
# (second term, gradient-magnitude) of the robust cases: gradmag, none and
# a first-order second term
SND_CASES = [("gradmag", True), ("none", False), ("grad", False)]


@pytest.fixture
def gen():
    return np.random.default_rng(23)


@pytest.fixture
def clean():
    observe.reset()
    yield
    observe.reset()


@pytest.fixture
def no_build(monkeypatch):
    """Any build or load of a CUDA source fails the test."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path and the wrapper's checks must build nothing")

    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "build", refuse)


def _planes(gen, keys, c, hw, dev, nan: bool):
    """Derivative planes (C, H, W) of unit scale; with ``nan`` a block of
    pixels NaN in every plane of a channel, as a warp leaves them outside
    the image."""
    out = {}
    for k in keys:
        x = gen.standard_normal((c, *hw)).astype(np.float32)
        if nan:
            x[0, : max(1, hw[0] // 5), : max(1, hw[1] // 4)] = np.nan
            x[-1, -1, -1] = np.nan
        out[k] = torch.from_numpy(x).to(dev)
    return out


def _field(gen, hw, dev, scale=1.0):
    return torch.from_numpy((gen.standard_normal(hw) * scale).astype(np.float32)).to(dev)


def flow_case(gen, hw, snd, gradmag, priors, nan, dev, c1=6, c2=3):
    t1 = _planes(gen, ("dt", "dx", "dy"), c1, hw, dev, nan)
    t2 = None
    if snd != "none":
        keys = ("dxt", "dyt", "dxx", "dyy", "dxy") if gradmag else ("dt", "dx", "dy")
        t2 = _planes(gen, keys, c2 if gradmag else c1, hw, dev, nan)
    u, v, du, dv = (_field(gen, hw, dev, s) for s in (2.0, 2.0, 0.3, 0.3))
    us = vs = None
    if priors:
        # priors near the field, as a pyramid's coarser estimate is
        us, vs = u + _field(gen, hw, dev, 0.7), v + _field(gen, hw, dev, 0.7)
    return t1, t2, u, v, du, dv, us, vs


def disp_case(gen, hw, snd, gradmag, prior, nan, dev, c1=6, c2=3):
    d1 = _planes(gen, ("dt", "dx"), c1, hw, dev, nan)
    d2 = None
    if snd != "none":
        keys = ("dxt", "dyt", "dxx", "dxy") if gradmag else ("dt", "dx")
        d2 = _planes(gen, keys, c2 if gradmag else c1, hw, dev, nan)
    u, du = _field(gen, hw, dev, 4.0), _field(gen, hw, dev, 0.3)
    us = u + _field(gen, hw, dev, 0.7) if prior else None
    return d1, d2, u, du, us


def _product_path_flow(t1, t2, u, v, du, dv, us, vs, as_diff, p, gradmag):
    """The flows' robust terms on product planes made once a warp
    (``pde_tpu``'s ``_fst_tensors``/``_snd_tensors`` formulas), then
    weighted and nansum-reduced a reweighting."""
    def products(t):
        if "dxt" in t:
            dxt, dyt, dxx, dyy, dxy = (t[k] for k in ("dxt", "dyt", "dxx", "dyy", "dxy"))
            return [dxy * (dxx + dyy), dxt * dxx + dyt * dxy, dxt * dxy + dyt * dyy,
                    dxx * dxx + dxy * dxy, dxy * dxy + dyy * dyy]
        dt, dx, dy = t["dt"], t["dx"], t["dy"]
        return [dy * dx, dt * dx, dt * dy, dx * dx, dy * dy]

    op1 = (t1["dt"] - t1["dx"] * du - t1["dy"] * dv) ** 2
    parts = [[k * (p.b1 / (p.alpha * torch.sqrt(op1 + 1e-5)))] for k in products(t1)]
    if t2 is not None:
        if gradmag:
            op2 = ((t2["dxt"] - t2["dxx"] * du - t2["dxy"] * dv) ** 2
                   + (t2["dyt"] - t2["dxy"] * du - t2["dyy"] * dv) ** 2)
        else:
            op2 = (t2["dt"] - t2["dx"] * du - t2["dy"] * dv) ** 2
        gd2 = p.b2 / (p.alpha * torch.sqrt(op2 + 1e-5))
        for part, k in zip(parts, products(t2)):
            part.append(k * gd2)
    for prior, f, df, (c, d) in ((us, u, du, (1, 3)), (vs, v, dv, (2, 4))):
        if prior is not None:
            gs = p.gammaS / (p.alpha * (1.0 + (prior - f - df) ** 2 / as_diff**2))
            parts[c].append(((prior - f) * gs)[None])
            parts[d].append(gs[None])
    return tuple(sum(torch.nansum(x, dim=0) for x in part) for part in parts)


def _product_path_disp(d1, d2, u, du, us, as_diff, p, gradmag):
    """The disparity's robust terms on (Cu, Du) planes made once a warp
    (``pde_tpu/models/disparity.py``), a plain channel sum."""
    def products(d):
        if "dxt" in d:
            return [d["dxt"] * d["dxx"] + d["dyt"] * d["dxy"],
                    d["dxx"] * d["dxx"] + d["dxy"] * d["dxy"]]
        return [d["dt"] * d["dx"], d["dx"] * d["dx"]]

    op1 = (d1["dt"] - d1["dx"] * du) ** 2
    parts = [[k * (p.b1 / (p.alpha * torch.sqrt(op1 + 1e-5)))] for k in products(d1)]
    if d2 is not None:
        if gradmag:
            op2 = (d2["dxt"] - d2["dxx"] * du) ** 2 + (d2["dyt"] - d2["dxy"] * du) ** 2
        else:
            op2 = (d2["dt"] - d2["dx"] * du) ** 2
        gd2 = p.b2 / (p.alpha * torch.sqrt(op2 + 1e-5))
        for part, k in zip(parts, products(d2)):
            part.append(k * gd2)
    if us is not None:
        gs = (p.gammaS / p.alpha) * torch.exp(-((us - u - du) ** 2) / as_diff**2)
        parts[0].append(((us - u) * gs)[None])
        parts[1].append(gs[None])
    return tuple(sum(torch.sum(x, dim=0) for x in part) for part in parts)


def _same(got, want) -> bool:
    """Bit for bit, NaN where NaN."""
    return all(g.shape == w.shape and torch.equal(torch.isnan(g), torch.isnan(w))
               and torch.equal(torch.nan_to_num(g, 7.0), torch.nan_to_num(w, 7.0))
               for g, w in zip(got, want))


# --- the plain path and the routing -------------------------------------


@pytest.mark.parametrize("snd,gradmag", SND_CASES)
@pytest.mark.parametrize("priors", [False, True])
def test_plain_flow_terms_on_derivatives_equal_the_product_path(gen, snd, gradmag, priors):
    """The robust terms take derivative planes alone and form the products
    each call, with the numbers of product planes made once a warp."""
    t1, t2, u, v, du, dv, us, vs = flow_case(gen, (13, 17), snd, gradmag, priors, True, "cpu")
    args = (u, v, du, dv, us, vs, 1.5, FLOW_P, gradmag)
    bare = robust.robust_terms_flow(t1, t2, *args)
    made = _product_path_flow(t1, t2, *args)
    assert len(bare) == 5 and _same(bare, made)
    assert all(torch.isfinite(x).all() for x in bare)  # nansum: a NaN channel counts 0


@pytest.mark.parametrize("snd,gradmag", SND_CASES)
@pytest.mark.parametrize("prior", [False, True])
def test_plain_disp_terms_on_derivatives_equal_the_product_path(gen, snd, gradmag, prior):
    d1, d2, u, du, us = disp_case(gen, (13, 17), snd, gradmag, prior, True, "cpu")
    bare = robust.robust_terms_disp(d1, d2, u, du, us, 1.75, DISP_P, gradmag)
    made = _product_path_disp(d1, d2, u, du, us, 1.75, DISP_P, gradmag)
    assert len(bare) == 2 and _same(bare, made)
    assert torch.isnan(bare[0]).any()  # a plain sum: NaN stays


@pytest.mark.parametrize("combine,zero_borders", [("sum", False), ("max", True)])
def test_weights_increments_equal_the_summed_fields(gen, combine, zero_borders):
    """``dispatch.diffusion_weights_4`` of fields and increments equals the
    plain weights of their sums, for planes, a (C, H, W) and an (H, W)
    tensor."""
    f = [_field(gen, (11, 14), "cpu") for _ in range(2)]
    d = [_field(gen, (11, 14), "cpu", 0.1) for _ in range(2)]
    kw = dict(eps=1e-5, combine=combine, zero_borders=zero_borders)
    want = weights.diffusion_weights_4(torch.stack([f[0] + d[0], f[1] + d[1]]), **kw)
    assert _same(dispatch.diffusion_weights_4(f, increments=d, **kw), want)
    assert _same(dispatch.diffusion_weights_4(torch.stack(f), increments=torch.stack(d), **kw),
                 want)
    one = weights.diffusion_weights_4(f[0] + d[0], **kw)
    assert _same(dispatch.diffusion_weights_4(f[0], increments=d[0], **kw), one)
    assert _same(dispatch.diffusion_weights_4(torch.stack(f), **kw),
                 weights.diffusion_weights_4(torch.stack(f), **kw))


def test_cpu_path_builds_nothing(gen, clean, no_build):
    """CPU tensors take the plain path: no build, no load, no launch, and
    each call counts ``reweight.plain``."""
    before = dict(reweight_cuda.LAUNCHES)
    t1, t2, u, v, du, dv, us, vs = flow_case(gen, (9, 12), "gradmag", True, True, False, "cpu")
    got = dispatch.robust_flow(t1, t2, u, v, du, dv, us, vs, 1.5, FLOW_P, True)
    assert _same(got, robust.robust_terms_flow(t1, t2, u, v, du, dv, us, vs, 1.5, FLOW_P, True))
    d1, d2, u, du, us = disp_case(gen, (9, 12), "gradmag", True, True, False, "cpu")
    dispatch.robust_disp(d1, d2, u, du, us, 1.75, DISP_P, True)
    dispatch.diffusion_weights_4((u, du), increments=(du, u))
    assert observe.record()["counters"] == {"reweight.plain": 3}
    assert reweight_cuda.LAUNCHES == before
    assert reweight_cuda._lib.cache_info().currsize == 0


def test_the_wrapper_refuses_what_the_kernel_does_not_take(gen, no_build):
    """CPU tensors, another dtype, a non-contiguous plane, a shape that
    does not match, too many channels: each raises before anything is
    built."""
    t1, t2, u, v, du, dv, _, _ = flow_case(gen, (9, 12), "gradmag", True, False, False, "cpu")
    args = (1.5, 0.042, 1.48, 0.29, 0.01, True)
    with pytest.raises(ValueError, match="CUDA"):
        reweight_cuda.robust_flow(t1, t2, u, v, du, dv, None, None, *args)
    with pytest.raises(ValueError, match="CUDA"):
        reweight_cuda.weights4([u], None, 1e-5, "sum", False)
    with pytest.raises(ValueError, match="1 to 8"):
        reweight_cuda.weights4([u] * 9, None, 1e-5, "sum", False)
    meta = {k: x.to("meta") for k, x in t1.items()}
    mu, mv, mdu, mdv = (x.to("meta") for x in (u, v, du, dv))
    with pytest.raises(ValueError, match="float32"):
        reweight_cuda.robust_flow({**meta, "dx": meta["dx"].double()}, None, mu, mv, mdu, mdv,
                                  None, None, *args)
    with pytest.raises(ValueError, match="contiguous"):
        reweight_cuda.robust_flow(meta, None, mu, mv, mdu.t().contiguous().t(), mdv, None, None,
                                  *args)
    with pytest.raises(ValueError, match=r"\(6, 9, 12\)"):
        reweight_cuda.robust_flow({**meta, "dy": meta["dy"][:5]}, None, mu, mv, mdu, mdv,
                                  None, None, *args)
    with pytest.raises(ValueError, match="increments"):
        reweight_cuda.weights4([mu, mv], [mdu], 1e-5, "sum", False)


def test_plain_solvers_routes_every_device_to_the_plain_version(gen, clean, monkeypatch):
    """A tensor off the CPU goes to the kernel (here a stand-in on the
    ``meta`` device) and counts ``reweight.kernel``; inside
    ``plain_solvers()`` it runs the plain version and counts
    ``reweight.plain``."""
    calls = []
    for name in ("robust_flow", "robust_disp", "weights4"):
        monkeypatch.setattr(reweight_cuda, name,
                            lambda *a, _n=name, **k: calls.append(_n) or ("kernel",))
    t1, t2, u, v, du, dv, us, vs = flow_case(gen, (9, 12), "gradmag", True, False, False, "meta")
    d1, d2, _, _, _ = disp_case(gen, (9, 12), "gradmag", True, False, False, "meta")

    def run():
        return (dispatch.robust_flow(t1, t2, u, v, du, dv, us, vs, 1.5, FLOW_P, True),
                dispatch.robust_disp(d1, d2, u, du, None, 1.75, DISP_P, True),
                dispatch.diffusion_weights_4((u, v), increments=(du, dv)))

    assert run() == (("kernel",),) * 3
    assert calls == ["robust_flow", "robust_disp", "weights4"]
    assert observe.record()["counters"] == {"reweight.kernel": 3}
    with plain_solvers():
        flow, disp, w4 = run()
    assert calls == ["robust_flow", "robust_disp", "weights4"]
    assert [x.shape for x in (*flow, *disp, *w4)] == [(9, 12)] * 11
    assert all(x.device.type == "meta" for x in (*flow, *disp, *w4))
    assert observe.record()["counters"] == {"reweight.kernel": 3, "reweight.plain": 3}


LOOPS = dict(firstLoop=2, secondLoop=2)


@pytest.mark.parametrize("name", ["flow_nd", "disparity_nd"])
def test_a_frame_counts_its_reweightings(gen, clean, name):
    """A CPU frame counts one ``reweight.plain`` a robust call and one a
    weights call: 2 x levels x firstLoop x secondLoop; a capture's record
    holds the counts of the frame it captured."""
    shape, stop, fn, params = ((3, 40, 56), 20, tflow.flow_nd, tflow.FlowNDParams(**LOOPS))
    if name == "disparity_nd":
        shape, stop, fn, params = ((3, 40, 56), 10, tdisp.disparity_nd,
                                   tdisp.DisparityParams(**LOOPS))
    a = (gen.random(shape) * 255).astype(np.float32)
    b = np.roll(a, 1, axis=-1)
    levels = len(pyramid_scales(*shape[1:], 0.75, stop))
    expected = {"reweight.plain": 2 * levels * 2 * 2}
    fn(a, b, params=params, device="cpu")
    assert observe.record()["counters"] == expected
    rec = observe.GraphRecord("stand-in")
    with observe.capture(rec, lambda: 0, lambda marks: [0] * len(marks)):
        fn(a, b, params=params, device="cpu")
    assert rec.counters == expected
    assert observe.record()["counters"] == {"reweight.plain": 2 * expected["reweight.plain"]}


# --- on the card --------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _graph.release_graphs()
    observe.reset()
    yield torch.device("cuda", 0)
    _graph.release_graphs()
    observe.reset()


# the cells' finest levels, a middle and the coarsest level of each
# (pyramid_scales of 436x1024 stop 20 and 375x1242 stop 10), and odd edge
# cases where every pixel is on the border
CARD_SHAPES = [(436, 1024), (184, 432), (20, 46), (375, 1242), (119, 393), (8, 24),
               (3, 37), (37, 3), (1, 5)]
CARD_SHAPE_IDS = [f"{h}x{w}" for h, w in CARD_SHAPES]


def _kernel_and_plain(fn, *args):
    got = fn(*args)
    with plain_solvers():
        want = fn(*args)
    torch.cuda.synchronize()
    return got, want


def _diff(got, want) -> float:
    return max(float(torch.nan_to_num((g - w).abs(), 0.0).max()) for g, w in zip(got, want))


@pytest.mark.card
@pytest.mark.parametrize("hw", CARD_SHAPES, ids=CARD_SHAPE_IDS)
@pytest.mark.parametrize("snd,gradmag", SND_CASES)
@pytest.mark.parametrize("priors,nan", [(False, True), (True, False), (True, True)])
def test_flow_robust_kernel_is_the_plain_version(card, gen, hw, snd, gradmag, priors, nan):
    case = flow_case(gen, hw, snd, gradmag, priors, nan, card)
    # ASdiff of flow level 12, where float32(1 / s) and 1 / float32(s) differ
    got, want = _kernel_and_plain(dispatch.robust_flow, *case, 2.0 * 0.75**12, FLOW_P, gradmag)
    assert _same(got, want), _diff(got, want)
    assert reweight_cuda.LAUNCHES["robust_flow"] > 0


@pytest.mark.card
@pytest.mark.parametrize("c1,c2", [(1, 1), (2, 1), (3, 3), (5, 4), (9, 7)])
def test_flow_robust_kernel_takes_any_channels(card, gen, c1, c2):
    case = flow_case(gen, (37, 53), "gradmag", True, True, True, card, c1, c2)
    got, want = _kernel_and_plain(dispatch.robust_flow, *case, 1.5, FLOW_P, True)
    assert _same(got, want), _diff(got, want)


@pytest.mark.card
@pytest.mark.parametrize("c1,c2", [(1, 1), (2, 1), (3, 3), (5, 4), (9, 7)])
@pytest.mark.parametrize("prior", [False, True])
def test_disp_robust_kernel_takes_any_channels(card, gen, c1, c2, prior):
    case = disp_case(gen, (37, 53), "gradmag", True, prior, True, card, c1, c2)
    got, want = _kernel_and_plain(dispatch.robust_disp, *case, 0.7, DISP_P, True)
    assert _same(got, want), _diff(got, want)


@pytest.mark.card
@pytest.mark.parametrize("hw", CARD_SHAPES, ids=CARD_SHAPE_IDS)
@pytest.mark.parametrize("snd,gradmag", SND_CASES)
@pytest.mark.parametrize("prior,nan", [(False, True), (True, False), (True, True)])
def test_disp_robust_kernel_is_the_plain_version(card, gen, hw, snd, gradmag, prior, nan):
    case = disp_case(gen, hw, snd, gradmag, prior, nan, card)
    # ASdiff of stereo level 6, as for the flow
    got, want = _kernel_and_plain(dispatch.robust_disp, *case, 1.75 * 0.75**6, DISP_P, gradmag)
    assert _same(got, want), _diff(got, want)
    assert reweight_cuda.LAUNCHES["robust_disp"] > 0


@pytest.mark.card
@pytest.mark.parametrize("hw", CARD_SHAPES, ids=CARD_SHAPE_IDS)
@pytest.mark.parametrize("c", [1, 2, 3])
@pytest.mark.parametrize("combine,zero_borders", [("sum", False), ("sum", True),
                                                  ("max", False), ("max", True)])
@pytest.mark.parametrize("increments", [False, True])
def test_weights4_kernel_is_the_plain_version(card, gen, hw, c, combine, zero_borders,
                                              increments):
    f = [_field(gen, hw, card, 2.0) for _ in range(c)]
    f[0][0, 0] = float("nan")
    d = [_field(gen, hw, card, 0.3) for _ in range(c)] if increments else None
    got, want = _kernel_and_plain(
        lambda: dispatch.diffusion_weights_4(f, 1e-5, combine, zero_borders, increments=d))
    assert _same(got, want), _diff(got, want)
    assert reweight_cuda.LAUNCHES["weights4"] > 0


@pytest.mark.card
def test_the_scalar_reciprocal_is_pytorchs(card, gen):
    """A plane over a Python scalar, as the priors divide by ASdiff^2, is on
    the card the product with the reciprocal the wrapper passes the kernels,
    at the ASdiff of every level of both models' pyramids."""
    x = torch.from_numpy(gen.standard_normal(200_000).astype(np.float32)).to(card)
    for lvl in range(24):
        for as_diff in (2.0 * (1.0 / 0.75) ** (-lvl), 1.75 * 0.75**lvl):
            assert torch.equal(x / as_diff**2, x * reweight_cuda._inv_square(as_diff)), as_diff


def _reweight_plain_only(monkeypatch):
    """Route the reweighting alone to the plain version: the frame keeps its
    SOR kernels, so the two frames differ by the reweighting kernels only."""
    def plain(x):
        observe.count("reweight.plain")
        return True

    monkeypatch.setattr(dispatch, "_reweight_plain", plain)


# a cell's frame: (entry, fused entry, shape, graph counters of the capture)
CELL_FRAMES = {
    "flow_nd.sintel": (tflow.flow_nd, tflow.flow_nd_fused, (3, 436, 1024),
                       {"reweight.kernel": 384}),
    "disparity_nd.kitti": (tdisp.disparity_nd, tdisp.disparity_nd_fused, (3, 375, 1242),
                           {"reweight.kernel": 720}),
}


@pytest.mark.card
@pytest.mark.parametrize("cell", list(CELL_FRAMES))
def test_the_replayed_cell_frame_is_the_eager_frame(card, gen, monkeypatch, cell):
    """The replayed frame at the cell's size counts 2 x 192 (flow) or 2 x
    360 (stereo) reweighting kernels and no plain one in its capture; it
    equals the eager frame bit for bit with its SOR kernels and its
    reweighting plain, and the all-plain eager frame bit for bit (stereo)
    or within the gaps of the frame with plain reweighting (flow: its llin4
    SOR kernel rounds otherwise than the plain solve; on this noise scene
    the frame with SOR kernels and plain reweighting reads a widest gap of
    1.26e-3 px against the all-plain frame, so the bounds are twice that
    and the benchmark's mean limit)."""
    eager, fused, shape, counted = CELL_FRAMES[cell]
    a = (gen.random(shape) * 255).astype(np.float32)
    b = np.roll(a, (1, 2), axis=(-2, -1))
    got = fused(a, b)
    got = got if isinstance(got, tuple) else (got,)
    (rec,) = observe.record()["graphs"]
    # the SOR calls' route counters are tests/test_torch_routes.py's
    assert {k: n for k, n in rec["counters"].items() if k.startswith("reweight.")} == counted
    with plain_solvers():
        plain = eager(a, b)
    plain = plain if isinstance(plain, tuple) else (plain,)
    _reweight_plain_only(monkeypatch)
    mixed = eager(a, b)
    mixed = mixed if isinstance(mixed, tuple) else (mixed,)
    assert _same(got, mixed), _diff(got, mixed)
    if cell.startswith("disparity"):
        assert _same(got, plain), _diff(got, plain)
    else:
        gaps = torch.cat([(g - w).abs().reshape(-1) for g, w in zip(got, plain)])
        assert float(gaps.mean()) <= 8e-6 and float(gaps.max()) <= 2.5e-3


def _other_callers():
    fa = importlib.import_module("pde_tpu_torch.models.flow_ad")
    ds = importlib.import_module("pde_tpu_torch.models.disparity_sym")
    tv = importlib.import_module("pde_tpu_torch.models.tv_denoise")
    df = importlib.import_module("pde_tpu_torch.models.diffusion")
    fm = importlib.import_module("pde_tpu_torch.models.flow_fmg")
    mesh = importlib.import_module("pde_tpu_torch.parallel.mesh")
    loops = dict(firstLoop=2, secondLoop=2)
    return {
        "flow_ad": lambda a, b: fa.flow_ad(a, b, **loops),
        "flow_nd_prior": lambda a, b: tflow.flow_nd(a, b, "grad", "grad", us=a[0] / 100,
                                                    vs=-a[1] / 100, **loops),
        "flow_nd_mesh": lambda a, b: tflow.flow_nd(
            a, b, mesh=mesh.make_mesh(2, 2, devices=[torch.device("cuda", 0)] * 4),
            shard_min=32, **loops),
        "disparity_sym": lambda a, b: ds.disparity_sym(a, b, firstLoop=2, secondLoop=2),
        "disparity_prior": lambda a, b: tdisp.disparity_nd(a, b, "gray", "none", us=a[0] / 50,
                                                           **loops),
        "tv_denoise4": lambda a, b: tv.tv_denoise4(a),
        "diffusion4": lambda a, b: df.diffusion4(a),
        "flow_fmg": lambda a, b: fm.flow_fmg(a, b),
    }


@pytest.mark.card
@pytest.mark.parametrize("name", list(_other_callers()))
def test_every_caller_gets_the_plain_reweighting_numbers(card, gen, monkeypatch, name):
    """The models that share the changed code (the weights of every
    caller, the flows' robust terms over a mesh and in flow_ad, the
    priors) give the same fields, bit for bit, with the reweighting on the
    kernels and on the plain version."""
    a = (gen.random((3, 96, 128)) * 255).astype(np.float32)
    b = np.roll(a, (1, 1), axis=(-2, -1))
    run = _other_callers()[name]
    got = run(a, b)
    assert observe.record()["counters"].get("reweight.kernel", 0) > 0
    _reweight_plain_only(monkeypatch)
    want = run(a, b)
    got, want = ((x if isinstance(x, tuple) else (x,)) for x in (got, want))
    assert _same(got, want), _diff(got, want)
