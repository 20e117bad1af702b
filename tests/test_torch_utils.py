"""The port's utils (``pde_tpu_torch/utils``): the checkpoint format, shared
with ``pde_tpu`` (each package reads the other's files), ``flow2color``
equal to ``pde_tpu``'s, the eager ``probe`` and the image loader."""

import importlib
import warnings

import numpy as np
import pytest
import torch

jck = importlib.import_module("pde_tpu.utils.checkpoint")
tck = importlib.import_module("pde_tpu_torch.utils.checkpoint")
jviz = importlib.import_module("pde_tpu.utils.viz")
tviz = importlib.import_module("pde_tpu_torch.utils.viz")
tobs = importlib.import_module("pde_tpu_torch.utils.observe")
tio = importlib.import_module("pde_tpu_torch.utils.io")


def _state(rng):
    return {"phase": 2, "phi": torch.from_numpy(rng.standard_normal((2, 5, 6)).astype(np.float32)),
            "models": [np.arange(3, dtype=np.float32), (np.ones(2), 7.5)],
            "none": None, "key": np.array([1, 2], np.uint32)}


def _assert_same(got, want):
    """The same containers; leaves equal as arrays."""
    if isinstance(want, (dict, list, tuple)):
        assert type(got) is type(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif want is None:
        assert got is None
    else:
        w = want.numpy() if torch.is_tensor(want) else np.asarray(want)
        np.testing.assert_array_equal(got, w)


def test_checkpoint_round_trip(rng, tmp_path):
    """Nested dicts, lists, tuples, None, tensors and scalars come back as
    numpy arrays in the same structure; the write leaves no temporary file."""
    st = _state(rng)
    path = str(tmp_path / "sub" / "ck.npz")
    tck.save_state(path, st)
    assert [p.name for p in (tmp_path / "sub").iterdir()] == ["ck.npz"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        back = tck.load_state(path, st)
    _assert_same(back, st)


def test_checkpoint_format_is_pde_tpus(rng, tmp_path):
    """A file written by either package loads in the other without a
    structure warning, leaf for leaf."""
    st = _state(rng)
    st_np = {**st, "phi": st["phi"].numpy()}
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    tck.save_state(a, st)
    jck.save_state(b, st_np)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _assert_same(jck.load_state(a, st_np), st_np)
        _assert_same(tck.load_state(b, st), st)
    with np.load(a) as za, np.load(b) as zb:
        assert bytes(za["__meta__"]) == bytes(zb["__meta__"])


def test_checkpoint_arity_and_structure_checks(rng, tmp_path):
    path = str(tmp_path / "ck.npz")
    tck.save_state(path, {"a": np.zeros(2), "b": np.ones(3)})
    with pytest.raises(ValueError, match="leaves"):
        tck.load_state(path, {"a": 0})
    with pytest.warns(UserWarning, match="treedef differs"):
        back = tck.load_state(path, {"x": 0, "y": 0})
    np.testing.assert_array_equal(back["x"], np.zeros(2))


def test_flow2color_matches_reference(rng):
    u = rng.standard_normal((12, 16)) * 3
    v = rng.standard_normal((12, 16)) * 3
    u[2, 3] = np.nan
    v[5, 5] = np.inf
    for kw in ({}, {"max_mag": 2.0}, {"border": 4}):
        want = jviz.flow2color(u, v, **kw)
        np.testing.assert_array_equal(tviz.flow2color(u, v, **kw), want)
        np.testing.assert_array_equal(
            tviz.flow2color(torch.from_numpy(u), torch.from_numpy(v), **kw), want)


def test_probe_reaches_the_sinks(capsys):
    seen = []
    tobs.clear_sinks()
    tobs.add_sink(lambda tag, v: seen.append((tag, v)))
    try:
        tobs.probe("norm", torch.linalg.norm(torch.ones(4)))
        tobs.probe("count", 3)
    finally:
        tobs.clear_sinks()
    assert seen == [("norm", 2.0), ("count", 3.0)]
    tobs.probe("plain", torch.tensor(0.5))  # no sink: printed
    assert "[probe] plain = 0.5" in capsys.readouterr().out


def test_load_image_reads_a_png(tmp_path, rng):
    from PIL import Image

    rgb = (rng.random((7, 9, 3)) * 255).astype(np.uint8)
    path = tmp_path / "img.png"
    Image.fromarray(rgb).save(path)
    img = tio.load_image(str(path))
    assert img.dtype == np.float32 and img.shape == (3, 7, 9)
    np.testing.assert_array_equal(img, rgb.transpose(2, 0, 1).astype(np.float32))
    gray = tio.load_image(str(path), gray=True)
    assert gray.shape == (1, 7, 9)
    want = np.asarray(Image.fromarray(rgb).convert("L"), np.float32)
    np.testing.assert_array_equal(gray[0], want)
    assert tio.REFERENCE_IMAGES == importlib.import_module("pde_tpu.utils.io").REFERENCE_IMAGES
