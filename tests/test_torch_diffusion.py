"""The port's semi-implicit diffusion (``pde_tpu_torch/models/diffusion.py``)
held against ``pde_tpu``'s, 2-D and 3-channel, at its defaults: each of
the 6 iterations is one vertical and one horizontal tridiagonal solve.
Bound: max |Δ| <= 1e-4 of the image's 0..255 range, the solver bound
(1e-4 on unit-scale fields) scaled to the image.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from pde_tpu_torch.kernels import tdma_cuda

jdif = importlib.import_module("pde_tpu.models.diffusion")
tdif = importlib.import_module("pde_tpu_torch.models.diffusion")

torch.set_num_threads(1)

REL_TOL = 1e-4  # max |Δ| over the input's value range
CPU = dict(device="cpu")


def _noisy(rng, channels=None):
    shape = (30, 34) if channels is None else (channels, 30, 34)
    clean = np.full(shape, 60.0, np.float32)
    clean[..., 8:22, 10:26] = 180.0
    return clean + 20.0 * rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("channels", [None, 3])
def test_diffusion4_matches_reference(rng, channels):
    img = _noisy(rng, channels)
    scale = float(img.max() - img.min())
    want = np.asarray(jdif.diffusion4(img))
    before = dict(tdma_cuda.LAUNCHES)
    got = tdif.diffusion4(img, **CPU)
    assert tdma_cuda.LAUNCHES == before
    assert got.shape == img.shape and got.device.type == "cpu"
    assert np.isfinite(got.numpy()).all()
    assert float(np.abs(got.numpy() - want).max()) / scale <= REL_TOL
    # diffusion smooths: the noise in the flat background falls
    flat = np.s_[..., 24:29, 2:32]
    assert float(got.numpy()[flat].std()) < 0.5 * float(img[flat].std())


def test_params_and_device_rule(rng, monkeypatch):
    ref = jdif.Diffusion4Params(alpha=10.0, outer_iter=2)
    port = tdif.params_from_reference(ref)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(tdif.Diffusion4Params()) == dataclasses.asdict(jdif.Diffusion4Params())
    with pytest.raises(TypeError, match="bogus"):
        tdif.diffusion4(_noisy(rng), bogus=1, **CPU)
    out = tdif.diffusion4(torch.from_numpy(_noisy(rng)), outer_iter=0)
    assert out.device.type == "cpu" and out.shape == (30, 34)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdif.diffusion4(_noisy(rng))
