"""The port's connected components (``ops/components.py``) held against
``pde_tpu``'s: ``label_components`` and ``biggest_component_mask`` are exact
(int32 labels, 1 + the smallest linear index of each 8-connected
component; the first component wins a tie for the biggest).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jcomp = importlib.import_module("pde_tpu.ops.components")
tcomp = importlib.import_module("pde_tpu_torch.ops.components")

torch.set_num_threads(1)


def _check(mask: np.ndarray) -> None:
    """Both functions on ``mask`` against pde_tpu, exactly."""
    want = np.asarray(jcomp.label_components(jnp.asarray(mask)))
    got = tcomp.label_components(torch.from_numpy(mask))
    assert got.dtype == torch.int32 and got.shape == mask.shape
    np.testing.assert_array_equal(got.numpy(), want)
    want_big = np.asarray(jcomp.biggest_component_mask(jnp.asarray(mask)))
    got_big = tcomp.biggest_component_mask(torch.from_numpy(mask))
    assert got_big.dtype == torch.bool
    np.testing.assert_array_equal(got_big.numpy(), want_big)


@pytest.mark.parametrize("density", [0.3, 0.45, 0.55, 0.7])
@pytest.mark.parametrize("shape", [(23, 31), (40, 53)])
def test_random_masks_match_reference(density, shape):
    rng = np.random.default_rng(int(density * 100) + shape[0])
    _check(rng.random(shape) < density)


def test_serpentine_region_is_one_component():
    """Rows joined alternately at the left and right ends: one component whose
    labels must travel the whole path."""
    m = np.zeros((41, 37), bool)
    m[::2, :] = True
    for i in range(1, 41, 2):
        m[i, 0 if (i // 2) % 2 else 36] = True
    _check(m)
    lab = tcomp.label_components(torch.from_numpy(m))
    assert set(np.unique(lab.numpy())) == {0, 1}


def test_diagonal_links_connect():
    """A staircase of pixels touching only at corners is one 8-connected
    component; a 4-connected labelling would give one a pixel."""
    m = np.zeros((12, 12), bool)
    idx = np.arange(12)
    m[idx, idx] = True
    m[idx[:-1], 11 - idx[:-1]] = True
    _check(m)
    lab = tcomp.label_components(torch.from_numpy(m)).numpy()
    assert len(np.unique(lab[m])) == 1


@pytest.mark.parametrize("fill", [False, True])
def test_empty_and_full_masks(fill):
    """A full mask is one component labelled 1; an empty one labels nothing,
    and its biggest-component mask is, as in pde_tpu, the whole field."""
    m = np.full((9, 14), fill)
    _check(m)
    big = tcomp.biggest_component_mask(torch.from_numpy(m))
    assert bool(big.all())


def test_tie_for_the_biggest_takes_the_first():
    """Two components of 16 pixels each: the one with the smaller label (the
    first in row-major order) wins, as ``jnp.argmax`` picks."""
    m = np.zeros((20, 20), bool)
    m[12:16, 2:6] = True
    m[2:6, 12:16] = True
    m[18, 18] = True
    _check(m)
    big = tcomp.biggest_component_mask(torch.from_numpy(m)).numpy()
    assert big[3, 13] and not big[13, 3] and not big[18, 18]
