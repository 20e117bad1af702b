"""Image and fixture loading helpers on the host, ported from
``pde_tpu/utils/io.py``.

Images load as float32 channel-leading (C, H, W) numpy arrays in [0, 255]
(drivers divide by 255 themselves where the reference does,
e.g. FlowEminND_llin_2D_v10.m:75); an entry point moves them to its
device. PIL is imported only by :func:`load_image`, and scipy only by
:func:`load_yosemite`.
"""

from __future__ import annotations

import os

import numpy as np

# where pde_tpu's helpers look for the reference's bundled images (the same
# path as pde_tpu.utils.io.REFERENCE_IMAGES)
REFERENCE_IMAGES = os.path.join(os.sep, "root", "reference", "images")


def load_image(path: str, gray: bool = False) -> np.ndarray:
    """Load an image as float32 (C, H, W) in [0, 255]."""
    from PIL import Image

    img = Image.open(path)
    if gray:
        img = img.convert("L")
    arr = np.asarray(img, dtype=np.float32)
    if arr.ndim == 2:
        arr = arr[None]
    else:
        arr = arr.transpose(2, 0, 1)
    return arr


def load_image_pair(name: str) -> tuple[np.ndarray, np.ndarray]:
    """Bundled Middlebury pairs by short name: 'urban3', 'beanbags', 'tsukuba'."""
    m = os.path.join(REFERENCE_IMAGES, "middlebury")
    pairs = {
        "urban3": ("Urban3_frame07.png", "Urban3_frame08.png"),
        "beanbags": ("beanbags_frame10.png", "beanbags_frame11.png"),
        "tsukuba": ("tsukuba_left.png", "tsukuba_right.png"),
    }
    a, b = pairs[name]
    return load_image(os.path.join(m, a)), load_image(os.path.join(m, b))


def load_yosemite() -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Yosemite frames + ground-truth flow from the bundled .mat
    (runme.m:87: struct Y with fields I (H,W,2) and GT)."""
    import scipy.io as sio

    mat = sio.loadmat(os.path.join(REFERENCE_IMAGES, "middlebury", "yosemite.mat"))
    imgs = np.asarray(mat["I"], dtype=np.float32)  # (H, W, 2) uint8 frames
    it0, it1 = imgs[..., 0], imgs[..., 1]
    gtu = np.asarray(mat["Utrue"], dtype=np.float32)
    gtv = np.asarray(mat["Vtrue"], dtype=np.float32)
    return it0, it1, gtu, gtv
