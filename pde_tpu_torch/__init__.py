"""pde_tpu_torch — the variational PDE vision engine in PyTorch and CUDA.

The second implementation of the engine, beside the JAX package
``pde_tpu``, which stays the reference it is tested against. Layout
mirrors ``pde_tpu`` file for file (``pde_tpu_torch/core/resize.py``
pairs with ``pde_tpu/core/resize.py``). Public functions keep the JAX
signatures and layouts: ``(C, H, W)`` images, ``(H, W)`` float32 fields,
the device taken from the input.

Ported so far, with everything they call: the warping optical flow
``models.flow_nd`` (its llin4 red-black SOR sweep a hand-written CUDA
kernel, ``csrc/flow_llin4_sor.cu``), the stereo models
``models.disparity`` and ``models.disparity_sym`` and the TV denoiser
``models.tv_denoise.tv_denoise4`` (their interior-update sweeps a second
CUDA source, ``csrc/interior_sor.cu``), Horn & Schunck flow
``models.flow_hs`` (its elin4 sweep a variant of the first source), the
anisotropic flow ``models.flow_ad`` and TV denoiser
``models.tv_denoise.tv_denoise8`` (their 8-neighbour sweeps in the first
and second source) and the semi-implicit diffusion ``models.diffusion``. Every model's ``solver=2``,
the line-implicit PCG (``solvers/krylov.py``), and diffusion solve their
tridiagonal lines with a third, ``csrc/tridiag.cu``, which also serves the
FAS full-multigrid flow ``models.flow_fmg`` (its default ``solver=2``; with
``solver=1`` the resident elin4 kernel smooths) and the geodesic active
contours ``models.gac`` (``gac_a``, ``gac_b``: two line-set solves an AOS
step, ``solvers/aos.py``, with the reinitialisation of
``solvers/reinit.py``), and the disparity segmentation
``models.segmentation`` (``disp_segmentation``,
``disp_segmentation_sparse``: Chan-Vese AOS steps on the same kernel, RANSAC
surfaces from ``ops/ransac.py``, connected components from
``ops/components.py``; the NaN-median and ``imresize_nan`` prefilters), so
all ten of ``pde_tpu``'s pipelines. ``utils`` holds the checkpoint format
shared with ``pde_tpu``, ``flow2color``, the ``probe`` hooks and the image
loader. The temporally blocked
tile engine ``kernels.tiled.tiled_relax`` runs the sweeps of all six SOR
families (llin4, elin4, disp llin4, pde4, llin8, pde8) k at a time over
tiles, a fourth source, ``csrc/tiled_sor.cu``; it takes every solve whose
shape has no resident plan and that it plans
(``kernels/dispatch.sor_route``). ``parallel`` shards the image plane over a ("ty",
"tx") mesh of devices, as ``pde_tpu.parallel`` does: halo exchange between
tiles, the sharded solvers (each tile's chunk of k sweeps a windowed
variant of that kernel) and ``mesh=``/``shard_min=`` in
``flow_nd`` and ``flow_fmg``. Entry points run on the CUDA card
unless the caller passes CPU tensors or ``device="cpu"``. Importing the
package builds and loads nothing; a kernel is compiled with ``nvcc`` at
its first launch on a CUDA tensor (``kernels/build.py``).
"""

__version__ = "0.1.0"

from pde_tpu_torch import core, ops, solvers, kernels, models, parallel, utils  # noqa: F401
from pde_tpu_torch.models import (  # noqa: F401
    Diffusion4Params,
    DispSegParams,
    DisparityParams,
    DisparitySymParams,
    FlowADParams,
    FlowFMGParams,
    FlowHSParams,
    FlowNDParams,
    GACParams,
    TVDenoise4Params,
    TVDenoise8Params,
    diffusion4,
    disp_segmentation,
    disp_segmentation_sparse,
    disparity_nd,
    disparity_nd_fused,
    disparity_sym,
    disparity_sym_fused,
    flow_ad,
    flow_ad_fused,
    flow_fmg,
    flow_fmg_fused,
    flow_hs,
    flow_nd,
    flow_nd_fused,
    flow_nd_sequence,
    gac_a,
    gac_a_fused,
    gac_b,
    gac_b_fused,
    tv_denoise4,
    tv_denoise4_fused,
    tv_denoise8,
    tv_denoise8_fused,
)
from pde_tpu_torch.solvers import (  # noqa: F401
    ac_aos_step,
    cv_aos_step,
    lhs_elin4,
    lhs_llin4,
    reinit,
    reinit_t,
    residuals_disp_llin4,
    residuals_elin4,
    residuals_llin4,
)
