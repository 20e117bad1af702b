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
tridiagonal lines with a third, ``csrc/tridiag.cu``. Entry points run on the CUDA card
unless the caller passes CPU tensors or ``device="cpu"``. Importing the
package builds and loads nothing; a kernel is compiled with ``nvcc`` at
its first launch on a CUDA tensor (``kernels/build.py``).
"""

__version__ = "0.1.0"

from pde_tpu_torch import core, ops, solvers, kernels, models  # noqa: F401
