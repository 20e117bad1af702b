from pde_tpu_torch.ops.derivatives import fst_derivatives5, snd_derivatives5, rgb2grad
from pde_tpu_torch.ops.warp import identity_grid, bilinear_warp, warp_by_flow, warp_window, warp_x_window
from pde_tpu_torch.ops.weights import diffusion_weights_4
