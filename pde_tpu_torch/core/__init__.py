from pde_tpu_torch.core.grid import (
    replicate_border,
    interior_mask,
    checkerboard,
    shift_w,
    shift_e,
    shift_n,
    shift_s,
)
from pde_tpu_torch.core.conv import (
    imfilter_replicate,
    separable_filter,
    gaussian_kernel_1d,
    gaussian_kernel_2d,
    binomial5,
)
from pde_tpu_torch.core.resize import imresize, imresize_nan, imresize_scale, resize_matrix
from pde_tpu_torch.core.pyramid import pyramid_scales, build_pyramid
from pde_tpu_torch.core.median import medfilt2_3x3, nanmedfilt2
