from pde_tpu_torch.models.flow_nd import (
    FlowNDParams,
    flow_nd,
    flow_nd_fused,
    flow_nd_sequence,
    params_from_reference,
)
from pde_tpu_torch.models.disparity import (
    DisparityParams,
    disparity_nd,
    disparity_nd_fused,
)
from pde_tpu_torch.models.disparity_sym import (
    DisparitySymParams,
    disparity_sym,
    disparity_sym_fused,
)
from pde_tpu_torch.models.tv_denoise import (
    TVDenoise4Params,
    tv_denoise4,
    tv_denoise4_fused,
)
from pde_tpu_torch.models.flow_hs import FlowHSParams, flow_hs
from pde_tpu_torch.models.diffusion import Diffusion4Params, diffusion4
