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
    TVDenoise8Params,
    tv_denoise4,
    tv_denoise4_fused,
    tv_denoise8,
    tv_denoise8_fused,
)
from pde_tpu_torch.models.flow_ad import FlowADParams, flow_ad, flow_ad_fused
from pde_tpu_torch.models.flow_fmg import FlowFMGParams, flow_fmg, flow_fmg_fused
from pde_tpu_torch.models.flow_hs import FlowHSParams, flow_hs
from pde_tpu_torch.models.diffusion import Diffusion4Params, diffusion4
from pde_tpu_torch.models.gac import GACParams, gac_a, gac_a_fused, gac_b, gac_b_fused
from pde_tpu_torch.models.segmentation import (
    DispSegParams,
    disp_segmentation,
    disp_segmentation_sparse,
)
