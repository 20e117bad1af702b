from pde_tpu_torch.models.flow_nd import (
    FlowNDParams,
    flow_nd,
    flow_nd_fused,
    flow_nd_sequence,
    params_from_reference,
)
