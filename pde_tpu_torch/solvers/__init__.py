from pde_tpu_torch.solvers.sor import (
    sor_disp_llin4,
    sor_disp_llin_sym4,
    sor_flow_elin4,
    sor_flow_llin4,
    sor_pde4,
)
