from pde_tpu_torch.solvers.sor import (
    sor_pde4,
    sor_pde8,
    sor_flow_elin4,
    sor_flow_llin4,
    sor_flow_llin8,
    sor_disp_llin4,
    sor_disp_llin_sym4,
    residuals_elin4,
    residuals_llin4,
    residuals_disp_llin4,
    lhs_elin4,
    lhs_llin4,
)
from pde_tpu_torch.solvers.tdma import thomas_solve, alr_pde4, alr_flow_llin4, alr_flow_elin4
from pde_tpu_torch.solvers.krylov import (
    pcg_flow_elin4,
    pcg_flow_llin4,
    pcg_flow_llin8,
    pcg_disp_llin4,
    pcg_pde4,
    pcg_pde8,
)
from pde_tpu_torch.solvers.aos import cv_aos_step, ac_aos_step
from pde_tpu_torch.solvers.reinit import reinit, reinit_t
