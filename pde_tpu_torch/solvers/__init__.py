from pde_tpu_torch.solvers.sor import sor_flow_llin4
