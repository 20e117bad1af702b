from pde_tpu_torch.utils.io import load_image, load_image_pair, load_yosemite
from pde_tpu_torch.utils.viz import flow2color
