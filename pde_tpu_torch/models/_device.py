"""Where an entry point runs: the device rule shared by every model.

A tensor input keeps its own device, so a CPU tensor is the caller asking
for the CPU. A numpy input (or any array-like) goes to ``device`` when the
caller names one, and otherwise to the CUDA card; where there is no card
that raises instead of carrying on quietly on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def input_device(x, device=None) -> torch.device:
    """The device an entry point given ``x`` (its first image) runs on."""
    if torch.is_tensor(x):
        return x.device
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a numpy input runs on the CUDA card unless device= names another, and "
            "torch sees no CUDA device here: pass device='cpu' (or CPU tensors) "
            "to run on the CPU")
    return torch.device("cuda")


def as_tensor(x, device) -> torch.Tensor:
    """``x`` as a float32 tensor on ``device``."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)
