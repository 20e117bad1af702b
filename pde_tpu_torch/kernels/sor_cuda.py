"""ctypes wrapper of the llin4 red-black SOR kernel (``csrc/flow_llin4_sor.cu``).

Takes CUDA tensors only and raises on anything else: the choice of the
plain version for CPU tensors is ``kernels/dispatch.py``'s. The library
is built and loaded at the first call, never at import.

``LAUNCHES`` counts the kernel launches this wrapper has made
(``1 + 2 * iters`` per call), so a run can show that it went through the
kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pde_tpu_torch.kernels import build

SOURCE = "flow_llin4_sor"
LAUNCHES = 0

_FIELD_NAMES = ("u", "v", "du", "dv", "m", "cu", "cv", "duc", "dvc", "ww", "wn", "we", "ws")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flow_llin4_sor.argtypes = [p] * 17 + [i, i, i, f, f, p]
    lib.flow_llin4_sor.restype = i
    lib.flow_llin4_sor_scratch_planes.argtypes = []
    lib.flow_llin4_sor_scratch_planes.restype = i
    lib.flow_llin4_sor_error_string.argtypes = [i]
    lib.flow_llin4_sor_error_string.restype = ctypes.c_char_p
    return lib


def _check(fields) -> tuple[int, int]:
    shape = fields[0].shape
    device = fields[0].device
    if device.type != "cuda":
        raise ValueError(f"flow_llin4_sor takes CUDA tensors, got {device}")
    if len(shape) != 2 or shape[0] < 1 or shape[1] < 1:
        raise ValueError(f"flow_llin4_sor takes non-empty (H, W) fields, got {tuple(shape)}")
    for name, x in zip(_FIELD_NAMES, fields):
        if x.device != device or x.dtype != torch.float32 or x.shape != shape \
                or not x.is_contiguous():
            raise ValueError(
                f"flow_llin4_sor: {name} must be a contiguous float32 {tuple(shape)} "
                f"tensor on {device}, got {x.dtype} {tuple(x.shape)} on {x.device} "
                f"(contiguous={x.is_contiguous()})")
    return shape[0], shape[1]


def flow_llin4_sor(u, v, du, dv, m, cu, cv, duc, dvc, ww, wn, we, ws,
                   iters: int, omega: float):
    """``iters`` red-black llin4 SOR sweeps on the card; the same function
    as ``solvers/sor.py::sor_flow_llin4``. Returns new (dU, dV)."""
    global LAUNCHES
    fields = (u, v, du, dv, m, cu, cv, duc, dvc, ww, wn, we, ws)
    h, w = _check(fields)
    iters = max(int(iters), 0)  # as the plain loop: no sweep for iters <= 0
    lib = _lib()
    out_du = torch.empty_like(du)
    out_dv = torch.empty_like(dv)
    scratch = torch.empty((lib.flow_llin4_sor_scratch_planes(), h, w),
                          dtype=torch.float32, device=u.device)
    flags = torch.empty((h, w), dtype=torch.uint8, device=u.device)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.flow_llin4_sor(*(x.data_ptr() for x in fields),
                                 out_du.data_ptr(), out_dv.data_ptr(),
                                 scratch.data_ptr(), flags.data_ptr(),
                                 h, w, iters, float(omega), 1.0 - float(omega), stream)
    if err != 0:
        raise RuntimeError(f"flow_llin4_sor launch failed: cudaError {err} "
                           f"({lib.flow_llin4_sor_error_string(err).decode()})")
    LAUNCHES += 1 + 2 * iters
    return out_du, out_dv
