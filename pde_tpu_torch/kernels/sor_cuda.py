"""ctypes wrapper of the coupled-flow red-black SOR kernels
(``csrc/flow_llin4_sor.cu``): llin4 and elin4.

Takes CUDA tensors only and raises on anything else: the choice of the
plain version for CPU tensors is ``kernels/dispatch.py``'s. The library
is built and loaded at the first call, never at import.

``LAUNCHES`` counts the kernel launches this wrapper has made, per system
(``"flow_llin4"``, ``"flow_elin4"``): ``1 + 2 * iters`` per call, so a run
can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pde_tpu_torch.kernels import build

SOURCE = "flow_llin4_sor"
LAUNCHES = {"flow_llin4": 0, "flow_elin4": 0}

_LLIN_NAMES = ("u", "v", "du", "dv", "m", "cu", "cv", "duc", "dvc", "ww", "wn", "we", "ws")
_ELIN_NAMES = ("u", "v", "m", "cu", "cv", "duc", "dvc", "ww", "wn", "we", "ws")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flow_llin4_sor.argtypes = [p] * 17 + [i, i, i, f, f, p]
    lib.flow_llin4_sor.restype = i
    lib.flow_elin4_sor.argtypes = [p] * 15 + [i, i, i, f, f, p]
    lib.flow_elin4_sor.restype = i
    lib.flow_llin4_sor_scratch_planes.argtypes = []
    lib.flow_llin4_sor_scratch_planes.restype = i
    lib.flow_llin4_sor_error_string.argtypes = [i]
    lib.flow_llin4_sor_error_string.restype = ctypes.c_char_p
    return lib


def _check(fn: str, names, fields) -> tuple[int, int]:
    shape = fields[0].shape
    device = fields[0].device
    if device.type != "cuda":
        raise ValueError(f"{fn} takes CUDA tensors, got {device}")
    if len(shape) != 2 or shape[0] < 1 or shape[1] < 1:
        raise ValueError(f"{fn} takes non-empty (H, W) fields, got {tuple(shape)}")
    for name, x in zip(names, fields):
        if x.device != device or x.dtype != torch.float32 or x.shape != shape \
                or not x.is_contiguous():
            raise ValueError(
                f"{fn}: {name} must be a contiguous float32 {tuple(shape)} "
                f"tensor on {device}, got {x.dtype} {tuple(x.shape)} on {x.device} "
                f"(contiguous={x.is_contiguous()})")
    return shape[0], shape[1]


def _run(fn: str, names, fields, relaxed, iters: int, omega: float):
    """One call of the C entry point ``fn``: relaxes copies of the two
    ``relaxed`` fields; returns them."""
    h, w = _check(fn, names, fields)
    iters = max(int(iters), 0)  # as the plain loop: no sweep for iters <= 0
    lib = _lib()
    out_u, out_v = (torch.empty_like(x) for x in relaxed)
    device = fields[0].device
    scratch = torch.empty((lib.flow_llin4_sor_scratch_planes(), h, w),
                          dtype=torch.float32, device=device)
    flags = torch.empty((h, w), dtype=torch.uint8, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*(x.data_ptr() for x in fields),
                               out_u.data_ptr(), out_v.data_ptr(),
                               scratch.data_ptr(), flags.data_ptr(),
                               h, w, iters, float(omega), 1.0 - float(omega), stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {err} "
                           f"({lib.flow_llin4_sor_error_string(err).decode()})")
    return out_u, out_v, 1 + 2 * iters


def flow_llin4_sor(u, v, du, dv, m, cu, cv, duc, dvc, ww, wn, we, ws,
                   iters: int, omega: float):
    """``iters`` red-black llin4 SOR sweeps on the card; the same function
    as ``solvers/sor.py::sor_flow_llin4``. Returns new (dU, dV)."""
    fields = (u, v, du, dv, m, cu, cv, duc, dvc, ww, wn, we, ws)
    out_du, out_dv, launches = _run("flow_llin4_sor", _LLIN_NAMES, fields, (du, dv),
                                    iters, omega)
    LAUNCHES["flow_llin4"] += launches
    return out_du, out_dv


def flow_elin4_sor(u, v, m, cu, cv, duc, dvc, ww, wn, we, ws, iters: int, omega: float):
    """``iters`` red-black elin4 SOR sweeps on the card; the same function
    as ``solvers/sor.py::sor_flow_elin4``. Returns new (U, V)."""
    fields = (u, v, m, cu, cv, duc, dvc, ww, wn, we, ws)
    out_u, out_v, launches = _run("flow_elin4_sor", _ELIN_NAMES, fields, (u, v), iters, omega)
    LAUNCHES["flow_elin4"] += launches
    return out_u, out_v
