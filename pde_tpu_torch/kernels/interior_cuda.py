"""ctypes wrapper of the interior-update red-black SOR kernels
(``csrc/interior_sor.cu``): disp llin4, pde4 and pde8.

Takes CUDA tensors only and raises on anything else: the choice of the
plain version for CPU tensors is ``kernels/dispatch.py``'s. The library
is built and loaded at the first call, never at import.

``LAUNCHES`` counts the kernel launches this wrapper has made, per system
(``"disp_llin4"``, ``"pde4"``, ``"pde8"``): ``3 * iters`` per call (colour 0,
colour 1 and the border fill of each sweep), so a run can show that it
went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from pde_tpu_torch.kernels import build

SOURCE = "interior_sor"
LAUNCHES = {"disp_llin4": 0, "pde4": 0, "pde8": 0}

_DISP_NAMES = ("u", "du", "cu", "duc", "ww", "wn", "we", "ws")
_PDE4_COEF_NAMES = ("trace", "b", "ww", "wn", "we", "ws")
_PDE8_COEF_NAMES = ("trace", "b", "ww", "wnw", "wn", "wne", "we", "wse", "ws", "wsw")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    p, i, f, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int64
    lib.interior_disp_llin4.argtypes = [p] * 9 + [i, i, i, i, f, f, p]
    lib.interior_disp_llin4.restype = i
    lib.interior_pde4.argtypes = [p] * 8 + [q, q, q, i, i, i, i, f, f, p]
    lib.interior_pde4.restype = i
    lib.interior_pde8.argtypes = [p] * 13 + [q, q, q, i, i, i, i, f, f, p]
    lib.interior_pde8.restype = i
    lib.interior_sor_error_string.argtypes = [i]
    lib.interior_sor_error_string.restype = ctypes.c_char_p
    return lib


def _check(fn: str, name: str, x: torch.Tensor, device, shape) -> None:
    if x.device != device or x.dtype != torch.float32 or tuple(x.shape) != tuple(shape) \
            or not x.is_contiguous():
        raise ValueError(
            f"{fn}: {name} must be a contiguous float32 {tuple(shape)} tensor on {device}, "
            f"got {x.dtype} {tuple(x.shape)} on {x.device} (contiguous={x.is_contiguous()})")


def _unknown_geometry(fn: str, x: torch.Tensor) -> tuple[int, int, int]:
    """(batch, H, W) of the relaxed field, which must lie on the card and
    have H, W >= 2 (the plain version's border fill empties an H or W of 1)."""
    if x.ndim < 2 or x.shape[-2] < 2 or x.shape[-1] < 2:
        raise ValueError(f"{fn} takes (..., H, W) fields with H, W >= 2, got {tuple(x.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"{fn} takes CUDA tensors, got {x.device}")
    h, w = x.shape[-2:]
    return math.prod(x.shape[:-2]), h, w


def _raise_on(lib, fn: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {err} "
                           f"({lib.interior_sor_error_string(err).decode()})")


def disp_llin4_sor(u, du, cu, duc, ww, wn, we, ws, iters: int, omega: float):
    """``iters`` red-black disparity llin4 sweeps on the card; the same
    function as ``solvers/sor.py::sor_disp_llin4``. All fields share one
    shape, (H, W) or (B, H, W) for a batch of independent systems.
    Returns new dU."""
    fields = (u, du, cu, duc, ww, wn, we, ws)
    batch, h, w = _unknown_geometry("disp_llin4_sor", u)
    for name, x in zip(_DISP_NAMES, fields):
        _check("disp_llin4_sor", name, x, u.device, u.shape)
    iters = max(int(iters), 0)  # as the plain loop: no sweep for iters <= 0
    lib = _lib()
    out = torch.empty_like(du)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.interior_disp_llin4(*(x.data_ptr() for x in fields), out.data_ptr(),
                                      batch, h, w, iters, float(omega), 1.0 - float(omega),
                                      stream)
    _raise_on(lib, "disp_llin4_sor", err)
    LAUNCHES["disp_llin4"] += 3 * iters
    return out


def _coef_strides(fn: str, x, names, coefs) -> list[int]:
    """Batch strides of TRACE, B and the weights of the diagonal form: 0
    for a shared (H, W) plane, H*W for one with the shape of x. The
    weights must be all shared or all not."""
    h, w = x.shape[-2:]
    strides = []
    for name, c in zip(names, coefs):
        shared = c.ndim == 2 and x.ndim > 2
        _check(fn, name, c, x.device, (h, w) if shared else x.shape)
        strides.append(0 if shared else h * w)
    if len(set(strides[2:])) != 1:
        raise ValueError(f"{fn}: the weights must all be shared (H, W) planes "
                         "or all have the shape of x")
    return strides


def pde4_sor(x, trace, b, ww, wn, we, ws, iters: int, omega: float):
    """``iters`` red-black diagonal-form 4-neighbour sweeps on the card; the
    same function as ``solvers/sor.py::sor_pde4``. ``x`` is (..., H, W);
    TRACE and B each have its shape or are one (H, W) plane shared by the
    batch, and so are the four weights, together. Returns new X."""
    batch, h, w = _unknown_geometry("pde4_sor", x)
    _check("pde4_sor", "x", x, x.device, x.shape)
    strides = _coef_strides("pde4_sor", x, _PDE4_COEF_NAMES, (trace, b, ww, wn, we, ws))
    iters = max(int(iters), 0)
    lib = _lib()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.interior_pde4(x.data_ptr(), trace.data_ptr(), b.data_ptr(), ww.data_ptr(),
                                wn.data_ptr(), we.data_ptr(), ws.data_ptr(), out.data_ptr(),
                                strides[0], strides[1], strides[2], batch, h, w, iters,
                                float(omega), 1.0 - float(omega), stream)
    _raise_on(lib, "pde4_sor", err)
    LAUNCHES["pde4"] += 3 * iters
    return out


def pde8_sor(x, trace, b, ww, wnw, wn, wne, we, wse, ws, wsw, iters: int, omega: float):
    """``iters`` red-black diagonal-form 8-neighbour sweeps on the card; the
    same function as ``solvers/sor.py::sor_pde8``, with the shapes of
    ``pde4_sor`` and the eight weights W, NW, N, NE, E, SE, S, SW. Returns
    new X."""
    batch, h, w = _unknown_geometry("pde8_sor", x)
    _check("pde8_sor", "x", x, x.device, x.shape)
    coefs = (trace, b, ww, wnw, wn, wne, we, wse, ws, wsw)
    strides = _coef_strides("pde8_sor", x, _PDE8_COEF_NAMES, coefs)
    iters = max(int(iters), 0)
    lib = _lib()
    out = torch.empty_like(x)
    tmp = torch.empty_like(x)  # the buffer the colour launches alternate with
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.interior_pde8(x.data_ptr(), *(c.data_ptr() for c in coefs), out.data_ptr(),
                                tmp.data_ptr(), strides[0], strides[1], strides[2], batch, h,
                                w, iters, float(omega), 1.0 - float(omega), stream)
    _raise_on(lib, "pde8_sor", err)
    LAUNCHES["pde8"] += 3 * iters
    return out
