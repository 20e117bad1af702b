"""ctypes wrapper of the tridiagonal line-solve kernels (``csrc/tridiag.cu``).

Takes CUDA tensors only and raises on anything else: the choice of the
plain version for CPU tensors is ``kernels/dispatch.py``'s. The library
is built and loaded at the first call, never at import.

Fields are ``(..., H, W)``; lines run along axis -2 (columns) or -1 (rows),
independently over every other axis. A coefficient may be one ``(H, W)``
plane shared by the leading dimensions (read with batch stride 0), as
``pcg_pde4``'s weights are against its ``(C, H, W)`` diagonal.

``LAUNCHES`` counts the launches per entry point (``"thomas"``,
``"factor"``, ``"solve"``; one per call that has a line to solve), so a
run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from pde_tpu_torch.kernels import build

SOURCE = "tridiag"
LAUNCHES = {"thomas": 0, "factor": 0, "solve": 0}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.tridiag_thomas.argtypes = [p] * 6 + [q, q, q, i, i, i, i, p]
    lib.tridiag_thomas.restype = i
    lib.tridiag_factor.argtypes = [p] * 5 + [q, q, q, i, i, i, i, p]
    lib.tridiag_factor.restype = i
    lib.tridiag_solve.argtypes = [p] * 5 + [q, q, i, i, i, i, i, p]
    lib.tridiag_solve.restype = i
    lib.tridiag_error_string.argtypes = [i]
    lib.tridiag_error_string.restype = ctypes.c_char_p
    return lib


@dataclasses.dataclass(frozen=True)
class LineFactor:
    """The kernel's factor of every line of a field: ``cp`` and ``denom``
    of shape ``shape`` (the coefficients' broadcast shape), and the
    sub-diagonal ``a`` the RHS pass reads again."""

    a: torch.Tensor
    cp: torch.Tensor
    denom: torch.Tensor
    shape: tuple
    vertical: bool


def _vertical(axis: int, ndim: int) -> bool:
    if axis in (-2, ndim - 2):
        return True
    if axis in (-1, ndim - 1):
        return False
    raise ValueError(f"the tridiagonal kernel solves along axis -2 or -1, got axis={axis}")


def _full_shape(fn: str, tensors) -> tuple:
    """The broadcast shape of (H, W) planes and full (..., H, W) fields;
    checks device, dtype and contiguity."""
    full = max((tuple(t.shape) for t in tensors), key=len)
    if len(full) < 2 or min(full) < 1:
        raise ValueError(f"{fn} takes non-empty (..., H, W) fields, got {full}")
    device = tensors[0].device
    if device.type != "cuda":
        raise ValueError(f"{fn} takes CUDA tensors, got {device}")
    for t in tensors:
        if tuple(t.shape) not in (full, full[-2:]) or t.device != device \
                or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"{fn}: every field must be a contiguous float32 tensor on {device} of "
                f"shape {full} or {full[-2:]}, got {t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    return full


def _batch_stride(t: torch.Tensor, full: tuple) -> int:
    return 0 if t.ndim == 2 and len(full) > 2 else full[-2] * full[-1]


def _raise_on(lib, fn: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {err} "
                           f"({lib.tridiag_error_string(err).decode()})")


def thomas_solve(a, b, c, d, axis: int = -2):
    """Solve the tridiagonal systems along ``axis`` in one launch; the same
    function as ``solvers/tdma.py::thomas_solve``. Returns x of d's shape."""
    full = _full_shape("thomas_solve", (a, b, c, d))
    if tuple(d.shape) != full:
        raise ValueError(f"thomas_solve: d must have the full shape {full}, got {tuple(d.shape)}")
    vertical = _vertical(axis, len(full))
    lib = _lib()
    h, w = full[-2:]
    x = torch.empty(full, dtype=torch.float32, device=d.device)
    cp = torch.empty_like(x)
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = lib.tridiag_thomas(a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(),
                                 cp.data_ptr(), x.data_ptr(), _batch_stride(a, full),
                                 _batch_stride(b, full), _batch_stride(c, full),
                                 math.prod(full[:-2]), h, w, int(vertical), stream)
    _raise_on(lib, "tridiag_thomas", err)
    LAUNCHES["thomas"] += 1
    return x


def tridiag_factor(a, b, c, axis: int = -2) -> LineFactor:
    """The elimination of every line along ``axis``, once; the same
    arithmetic as ``solvers/tdma.py::tridiag_factor`` (a[0] and c[-1]
    ignored)."""
    full = _full_shape("tridiag_factor", (a, b, c))
    vertical = _vertical(axis, len(full))
    lib = _lib()
    h, w = full[-2:]
    cp = torch.empty(full, dtype=torch.float32, device=b.device)
    denom = torch.empty_like(cp)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        err = lib.tridiag_factor(a.data_ptr(), b.data_ptr(), c.data_ptr(), cp.data_ptr(),
                                 denom.data_ptr(), _batch_stride(a, full),
                                 _batch_stride(b, full), _batch_stride(c, full),
                                 math.prod(full[:-2]), h, w, int(vertical), stream)
    _raise_on(lib, "tridiag_factor", err)
    LAUNCHES["factor"] += 1
    return LineFactor(a, cp, denom, full, vertical)


def tridiag_solve(fac: LineFactor, d, parity: int | None = None):
    """The RHS pass of ``fac`` for a new ``d`` of the factor's (H, W),
    leading dimensions either the factor's or, for a factor of one plane,
    any. ``parity`` None solves every line and returns d's shape; 0 or 1
    solves only the lines ``parity::2`` (columns of a vertical factor, rows
    of a horizontal one) and returns them compactly, as
    ``solvers/tdma.py::line_solve`` does."""
    if not isinstance(fac, LineFactor):
        raise ValueError(f"tridiag_solve takes a factor of the kernel, got {type(fac).__name__}")
    full = _full_shape("tridiag_solve", (d,))
    if full[-2:] != fac.shape[-2:] or (len(fac.shape) > 2 and full != fac.shape):
        raise ValueError(f"tridiag_solve: d of shape {full} does not fit a factor of "
                         f"shape {fac.shape}")
    if d.device != fac.cp.device:
        raise ValueError(f"tridiag_solve: d on {d.device}, factor on {fac.cp.device}")
    h, w = full[-2:]
    if parity is None:
        out_shape, par = full, -1
    elif parity in (0, 1):
        n_sel = len(range(parity, w if fac.vertical else h, 2))
        out_shape = full[:-1] + (n_sel,) if fac.vertical else full[:-2] + (n_sel, w)
        par = parity
    else:
        raise ValueError(f"tridiag_solve: parity must be None, 0 or 1, got {parity}")
    x = torch.empty(out_shape, dtype=torch.float32, device=d.device)
    if x.numel() == 0:
        return x
    lib = _lib()
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = lib.tridiag_solve(fac.a.data_ptr(), fac.cp.data_ptr(), fac.denom.data_ptr(),
                                d.data_ptr(), x.data_ptr(), _batch_stride(fac.a, full),
                                _batch_stride(fac.cp, full), math.prod(full[:-2]), h, w,
                                int(fac.vertical), par, stream)
    _raise_on(lib, "tridiag_solve", err)
    LAUNCHES["solve"] += 1
    return x
