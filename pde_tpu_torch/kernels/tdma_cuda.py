"""ctypes wrapper of the tridiagonal line-solve kernels (``csrc/tridiag.cu``).

Takes CUDA tensors only and raises on anything else: the choice of the
plain version for CPU tensors is ``kernels/dispatch.py``'s. The library
is built and loaded at the first call, never at import.

Fields are ``(..., H, W)``; lines run along axis -2 (columns) or -1 (rows),
independently over every other axis. A coefficient may be one ``(H, W)``
plane shared by the leading dimensions (read with batch stride 0), as
``pcg_pde4``'s weights are against its ``(C, H, W)`` diagonal.

Every launch takes a plan from :func:`plan_lines`: G lines a block, R
elements of each line a staged chunk, S stages in the ring of chunks, and
the variant. Lines whose forward results do not fit in a block's shared
memory even at G = 1 (longer than ~28,000 elements) take the global-rows
variant, chosen from the shape before any launch: the same arithmetic with
those results in a scratch of device memory (:func:`row_scratch`). Any
batch is taken (the kernel folds it into the grid's x).

``LAUNCHES`` counts the launches per entry point (``"thomas"``,
``"factor"``, ``"solve"``, ``"zebra_pass"``; one per call that has a line
to solve), the global-rows variant's apart (``"thomas_long"``, ...), so a
run can show that it went through the kernel and which variant ran.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from pde_tpu_torch.kernels import build

SOURCE = "tridiag"
ENTRIES = ("thomas", "factor", "solve", "zebra_pass")
LAUNCHES = {**{k: 0 for k in ENTRIES}, **{f"{k}_long": 0 for k in ENTRIES}}

# the kernel's modes (tridiag.cu's Mode)
MODES = ("thomas", "factor", "solve", "zebra")
MAX_SMEM = 232448   # bytes of shared memory a block may use on the H100
MAX_BLOCKS = 2**31 - 1  # a launch's grid x, which holds batch x groups
# the plan measured fastest by scripts/tridiag_plan_sweep.py at 481x641 and
# 1024x1024, both axes, on an H100 (PERF.md, row 8): G lines a block per
# mode, R elements a chunk, S stages
GROUP = {"thomas": 4, "factor": 4, "solve": 2, "zebra": 2}
CHUNK = 64
STAGES = 2


@dataclasses.dataclass(frozen=True)
class LinePlan:
    """G lines a block, R elements a chunk, S stages; the shared memory a
    block takes and the blocks of the launch; ``global_rows``: the variant
    whose forward results lie in device memory."""

    g: int
    r: int
    stages: int
    smem_bytes: int
    blocks: int
    global_rows: bool = False


def n_tiles(mode: str, coupled: bool = False, diag: bool = False,
            global_rows: bool = False) -> int:
    """Fields staged a chunk: thomas a, b, c, d; factor a, b, c; solve a,
    denom, d; zebra a, denom, rhs, w_lo, w_hi, (m, z_o), (4 diagonal
    weights); the global-rows variant stages cp too (solve, zebra)."""
    base = {"thomas": 4, "factor": 3, "solve": 3}.get(mode, 5 + 2 * coupled + 4 * diag)
    return base + (global_rows and mode in ("solve", "zebra"))


def row_pitch(length: int) -> int:
    """Floats a row of a line's forward results takes: L rounded up to 4
    mod 8 (16-byte accesses; in shared memory, no bank conflicts)."""
    return length + (4 - length) % 8


def smem_bytes(mode: str, length: int, g: int, r: int, stages: int, coupled: bool = False,
               diag: bool = False, global_rows: bool = False) -> int:
    """A block's shared memory, as ``tridiag.cu::smem_bytes_of`` counts it:
    the resident forward results (2 G rows of ``row_pitch(L)``; none in the
    global-rows variant) and S stages of tiles (G rows of R + 4 floats each)
    plus, for the zebra pass, the window of z (2 G + 1 rows of R + 4)."""
    stage = n_tiles(mode, coupled, diag, global_rows) * g * (r + 4)
    if mode == "zebra":
        stage += (2 * g + 1) * (r + 4)
    return 4 * ((0 if global_rows else 2 * g * row_pitch(length)) + stages * stage)


@functools.lru_cache(maxsize=None)
def plan_lines(batch: int, h: int, w: int, vertical: bool, parity: int | None, mode: str,
               coupled: bool = False, diag: bool = False, override=None) -> LinePlan:
    """The launch plan of ``mode`` over the lines ``parity::2`` (None: every
    line): the global-rows variant where one line's resident rows do not fit
    in a block's shared memory at G = 1, ``GROUP[mode]`` lines a block,
    halved while the block does not fit, R = ``CHUNK``, S = ``STAGES``.
    ``override`` = (g, r, stages) replaces the choice (the plan sweep's; the
    variant stays the shape's). Raises if the kernel does not take the
    plan."""
    if mode not in MODES:
        raise ValueError(f"plan_lines: mode must be one of {MODES}, got {mode!r}")
    length, n_all = (h, w) if vertical else (w, h)
    n_lines = n_all if parity is None else len(range(parity, n_all, 2))
    g, r, stages = override or (GROUP[mode], CHUNK, STAGES)
    global_rows = smem_bytes(mode, length, 1, r, stages, coupled, diag) > MAX_SMEM
    if override is None:
        while g > 1 and smem_bytes(mode, length, g, r, stages, coupled, diag,
                                   global_rows) > MAX_SMEM:
            g //= 2
    plan = LinePlan(g, r, stages,
                    smem_bytes(mode, length, g, r, stages, coupled, diag, global_rows),
                    batch * -(-n_lines // g), global_rows)
    if g not in (1, 2, 4, 8, 16, 32) or r not in (32, 64) or not 2 <= stages <= 4 \
            or plan.smem_bytes > MAX_SMEM or plan.blocks > MAX_BLOCKS:
        raise ValueError(f"plan_lines: the kernel does not take the plan {plan} for lines "
                         f"of {length} elements ({MAX_SMEM} bytes of shared memory a block, "
                         f"{MAX_BLOCKS} blocks a launch)")
    return plan


def row_scratch(plan: LinePlan, batch: int, n_lines: int, length: int, device):
    """The global-rows variant's scratch (2 rows of ``row_pitch(L)`` floats
    a line solved), from torch's allocator; None for the staged variant."""
    if not plan.global_rows:
        return None
    return torch.empty(batch * n_lines * 2 * row_pitch(length), dtype=torch.float32,
                       device=device)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.tridiag_thomas.argtypes = [p] * 5 + [q, q, q] + [i] * 7 + [p, p]
    lib.tridiag_thomas.restype = i
    lib.tridiag_factor.argtypes = [p] * 5 + [q, q, q] + [i] * 7 + [p, p]
    lib.tridiag_factor.restype = i
    lib.tridiag_solve.argtypes = [p] * 5 + [q, q] + [i] * 8 + [p, p]
    lib.tridiag_solve.restype = i
    lib.tridiag_zebra_pass.argtypes = [p] * 13 + [q] * 4 + [i] * 10 + [p, p]
    lib.tridiag_zebra_pass.restype = i
    lib.tridiag_smem_bytes.argtypes = [i] * 8
    lib.tridiag_smem_bytes.restype = q
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


def _full_shape(fn: str, tensors, cuda: bool = True) -> tuple:
    """The broadcast shape of (H, W) planes and full (..., H, W) fields;
    checks shape, dtype, contiguity and one device, then (``cuda``) that
    the device is a CUDA one. Kept lean: the PCG calls it a few thousand
    times a frame."""
    full = max((t.shape for t in tensors), key=len)
    if len(full) < 2 or min(full) < 1:
        raise ValueError(f"{fn} takes non-empty (..., H, W) fields, got {tuple(full)}")
    plane = full[-2:]
    device, index = tensors[0].device, tensors[0].get_device()
    for t in tensors:
        if (t.shape != full and t.shape != plane) or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.get_device() != index:
            raise ValueError(
                f"{fn}: every field must be a contiguous float32 tensor on {device} of "
                f"shape {tuple(full)} or {tuple(plane)}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device} (contiguous={t.is_contiguous()})")
    if cuda:
        _require_cuda(fn, device)
    return tuple(full)


def _require_cuda(fn: str, device) -> None:
    if device.type != "cuda":
        raise ValueError(f"{fn} takes CUDA tensors, got {device}")


def _batch_stride(t: torch.Tensor, full: tuple) -> int:
    return 0 if t.ndim == 2 and len(full) > 2 else full[-2] * full[-1]


def _raise_on(lib, fn: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {err} "
                           f"({lib.tridiag_error_string(err).decode()})")


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _count(entry: str, plan: LinePlan) -> None:
    LAUNCHES[entry + ("_long" if plan.global_rows else "")] += 1


def _launch(device, launch) -> int:
    """``launch(stream)`` with ``device`` current and its current stream's
    handle (switching the device only when another one is current)."""
    if device.index == torch.cuda.current_device():
        return launch(torch._C._cuda_getCurrentRawStream(device.index))
    with torch.cuda.device(device):
        return launch(torch._C._cuda_getCurrentRawStream(device.index))


def thomas_solve(a, b, c, d, axis: int = -2, plan=None):
    """Solve the tridiagonal systems along ``axis`` in one launch; the same
    function as ``solvers/tdma.py::thomas_solve``. Returns x of d's shape.
    ``plan``: a (g, r, stages) override of :func:`plan_lines`."""
    full = _full_shape("thomas_solve", (a, b, c, d))
    if tuple(d.shape) != full:
        raise ValueError(f"thomas_solve: d must have the full shape {full}, got {tuple(d.shape)}")
    vertical = _vertical(axis, len(full))
    batch, (h, w) = math.prod(full[:-2]), full[-2:]
    pl = plan_lines(batch, h, w, vertical, None, "thomas", override=plan)
    lib = _lib()
    x = torch.empty(full, dtype=torch.float32, device=d.device)
    rows = row_scratch(pl, batch, w if vertical else h, h if vertical else w, d.device)
    err = _launch(d.device, lambda stream: lib.tridiag_thomas(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(), x.data_ptr(),
        _batch_stride(a, full), _batch_stride(b, full), _batch_stride(c, full), batch, h, w,
        int(vertical), pl.g, pl.r, pl.stages, _ptr(rows), stream))
    _raise_on(lib, "tridiag_thomas", err)
    _count("thomas", pl)
    return x


def tridiag_factor(a, b, c, axis: int = -2, plan=None) -> LineFactor:
    """The elimination of every line along ``axis``, once; the same
    arithmetic as ``solvers/tdma.py::tridiag_factor`` (a[0] and c[-1]
    ignored)."""
    full = _full_shape("tridiag_factor", (a, b, c))
    vertical = _vertical(axis, len(full))
    batch, (h, w) = math.prod(full[:-2]), full[-2:]
    pl = plan_lines(batch, h, w, vertical, None, "factor", override=plan)
    lib = _lib()
    cp = torch.empty(full, dtype=torch.float32, device=b.device)
    denom = torch.empty_like(cp)
    rows = row_scratch(pl, batch, w if vertical else h, h if vertical else w, b.device)
    err = _launch(b.device, lambda stream: lib.tridiag_factor(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), cp.data_ptr(), denom.data_ptr(),
        _batch_stride(a, full), _batch_stride(b, full), _batch_stride(c, full), batch, h, w,
        int(vertical), pl.g, pl.r, pl.stages, _ptr(rows), stream))
    _raise_on(lib, "tridiag_factor", err)
    _count("factor", pl)
    return LineFactor(a, cp, denom, full, vertical)


def _check_factor(fn: str, fac, full: tuple, device) -> None:
    if not isinstance(fac, LineFactor):
        raise ValueError(f"{fn} takes a factor of the kernel, got {type(fac).__name__}")
    if full[-2:] != fac.shape[-2:] or (len(fac.shape) > 2 and full != fac.shape):
        raise ValueError(f"{fn}: fields of shape {full} do not fit a factor of shape {fac.shape}")
    if device != fac.cp.device:
        raise ValueError(f"{fn}: fields on {device}, factor on {fac.cp.device}")


def tridiag_solve(fac: LineFactor, d, parity: int | None = None, plan=None):
    """The RHS pass of ``fac`` for a new ``d`` of the factor's (H, W),
    leading dimensions either the factor's or, for a factor of one plane,
    any. ``parity`` None solves every line and returns d's shape; 0 or 1
    solves only the lines ``parity::2`` (columns of a vertical factor, rows
    of a horizontal one) and returns them compactly, as
    ``solvers/tdma.py::line_solve`` does."""
    if not isinstance(fac, LineFactor):
        raise ValueError(f"tridiag_solve takes a factor of the kernel, got {type(fac).__name__}")
    full = _full_shape("tridiag_solve", (d,))
    _check_factor("tridiag_solve", fac, full, d.device)
    batch, (h, w) = math.prod(full[:-2]), full[-2:]
    n_perp, length = (w, h) if fac.vertical else (h, w)
    if parity is None:
        out_shape, par, n_sel = full, -1, n_perp
    elif parity in (0, 1):
        n_sel = len(range(parity, n_perp, 2))
        out_shape = full[:-1] + (n_sel,) if fac.vertical else full[:-2] + (n_sel, w)
        par = parity
    else:
        raise ValueError(f"tridiag_solve: parity must be None, 0 or 1, got {parity}")
    pl = plan_lines(batch, h, w, fac.vertical, parity, "solve", override=plan)
    x = torch.empty(out_shape, dtype=torch.float32, device=d.device)
    if x.numel() == 0:
        return x
    lib = _lib()
    rows = row_scratch(pl, batch, n_sel, length, d.device)
    err = _launch(d.device, lambda stream: lib.tridiag_solve(
        fac.a.data_ptr(), fac.cp.data_ptr(), fac.denom.data_ptr(), d.data_ptr(), x.data_ptr(),
        _batch_stride(fac.a, full), _batch_stride(fac.cp, full), batch, h, w, int(fac.vertical),
        par, pl.g, pl.r, pl.stages, _ptr(rows), stream))
    _raise_on(lib, "tridiag_solve", err)
    _count("solve", pl)
    return x


def zebra_pass(fac: LineFactor, z, rhs, w_lo, w_hi, parity: int, z_o=None, m=None,
               w_diag=None, plan=None):
    """One zebra-ADI pass in one launch: on the lines ``parity::2`` of
    ``z`` (columns of a vertical factor, rows of a horizontal one),
    ``d = ((rhs [- m z_o]) + w_lo z[lo]) + w_hi z[hi]`` (lo, hi: the W and
    E neighbours of a column, N and S of a row, replicated at the edge),
    plus the diagonal flux of ``w_diag`` = (wnw, wne, wse, wsw) when given,
    then the solve with ``fac``; the same floats as
    ``solvers/tdma.py::zebra_pass``.

    ``z`` is the solver's own correction buffer (``solvers/krylov.py``
    allocates it): the kernel writes the solved lines into it in place and
    returns it. It writes into no other tensor, and ``z`` may not share
    memory with any other argument."""
    if not isinstance(fac, LineFactor):
        raise ValueError(f"zebra_pass takes a factor of the kernel, got {type(fac).__name__}")
    coupled, diag = z_o is not None, w_diag is not None
    if coupled != (m is not None):
        raise ValueError("zebra_pass: z_o and m come together (the coupled pair) or not at all")
    if diag and len(w_diag) != 4:
        raise ValueError(f"zebra_pass: w_diag holds 4 diagonal weights, got {len(w_diag)}")
    if parity not in (0, 1):
        raise ValueError(f"zebra_pass: parity must be 0 or 1, got {parity}")
    weights = (w_lo, w_hi) + (tuple(w_diag) if diag else ())
    fields = (z, rhs) + weights + ((z_o, m) if coupled else ())
    full = _full_shape("zebra_pass", fields, cuda=False)
    for name, t in (("z", z), ("rhs", rhs)) + ((("z_o", z_o),) if coupled else ()):
        if t.shape != full:
            raise ValueError(f"zebra_pass: {name} must have the full shape {full}, "
                             f"got {tuple(t.shape)}")
    if any(t.shape != w_lo.shape for t in weights):
        raise ValueError("zebra_pass: the weights must share one shape, got "
                         f"{[tuple(t.shape) for t in weights]}")
    _require_cuda("zebra_pass", z.device)
    _check_factor("zebra_pass", fac, full, z.device)
    ptrs = [t.data_ptr() for t in fields]
    if ptrs[0] in ptrs[1:] + [fac.a.data_ptr(), fac.cp.data_ptr(), fac.denom.data_ptr()]:
        raise ValueError("zebra_pass: z shares memory with another argument")
    batch, (h, w) = math.prod(full[:-2]), full[-2:]
    pl = plan_lines(batch, h, w, fac.vertical, parity, "zebra", coupled, diag, override=plan)
    n_perp, length = (w, h) if fac.vertical else (h, w)
    n_sel = len(range(parity, n_perp, 2))
    if n_sel == 0:
        return z
    lib = _lib()
    rows = row_scratch(pl, batch, n_sel, length, z.device)
    # fields: z, rhs, w_lo, w_hi, (the four diagonal weights), (z_o, m)
    wd = ptrs[4:8] if diag else [0] * 4
    zo_p, m_p = ptrs[-2:] if coupled else (0, 0)
    err = _launch(z.device, lambda stream: lib.tridiag_zebra_pass(
        fac.a.data_ptr(), fac.cp.data_ptr(), fac.denom.data_ptr(), ptrs[1], ptrs[2], ptrs[3],
        m_p, zo_p, *wd, ptrs[0], _batch_stride(fac.a, full), _batch_stride(fac.cp, full),
        _batch_stride(w_lo, full), _batch_stride(m, full) if coupled else 0, batch, h, w,
        int(fac.vertical), parity, int(coupled), int(diag), pl.g, pl.r, pl.stages, _ptr(rows),
        stream))
    _raise_on(lib, "tridiag_zebra_pass", err)
    _count("zebra_pass", pl)
    return z
