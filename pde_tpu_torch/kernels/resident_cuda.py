"""ctypes wrapper of the resident red-black SOR kernels
(``csrc/resident_sor.cu``): llin4 (``flow_nd``'s solve) and disp llin4
(``disparity_nd``'s, and ``disparity_sym``'s pair as a batch of 2), each
call one launch that keeps the level on chip across its sweeps.

Takes CUDA tensors only and raises on anything else: the choice of the
plain version for CPU tensors, and of the global kernels for shapes
without a plan, is ``kernels/dispatch.py``'s. The library is built and
loaded at the first call, never at import.

Every launch follows a plan from :func:`plan_resident`, pure Python:
the barrier's scope (one block, a thread block cluster, or a cooperative
grid over the card), the row bands (one a block), the threads of a block
and the pixels of each colour a thread owns. :func:`slot_pixels` is the
kernel's map from threads to pixels, for the tests.

``LAUNCHES`` counts one launch per call (``"resident_flow_llin4"``,
``"resident_disp_llin4"``), so a run can show that it went through the
kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from pde_tpu_torch.kernels import build

SOURCE = "resident_sor"
LAUNCHES = {"resident_flow_llin4": 0, "resident_disp_llin4": 0}

FAMILIES = ("llin4", "disp")
SCOPES = ("block", "cluster", "grid")  # resident_sor.cu's Scope
# what a scope's barrier adds to a colour phase, in units of the time one
# more slot a thread adds (scripts/resident_plan_sweep.py on an H100,
# PERF.md, rows 1 and 5): a cluster's about one slot, the grid's about 1.5
SCOPE_COST = {"block": 0.0, "cluster": 1.0, "grid": 1.5}
# the kernel's instantiations: pixels of each colour a thread owns
SLOTS = {"llin4": (1, 2, 3, 4), "disp": (1, 2, 3, 4, 6)}
SMEM_FIELDS = {"llin4": 4, "disp": 2}   # dU, dV, U, V; dU, U
MAX_BATCH = {"llin4": 1, "disp": 2}
LLIN4_NAMES = ("u", "v", "du", "dv", "m", "cu", "cv", "duc", "dvc", "ww", "wn", "we", "ws")
DISP_NAMES = ("u", "du", "cu", "duc", "ww", "wn", "we", "ws")
MAX_THREADS = 512     # __launch_bounds__(512, 1): up to 128 registers a thread
MAX_CLUSTER = 16      # with cudaFuncAttributeNonPortableClusterSizeAllowed
MAX_SMEM = 232448     # bytes of shared memory a block may use on the H100
SM_COUNT = 132        # H100 SXM


@dataclasses.dataclass(frozen=True)
class ResidentPlan:
    """One launch: ``blocks`` row bands of ``rows`` rows per batch entry
    (the last one shorter), ``threads`` threads a block, each owning
    ``slots`` pixels of each colour; ``smem_bytes`` of shared memory a
    block; the barrier's ``scope``."""

    scope: str
    blocks: int
    rows: int
    threads: int
    slots: int
    smem_bytes: int
    batch: int

    @property
    def pixels_per_thread(self) -> int:
        return 2 * self.slots


def smem_bytes(family: str, rows: int, w: int) -> int:
    """A block's shared memory, as ``resident_sor.cu::smem_bytes_of``
    counts it: the relaxed and frozen fields, each a plane per colour of
    the band plus a halo row above and below."""
    return SMEM_FIELDS[family] * 2 * (rows + 2) * ((w + 1) // 2) * 4


def _bands(family: str, h: int, n: int) -> tuple[int, int]:
    """(rows a band, bands) for about ``n`` bands of ``h`` rows: two rows a
    band at least, and for disp the last band too (its border fill reads
    row H-2 from the band of row H-1)."""
    rows = -(-h // n)
    if n > 1:
        rows = max(rows, 2)
    while True:
        n = -(-h // rows)
        if n == 1 or family != "disp" or h - (n - 1) * rows >= 2:
            return rows, n
        rows += 1


def _scope_of(n: int, batch: int, sm_count: int) -> str | None:
    """One block, a cluster, or a grid of one band an SM; None if ``n``
    bands fit none."""
    if n == 1:
        return "block"
    if n <= MAX_CLUSTER:
        return "cluster"
    return "grid" if n * batch <= sm_count else None


def _fit(family: str, h: int, w: int, n: int, batch: int, sm_count: int):
    """The plan for about ``n`` bands, or None where a band does not fit a
    block or the bands no scope: the fewest slots a thread that keep the
    block within ``MAX_THREADS`` (the most threads)."""
    rows, n = _bands(family, h, n)
    scope = _scope_of(n, batch, sm_count)
    half = rows * ((w + 1) // 2)  # pixels of one colour in a band, at most
    smem = smem_bytes(family, rows, w)
    if scope is None or smem > MAX_SMEM:
        return None
    for slots in SLOTS[family]:
        threads = 32 * -(-half // (32 * slots))
        if threads <= MAX_THREADS:
            return ResidentPlan(scope, n, rows, threads, slots, smem, batch)
    return None


def _taken(h: int, w: int, family: str, batch: int) -> bool:
    if family not in FAMILIES:
        raise ValueError(f"family must be one of {FAMILIES}, got {family!r}")
    if not 1 <= batch <= MAX_BATCH[family] or h < 1 or w < 1 or w > 0xFFFF:
        return False
    return family != "disp" or (h >= 3 and w >= 3)  # disp: an interior, a fill that copies


@functools.lru_cache(maxsize=None)
def plans_resident(h: int, w: int, family: str, batch: int = 1,
                   sm_count: int = SM_COUNT) -> tuple[ResidentPlan, ...]:
    """Every plan the kernel takes for a ``batch`` of (h, w) systems of
    ``family`` that no other beats on both counts that set its time: for
    each scope and slots a thread, the one with the fewest bands (the plan
    sweep's candidates)."""
    if not _taken(h, w, family, batch):
        return ()
    best = {}
    for n in range(1, h + 1):
        plan = _fit(family, h, w, n, batch, sm_count)
        if plan is not None:
            best.setdefault((plan.scope, plan.slots), plan)
    return tuple(best.values())


def plan_with_bands(h: int, w: int, family: str, batch: int, n: int,
                    sm_count: int = SM_COUNT) -> ResidentPlan | None:
    """The plan for about ``n`` bands (the bands round so that each but
    the last holds as many rows), or None if the kernel does not take it."""
    return _fit(family, h, w, n, batch, sm_count) if _taken(h, w, family, batch) else None


@functools.lru_cache(maxsize=None)
def plan_resident(h: int, w: int, family: str, batch: int = 1,
                  sm_count: int = SM_COUNT) -> ResidentPlan | None:
    """The launch plan of the resident kernel for a ``batch`` of (h, w)
    systems of ``family`` ("llin4" or "disp"), or None where the kernel
    does not take the shape (the global kernel does): of
    :func:`plans_resident`, the least ``slots + SCOPE_COST[scope]``, then
    the narrowest scope, then the fewest bands."""
    plans = plans_resident(h, w, family, batch, sm_count)
    return min(plans, key=lambda p: (p.slots + SCOPE_COST[p.scope], SCOPES.index(p.scope),
                                     p.blocks), default=None)


def slot_pixels(plan: ResidentPlan, h: int, w: int) -> torch.Tensor:
    """The pixels the kernel's threads own under ``plan``, as the kernel
    maps them: an (n, 2) int64 tensor of (row, column), one row per owned
    pixel of one batch entry (slot k of colour c of thread t of band b is
    row b*rows + q // hw, column 2 (q % hw) + (row + c) % 2, q = t + k *
    threads, hw = ceil(w / 2), if inside the band and the image)."""
    hw = (w + 1) // 2
    t = torch.arange(plan.threads)
    out = []
    for b in range(plan.blocks):
        r0 = b * plan.rows
        rows = min(plan.rows, h - r0)
        for k in range(plan.slots):
            q = t + k * plan.threads
            li = q // hw
            for c in (0, 1):
                gi = r0 + li
                j = 2 * (q % hw) + (gi + c) % 2
                keep = (li < rows) & (j < w)
                out.append(torch.stack((gi[keep], j[keep]), dim=1))
    return torch.cat(out)


@functools.cache
def sm_count(index: int) -> int:
    """SMs of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(x: torch.Tensor, family: str, batch: int) -> ResidentPlan | None:
    """The default plan for systems shaped like ``x`` (..., H, W) on its
    card."""
    h, w = x.shape[-2:]
    return plan_resident(h, w, family, batch, sm_count(x.device.index or 0))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.resident_flow_llin4.argtypes = [p, p, p, i, i, i, f, f, i, i, i, i, i, p]
    lib.resident_flow_llin4.restype = i
    lib.resident_disp_llin4.argtypes = [p, p, i, i, i, i, f, f, i, i, i, i, i, p]
    lib.resident_disp_llin4.restype = i
    lib.resident_sor_smem_bytes.argtypes = [i, i, i]
    lib.resident_sor_smem_bytes.restype = i
    lib.resident_sor_error_string.argtypes = [i]
    lib.resident_sor_error_string.restype = ctypes.c_char_p
    return lib


def _check(fn: str, names, fields, shape) -> None:
    """Every field a contiguous float32 tensor of ``shape`` on the first
    one's card."""
    device = fields[0].device
    if device.type != "cuda":
        raise ValueError(f"{fn} takes CUDA tensors, got {device}")
    for name, x in zip(names, fields):
        if x.device != device or x.dtype != torch.float32 or tuple(x.shape) != tuple(shape) \
                or not x.is_contiguous():
            raise ValueError(
                f"{fn}: {name} must be a contiguous float32 {tuple(shape)} tensor on {device}, "
                f"got {x.dtype} {tuple(x.shape)} on {x.device} (contiguous={x.is_contiguous()})")


def _plan(fn: str, plan, family: str, batch: int, h: int, w: int, device) -> ResidentPlan:
    plan = plan or plan_resident(h, w, family, batch, sm_count(device.index or 0))
    if plan is None or plan.batch != batch:
        raise ValueError(f"{fn}: no resident plan for a batch of {batch} {h}x{w} systems")
    return plan


def _launch(fn: str, entry: str, plan: ResidentPlan, device, *args) -> None:
    """One launch of the C entry ``entry`` on ``device``'s current stream
    (switching the device only when another one is current)."""
    lib = _lib()
    call = functools.partial(getattr(lib, entry), *args, SCOPES.index(plan.scope), plan.blocks,
                             plan.rows, plan.threads, plan.slots)
    if device.index == torch.cuda.current_device():
        err = call(torch._C._cuda_getCurrentRawStream(device.index))
    else:
        with torch.cuda.device(device):
            err = call(torch._C._cuda_getCurrentRawStream(device.index))
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {err} "
                           f"({lib.resident_sor_error_string(err).decode()}), plan {plan}")


def flow_llin4_sor(u, v, du, dv, m, cu, cv, duc, dvc, ww, wn, we, ws, iters: int, omega: float,
                   plan: ResidentPlan | None = None):
    """``iters`` red-black llin4 SOR sweeps on the card in one launch; the
    same function as ``solvers/sor.py::sor_flow_llin4``, and the same bits
    as ``sor_cuda.flow_llin4_sor``. Returns new (dU, dV)."""
    fields = (u, v, du, dv, m, cu, cv, duc, dvc, ww, wn, we, ws)
    if u.ndim != 2:
        raise ValueError(f"resident flow_llin4_sor takes (H, W) fields, got {tuple(u.shape)}")
    _check("resident flow_llin4_sor", LLIN4_NAMES, fields, u.shape)
    h, w = u.shape
    plan = _plan("resident flow_llin4_sor", plan, "llin4", 1, h, w, u.device)
    out_du, out_dv = torch.empty_like(du), torch.empty_like(dv)
    ptrs = (ctypes.c_void_p * len(fields))(*(x.data_ptr() for x in fields))
    _launch("resident flow_llin4_sor", "resident_flow_llin4", plan, u.device, ptrs,
            out_du.data_ptr(), out_dv.data_ptr(), h, w, max(int(iters), 0), float(omega),
            1.0 - float(omega))
    LAUNCHES["resident_flow_llin4"] += 1
    return out_du, out_dv


def _disp(sets, outs, h: int, w: int, iters: int, omega: float, plan) -> None:
    """One launch over the batch: ``sets`` of 8 data pointers each, the
    (H, W) planes of one system, and ``outs`` their dU planes."""
    device = outs[0].device
    batch = len(sets)
    plan = _plan("resident disp_llin4_sor", plan, "disp", batch, h, w, device)
    ptrs = (ctypes.c_void_p * (8 * batch))(*(p for s in sets for p in s))
    outp = (ctypes.c_void_p * batch)(*(o.data_ptr() for o in outs))
    _launch("resident disp_llin4_sor", "resident_disp_llin4", plan, device, ptrs, outp, batch,
            h, w, max(int(iters), 0), float(omega), 1.0 - float(omega))
    LAUNCHES["resident_disp_llin4"] += 1


def disp_llin4_sor(u, du, cu, duc, ww, wn, we, ws, iters: int, omega: float,
                   plan: ResidentPlan | None = None):
    """``iters`` red-black disparity llin4 sweeps on the card in one launch;
    the same function as ``solvers/sor.py::sor_disp_llin4`` and the same
    bits. All fields share one shape, (H, W) or (B, H, W) with B <= 2,
    H, W >= 3. Returns new dU."""
    fields = (u, du, cu, duc, ww, wn, we, ws)
    if u.ndim not in (2, 3):
        raise ValueError(f"resident disp_llin4_sor takes (H, W) or (B, H, W) fields, "
                         f"got {tuple(u.shape)}")
    _check("resident disp_llin4_sor", DISP_NAMES, fields, u.shape)
    batch = u.shape[0] if u.ndim == 3 else 1
    h, w = u.shape[-2:]
    out = torch.empty_like(du)
    plane = h * w * 4
    sets = [[x.data_ptr() + b * plane for x in fields] for b in range(batch)]
    outs = [out[b] for b in range(batch)] if u.ndim == 3 else [out]
    _disp(sets, outs, h, w, iters, omega, plan)
    return out


def disp_llin4_pair(fields0, fields1, iters: int, omega: float,
                    plan: ResidentPlan | None = None):
    """The symmetric pair in one launch (a batch of 2), each system its own
    8 (H, W) planes ``(u, du, cu, duc, ww, wn, we, ws)``, never stacked.
    Returns (dU0, dU1)."""
    _check("resident disp_llin4_pair", DISP_NAMES * 2, (*fields0, *fields1), fields0[0].shape)
    if fields0[0].ndim != 2:
        raise ValueError(f"resident disp_llin4_pair takes (H, W) fields, "
                         f"got {tuple(fields0[0].shape)}")
    h, w = fields0[0].shape
    outs = [torch.empty_like(fields0[1]), torch.empty_like(fields1[1])]
    _disp([[x.data_ptr() for x in fields0], [x.data_ptr() for x in fields1]], outs, h, w, iters,
          omega, plan)
    return outs[0], outs[1]

