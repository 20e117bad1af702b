"""ctypes wrapper of the resident red-black SOR kernels, each call one launch
that keeps the level on chip across its sweeps:

* ``csrc/resident_sor.cu``: llin4 (``flow_nd``'s solve), elin4
  (``flow_hs``'s with ``solver=1``), disp llin4 (``disparity_nd``'s, and
  ``disparity_sym``'s pair as a batch of 2) and pde4 (``tv_denoise4``'s, up
  to 3 channels over shared weights);
* ``csrc/resident8_sor.cu``: the 8-neighbour llin8 (``flow_ad``'s solve)
  and pde8 (``tv_denoise8``'s, up to 3 channels over shared weights), whose
  relaxed fields keep two buffers a colour (Jacobi within a colour).

Takes CUDA tensors only and raises on anything else: the choice of the
plain version for CPU tensors, and of the tile or global kernels for
shapes without a plan, is ``kernels/dispatch.py``'s. The libraries are built and
loaded at the first call, never at import.

Every launch follows a plan from :func:`plan_resident`, pure Python:
the barrier's scope (one block, a thread block cluster, or a cooperative
grid over the card), the row bands (one a block), the threads of a block
and the pixels of each colour a thread owns. :func:`slot_pixels` is the
kernels' map from threads to pixels, for the tests.

``LAUNCHES`` counts one launch per call (``"resident_flow_llin4"``,
``"resident_flow_elin4"``, ``"resident_disp_llin4"``, ``"resident_pde4"``,
``"resident_flow_llin8"``, ``"resident_pde8"``), so a run can show that it
went through the kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from pde_tpu_torch.kernels import build

SOURCE = "resident_sor"     # llin4, disp, pde4, elin4
SOURCE8 = "resident8_sor"   # llin8, pde8
LAUNCHES = {"resident_flow_llin4": 0, "resident_flow_elin4": 0, "resident_disp_llin4": 0,
            "resident_pde4": 0, "resident_flow_llin8": 0, "resident_pde8": 0}

FAMILIES = ("llin4", "disp", "pde4", "elin4", "llin8", "pde8")
SOR_FAMILIES = FAMILIES[:4]  # resident_sor.cu's Family, in its order
# the families that relax interior pixels and fill the 1-px border
INTERIOR = ("disp", "pde4", "pde8")
SCOPES = ("block", "cluster", "grid")  # resident_sor.cu's Scope
# what a scope's barrier adds to a colour phase, in units of the time one
# more slot a thread adds (scripts/resident_plan_sweep.py on an H100,
# PERF.md, rows 1, 3 and 5): a cluster's about one slot, the grid's about 1.5
SCOPE_COST = {"block": 0.0, "cluster": 1.0, "grid": 1.5}
# llin8, pde8 and pde4: a phase's time grows with the slots a thread times
# the warps each of an SM's four schedulers runs, threads / 128, so more and
# narrower bands are cheaper within a scope; the barriers' cost in those
# units (a least-squares fit over every plan scripts/resident_plan_sweep.py
# timed on an H100, PERF.md, rows 4 and 6b: a cluster about 3.6, the grid
# about 5.5). pde4 (channels in the slot) ranks its plans so too: with these
# costs its default plan was the fastest swept at every level of
# tv_denoise4's pyramid, C = 1 and 3, where the slots alone lost up to 3%
# (PERF.md, row 6a)
SCOPE_COST8 = {"block": 0.0, "cluster": 3.6, "grid": 5.5}
WARP_COST = ("llin8", "pde8", "pde4")  # the families costed by SCOPE_COST8
# the kernel's instantiations: pixels of each colour a thread owns
SLOTS = {"llin4": (1, 2, 3, 4), "disp": (1, 2, 3, 4, 6), "pde4": (1, 2, 3, 4, 5),
         "elin4": (1, 2, 3, 4), "llin8": (1, 2, 3, 4), "pde8": (1, 2, 3, 4, 5)}
# pde4 keeps 4 + 2 C coefficient floats a slot in registers: past 6 - C
# slots they spill (nvcc -Xptxas -v, PERF.md row 6a), so the kernel has
# those slots only
PDE4_MAX_SLOTS = 6
# A block's shared memory in planes of the band: (fields kept with a halo row
# above and below, a one-buffer field counting 1 and a ping-pong one 2 (pde4,
# pde8: per channel), weight planes of the band alone). llin4: dU, dV, U, V;
# elin4: U, V; disp: dU, U; pde4: each channel's X; llin8: dU, dV twice, U,
# V, and the eight weights with their sum; pde8: each channel's X twice, and
# the eight weights.
SMEM_FIELDS = {"llin4": (4, 0), "disp": (2, 0), "pde4": (1, 0), "elin4": (2, 0),
               "llin8": (6, 9), "pde8": (2, 8)}
# systems a launch: disp's pair as blocks of a second grid row, pde4's and
# pde8's channels in the thread that owns a pixel (with weights shared by
# them)
MAX_BATCH = {"llin4": 1, "disp": 2, "pde4": 3, "elin4": 1, "llin8": 1, "pde8": 3}
LLIN4_NAMES = ("u", "v", "du", "dv", "m", "cu", "cv", "duc", "dvc", "ww", "wn", "we", "ws")
ELIN4_NAMES = ("u", "v", "m", "cu", "cv", "duc", "dvc", "ww", "wn", "we", "ws")
DISP_NAMES = ("u", "du", "cu", "duc", "ww", "wn", "we", "ws")
PDE4_NAMES = ("x", "trace", "b", "ww", "wn", "we", "ws")
W8_NAMES = ("ww", "wnw", "wn", "wne", "we", "wse", "ws", "wsw")
LLIN8_NAMES = ("u", "v", "du", "dv", "m", "cu", "cv", "duc", "dvc") + W8_NAMES
PDE8_NAMES = ("x", "trace", "b") + W8_NAMES
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


def smem_bytes(family: str, rows: int, w: int, batch: int = 1) -> int:
    """A block's shared memory, as ``resident_sor.cu::smem_bytes_of`` and
    ``resident8_sor.cu::smem_bytes_of`` count it (``SMEM_FIELDS``): the
    fields, each a plane per colour (and buffer) of the band plus a halo
    row above and below, and the weight planes of the band (pde4, pde8: for
    ``batch`` channels)."""
    halo, band = SMEM_FIELDS[family]
    if family in ("pde4", "pde8"):
        halo *= batch
    hw = (w + 1) // 2
    return (halo * 2 * (rows + 2) * hw + band * 2 * rows * hw) * 4


def edge_floats(family: str, batch: int, blocks: int, w: int) -> int:
    """Floats of the band-edge scratch a grid launch of llin8 or pde8 needs
    (``resident8_sor.cu::resident8_edge_floats``): two buffers of the first
    and last row of every band, for each relaxed field (dU, dV; a channel
    each)."""
    return 2 * (2 if family == "llin8" else batch) * 2 * blocks * w


def _bands(family: str, h: int, n: int) -> tuple[int, int]:
    """(rows a band, bands) for about ``n`` bands of ``h`` rows: two rows a
    band at least, and for the interior families the last band too (its
    border fill reads row H-2 from the band of row H-1)."""
    rows = -(-h // n)
    if n > 1:
        rows = max(rows, 2)
    while True:
        n = -(-h // rows)
        if n == 1 or family not in INTERIOR or h - (n - 1) * rows >= 2:
            return rows, n
        rows += 1


def _scope_of(n: int, blocks_a_band: int, sm_count: int) -> str | None:
    """One block, a cluster, or a grid of one band an SM (``blocks_a_band``
    blocks a band: disp's batch); None if ``n`` bands fit none."""
    if n == 1:
        return "block"
    if n <= MAX_CLUSTER:
        return "cluster"
    return "grid" if n * blocks_a_band <= sm_count else None


def _fit(family: str, h: int, w: int, n: int, batch: int, sm_count: int):
    """The plan for about ``n`` bands, or None where a band does not fit a
    block or the bands no scope: the fewest slots a thread that keep the
    block within ``MAX_THREADS`` (the most threads)."""
    rows, n = _bands(family, h, n)
    scope = _scope_of(n, batch if family == "disp" else 1, sm_count)
    half = rows * ((w + 1) // 2)  # pixels of one colour in a band, at most
    smem = smem_bytes(family, rows, w, batch)
    if scope is None or smem > MAX_SMEM:
        return None
    for slots in SLOTS[family]:
        if family == "pde4" and slots > PDE4_MAX_SLOTS - batch:
            continue
        threads = 32 * -(-half // (32 * slots))
        if threads <= MAX_THREADS:
            return ResidentPlan(scope, n, rows, threads, slots, smem, batch)
    return None


def _taken(h: int, w: int, family: str, batch: int) -> bool:
    if family not in FAMILIES:
        raise ValueError(f"family must be one of {FAMILIES}, got {family!r}")
    if not 1 <= batch <= MAX_BATCH[family] or h < 1 or w < 1 or w > 0xFFFF:
        return False
    # disp, pde4, pde8: an interior, a fill that copies
    return family not in INTERIOR or (h >= 3 and w >= 3)


def work(plan: ResidentPlan, family: str) -> float:
    """What sets a colour phase's time besides the barrier: the slots a
    thread (llin4, elin4, disp), times the warps a scheduler runs (llin8,
    pde8, pde4)."""
    if family in WARP_COST:
        return plan.slots * plan.threads / 128
    return plan.slots


def cost(plan: ResidentPlan, family: str) -> float:
    """The plan's cost in ``work`` units, with its barrier's."""
    scope_cost = SCOPE_COST8 if family in WARP_COST else SCOPE_COST
    return work(plan, family) + scope_cost[plan.scope]


@functools.lru_cache(maxsize=None)
def plans_resident(h: int, w: int, family: str, batch: int = 1,
                   sm_count: int = SM_COUNT) -> tuple[ResidentPlan, ...]:
    """The plans the kernel takes for a ``batch`` of (h, w) systems of
    ``family`` that the plan sweep times: for each scope and slots a
    thread, the one with the fewest bands and, for the ``WARP_COST``
    families (whose :func:`work` falls with the threads a block), the one
    with the most."""
    if not _taken(h, w, family, batch):
        return ()
    fewest, most = {}, {}
    for n in range(1, h + 1):
        plan = _fit(family, h, w, n, batch, sm_count)
        if plan is not None:
            fewest.setdefault((plan.scope, plan.slots), plan)
            most[(plan.scope, plan.slots)] = plan
    if family in WARP_COST:
        return tuple(dict.fromkeys([*fewest.values(), *most.values()]))
    return tuple(fewest.values())


def plan_with_bands(h: int, w: int, family: str, batch: int, n: int,
                    sm_count: int = SM_COUNT) -> ResidentPlan | None:
    """The plan for about ``n`` bands (the bands round so that each but
    the last holds as many rows), or None if the kernel does not take it."""
    return _fit(family, h, w, n, batch, sm_count) if _taken(h, w, family, batch) else None


@functools.lru_cache(maxsize=None)
def plan_resident(h: int, w: int, family: str, batch: int = 1,
                  sm_count: int = SM_COUNT) -> ResidentPlan | None:
    """The launch plan of the resident kernel for a ``batch`` of (h, w)
    systems of ``family`` (one of ``FAMILIES``), or None where the kernel
    does not take the shape (the global kernel does): of
    :func:`plans_resident`, the least :func:`cost`, then the narrowest
    scope, then the fewest bands."""
    plans = plans_resident(h, w, family, batch, sm_count)
    return min(plans, key=lambda p: (cost(p, family), SCOPES.index(p.scope), p.blocks),
               default=None)


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


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.resident_flow_llin4.argtypes = [p, p, p, i, i, i, f, f, i, i, i, i, i, p]
    lib.resident_flow_llin4.restype = i
    lib.resident_flow_elin4.argtypes = [p, p, p, i, i, i, f, f, i, i, i, i, i, p]
    lib.resident_flow_elin4.restype = i
    lib.resident_disp_llin4.argtypes = [p, p, i, i, i, i, f, f, i, i, i, i, i, p]
    lib.resident_disp_llin4.restype = i
    lib.resident_pde4.argtypes = [p, p, p, p, p, i, i, i, i, f, f, i, i, i, i, i, p]
    lib.resident_pde4.restype = i
    lib.resident_sor_smem_bytes.argtypes = [i, i, i, i]
    lib.resident_sor_smem_bytes.restype = i
    lib.resident_sor_error_string.argtypes = [i]
    lib.resident_sor_error_string.restype = ctypes.c_char_p
    lib.error_string = lib.resident_sor_error_string
    return lib


@functools.cache
def _lib8() -> ctypes.CDLL:
    lib = build.load(SOURCE8)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.resident_flow_llin8.argtypes = [p, p, p, p, i, i, i, f, f, i, i, i, i, i, p]
    lib.resident_flow_llin8.restype = i
    lib.resident_pde8.argtypes = [p, p, p, p, p, p, i, i, i, i, f, f, i, i, i, i, i, p]
    lib.resident_pde8.restype = i
    lib.resident8_smem_bytes.argtypes = [i, i, i, i]
    lib.resident8_smem_bytes.restype = i
    lib.resident8_edge_floats.argtypes = [i, i, i, i]
    lib.resident8_edge_floats.restype = ctypes.c_int64
    lib.resident8_error_string.argtypes = [i]
    lib.resident8_error_string.restype = ctypes.c_char_p
    lib.error_string = lib.resident8_error_string
    return lib


def _check(fn: str, names, fields, shape, device=None) -> None:
    """Every field a contiguous float32 tensor of ``shape`` on ``device``
    (by default the first one's), a card."""
    device = device or fields[0].device
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


def _launch(fn: str, entry: str, plan: ResidentPlan, device, *args, lib=None) -> None:
    """One launch of the C entry ``entry`` of ``lib`` (``_lib()`` by
    default) on ``device``'s current stream (switching the device only when
    another one is current)."""
    lib = lib or _lib()
    call = functools.partial(getattr(lib, entry), *args, SCOPES.index(plan.scope), plan.blocks,
                             plan.rows, plan.threads, plan.slots)
    if device.index == torch.cuda.current_device():
        err = call(torch._C._cuda_getCurrentRawStream(device.index))
    else:
        with torch.cuda.device(device):
            err = call(torch._C._cuda_getCurrentRawStream(device.index))
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {err} "
                           f"({lib.error_string(err).decode()}), plan {plan}")


def _flow4(family: str, names, fields, relaxed, iters: int, omega: float, plan):
    """One launch of llin4 or elin4 over the (H, W) ``fields``; returns the
    two ``relaxed`` fields' new values, in new tensors."""
    fn = f"resident flow_{family}_sor"
    u = fields[0]
    if u.ndim != 2:
        raise ValueError(f"{fn} takes (H, W) fields, got {tuple(u.shape)}")
    _check(fn, names, fields, u.shape)
    h, w = u.shape
    plan = _plan(fn, plan, family, 1, h, w, u.device)
    # on the grid the bands' edge rows pass through the outputs during the
    # call, so they must not alias the inputs
    out_u, out_v = (torch.empty_like(x) for x in relaxed)
    ptrs = (ctypes.c_void_p * len(fields))(*(x.data_ptr() for x in fields))
    _launch(fn, f"resident_flow_{family}", plan, u.device, ptrs, out_u.data_ptr(),
            out_v.data_ptr(), h, w, max(int(iters), 0), float(omega), 1.0 - float(omega))
    LAUNCHES[f"resident_flow_{family}"] += 1
    return out_u, out_v


def flow_llin4_sor(u, v, du, dv, m, cu, cv, duc, dvc, ww, wn, we, ws, iters: int, omega: float,
                   plan: ResidentPlan | None = None):
    """``iters`` red-black llin4 SOR sweeps on the card in one launch; the
    same function as ``solvers/sor.py::sor_flow_llin4``, and the same bits
    as ``sor_cuda.flow_llin4_sor``. Returns new (dU, dV)."""
    return _flow4("llin4", LLIN4_NAMES, (u, v, du, dv, m, cu, cv, duc, dvc, ww, wn, we, ws),
                  (du, dv), iters, omega, plan)


def flow_elin4_sor(u, v, m, cu, cv, duc, dvc, ww, wn, we, ws, iters: int, omega: float,
                   plan: ResidentPlan | None = None):
    """``iters`` red-black elin4 SOR sweeps on the card in one launch; the
    same function as ``solvers/sor.py::sor_flow_elin4``, and the same bits
    as ``sor_cuda.flow_elin4_sor``. Returns new (U, V); ``u`` and ``v`` are
    left as they are."""
    return _flow4("elin4", ELIN4_NAMES, (u, v, m, cu, cv, duc, dvc, ww, wn, we, ws), (u, v),
                  iters, omega, plan)


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



def _edge(plan: ResidentPlan, family: str, batch: int, w: int, device):
    """The band-edge scratch of a grid launch (None for the other scopes,
    which exchange rows in shared memory)."""
    if plan.scope != "grid":
        return None
    return torch.empty(edge_floats(family, batch, plan.blocks, w), dtype=torch.float32,
                       device=device)


def flow_llin8_sor(u, v, du, dv, m, cu, cv, duc, dvc, ww, wnw, wn, wne, we, wse, ws, wsw,
                   iters: int, omega: float, plan: ResidentPlan | None = None):
    """``iters`` red-black llin8 SOR sweeps on the card in one launch; the
    same function as ``solvers/sor.py::sor_flow_llin8``, and the same bits
    as ``sor_cuda.flow_llin8_sor``. Returns new (dU, dV)."""
    fields = (u, v, du, dv, m, cu, cv, duc, dvc, ww, wnw, wn, wne, we, wse, ws, wsw)
    if u.ndim != 2:
        raise ValueError(f"resident flow_llin8_sor takes (H, W) fields, got {tuple(u.shape)}")
    _check("resident flow_llin8_sor", LLIN8_NAMES, fields, u.shape)
    h, w = u.shape
    plan = _plan("resident flow_llin8_sor", plan, "llin8", 1, h, w, u.device)
    out_du, out_dv = torch.empty_like(du), torch.empty_like(dv)
    edge = _edge(plan, "llin8", 1, w, u.device)
    ptrs = (ctypes.c_void_p * len(fields))(*(x.data_ptr() for x in fields))
    _launch("resident flow_llin8_sor", "resident_flow_llin8", plan, u.device, ptrs,
            out_du.data_ptr(), out_dv.data_ptr(), None if edge is None else edge.data_ptr(), h,
            w, max(int(iters), 0), float(omega), 1.0 - float(omega), lib=_lib8())
    LAUNCHES["resident_flow_llin8"] += 1
    return out_du, out_dv


def diag_channels(family: str, x, trace, b, weights) -> int | None:
    """The channels of a pde4 or pde8 call that the resident kernel takes,
    from the shapes alone, or None: X (H, W) or (C, H, W) with C <= 3, the
    weights (H, W) planes shared by the channels, TRACE and B each X's
    shape or one shared (H, W) plane."""
    if x.ndim not in (2, 3):
        return None
    hw_shape = tuple(x.shape[-2:])
    if any(tuple(wt.shape) != hw_shape for wt in weights):
        return None
    if any(tuple(c.shape) not in (tuple(x.shape), hw_shape) for c in (trace, b)):
        return None
    channels = x.shape[0] if x.ndim == 3 else 1
    return channels if 1 <= channels <= MAX_BATCH[family] else None


def _diag(family: str, names, x, trace, b, weights, plan):
    """Check a pde4 or pde8 call and plan it: (plan, the new X, and a map
    from a tensor to the pointer array of its channels, a shared plane's
    pointer repeated)."""
    fn = f"resident {family}_sor"
    if x.device.type != "cuda":
        raise ValueError(f"{fn} takes CUDA tensors, got {x.device}")
    channels = diag_channels(family, x, trace, b, weights)
    if channels is None:
        raise ValueError(f"{fn} takes (H, W) or (C <= 3, H, W) X with (H, W) weights, "
                         f"got {tuple(x.shape)} and {tuple(weights[0].shape)}")
    h, w = x.shape[-2:]
    for name, t in zip(names, (x, trace, b) + weights):
        _check(fn, (name,), (t,), t.shape, x.device)
    plan = _plan(fn, plan, family, channels, h, w, x.device)
    plane = h * w * 4

    def per_channel(t):
        step = plane if t.ndim == x.ndim and channels > 1 else 0
        return (ctypes.c_void_p * channels)(*(t.data_ptr() + c * step for c in range(channels)))

    return plan, torch.empty_like(x), per_channel


def pde4_sor(x, trace, b, ww, wn, we, ws, iters: int, omega: float,
             plan: ResidentPlan | None = None):
    """``iters`` red-black diagonal-form 4-neighbour sweeps on the card in
    one launch; the same function as ``solvers/sor.py::sor_pde4`` and the
    same bits (as ``interior_cuda.pde4_sor``'s). ``x`` is (H, W) or
    (C, H, W), C <= 3, H, W >= 3; the weights are (H, W) planes shared by
    the channels; TRACE and B each have x's shape or are one shared (H, W)
    plane. Returns new X."""
    weights = (ww, wn, we, ws)
    plan, out, per_channel = _diag("pde4", PDE4_NAMES, x, trace, b, weights, plan)
    h, w = x.shape[-2:]
    wptrs = (ctypes.c_void_p * 4)(*(wt.data_ptr() for wt in weights))
    _launch("resident pde4_sor", "resident_pde4", plan, x.device, per_channel(x),
            per_channel(trace), per_channel(b), wptrs, per_channel(out), plan.batch, h, w,
            max(int(iters), 0), float(omega), 1.0 - float(omega))
    LAUNCHES["resident_pde4"] += 1
    return out


def pde8_sor(x, trace, b, ww, wnw, wn, wne, we, wse, ws, wsw, iters: int, omega: float,
             plan: ResidentPlan | None = None):
    """``iters`` red-black diagonal-form 8-neighbour sweeps on the card in
    one launch; the same function as ``solvers/sor.py::sor_pde8`` and the
    same bits (as ``interior_cuda.pde8_sor``'s), with the shapes of
    ``pde4_sor`` and the eight weights. Returns new X."""
    weights = (ww, wnw, wn, wne, we, wse, ws, wsw)
    plan, out, per_channel = _diag("pde8", PDE8_NAMES, x, trace, b, weights, plan)
    h, w = x.shape[-2:]
    edge = _edge(plan, "pde8", plan.batch, w, x.device)
    wptrs = (ctypes.c_void_p * 8)(*(wt.data_ptr() for wt in weights))
    _launch("resident pde8_sor", "resident_pde8", plan, x.device, per_channel(x),
            per_channel(trace), per_channel(b), wptrs, per_channel(out),
            None if edge is None else edge.data_ptr(), plan.batch, h, w, max(int(iters), 0),
            float(omega), 1.0 - float(omega), lib=_lib8())
    LAUNCHES["resident_pde8"] += 1
    return out
