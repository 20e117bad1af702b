"""ctypes wrapper of the temporally blocked tile kernel
(``csrc/tiled_sor.cu``): llin4 and elin4, serial or double-buffered, a
plan of k sweeps a chunk, a tile and ``slots`` pairs of pixels a thread
(``kernels/tiled.py``'s ``TilePlan``).

Takes CUDA tensors only and raises on anything else: the choice of the
plain tile schedule for CPU tensors is ``kernels/tiled.py``'s. The library
is built and loaded at the first call, never at import.

``LAUNCHES`` counts the kernel launches this wrapper has made, per family
and variant (``"tiled_flow_llin4"``, ``"tiled_flow_llin4_db"``,
``"tiled_flow_elin4"``, ``"tiled_flow_elin4_db"``): ``ceil(iters / k)`` per
call, one a chunk (the prepare runs inside each chunk), none for
``iters <= 0``. The windowed variant (``tiled_flow_sor_window``, one chunk
over a box of part of an image: a shard of ``parallel/tiled.py`` and its
halo) counts one a call under ``"tiled_flow_llin4_win"``,
``"tiled_flow_elin4_win"`` and their ``"_db"`` keys.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pde_tpu_torch.kernels import build

SOURCE = "tiled_sor"
LAUNCHES = {f"tiled_flow_{family}{variant}": 0 for family in ("llin4", "elin4")
            for variant in ("", "_db", "_win", "_win_db")}
# the fields of each family in tiled_relax's order: the two relaxed first
FIELD_NAMES = {
    "flow_llin4": ("du", "dv", "u", "v", "m", "cu", "cv", "duc", "dvc", "ww", "wn", "we", "ws"),
    "flow_elin4": ("u", "v", "m", "cu", "cv", "duc", "dvc", "ww", "wn", "we", "ws"),
}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for family, names in FIELD_NAMES.items():
        fn = getattr(lib, f"tiled_{family}")
        fn.argtypes = [p] * (len(names) + 4) + [i] * 8 + [f, f, p]
        fn.restype = i
        fn = getattr(lib, f"tiled_{family}_win")
        fn.argtypes = [p] * (len(names) + 2) + [i] * 15 + [f, f, p]
        fn.restype = i
    lib.tiled_sor_slot_bytes.argtypes = [i, i, i, i]
    lib.tiled_sor_slot_bytes.restype = i
    lib.tiled_sor_threads.argtypes = [i, i, i, i]
    lib.tiled_sor_threads.restype = i
    lib.tiled_sor_error_string.argtypes = [i]
    lib.tiled_sor_error_string.restype = ctypes.c_char_p
    return lib


def _check(family: str, fields, window=None, k: int = 0) -> tuple[int, int]:
    """The fields' (H, W); raises on what the kernel does not take, the
    device last (after the ``window`` of a chunk of ``k`` sweeps)."""
    names = FIELD_NAMES[family]
    if len(fields) != len(names):
        raise ValueError(f"tiled_{family} takes {len(names)} fields {names}, got {len(fields)}")
    shape, device = fields[0].shape, fields[0].device
    if len(shape) != 2 or shape[0] < 1 or shape[1] < 1:
        raise ValueError(f"tiled_{family} takes non-empty (H, W) fields, got {tuple(shape)}")
    for name, x in zip(names, fields):
        if x.device != device or x.dtype != torch.float32 or x.shape != shape \
                or not x.is_contiguous():
            raise ValueError(
                f"tiled_{family}: {name} must be a contiguous float32 {tuple(shape)} "
                f"tensor on {device}, got {x.dtype} {tuple(x.shape)} on {x.device} "
                f"(contiguous={x.is_contiguous()})")
    if window is not None:
        from pde_tpu_torch.kernels.tiled import check_window

        check_window(shape, window, k)
    if device.type != "cuda":
        raise ValueError(f"tiled_{family} takes CUDA tensors, got {device}")
    return shape[0], shape[1]


def _slots(family: str, k: int, tile_h: int, tile_w: int, slots, double_buffer: bool) -> int:
    """The pairs a thread of the plan (the fewest that fit where ``slots``
    is None); raises where the kernel does not take the plan."""
    from pde_tpu_torch.kernels import tiled

    if k < 1 or tile_h < 1 or tile_w < 1:
        raise ValueError(f"tile plan k={k}, tile {tile_h}x{tile_w}: each must be >= 1")
    plan = tiled.make_plan(tile_h, tile_w, len(FIELD_NAMES[family]), k, tile_h, tile_w, slots,
                           double_buffer)
    if plan is None:
        raise ValueError(f"tiled_{family} takes no plan of k={k}, tile {tile_h}x{tile_w}, "
                         f"slots={slots} (double_buffer={double_buffer})")
    return plan.slots


def tiled_flow_sor(family: str, fields, iters: int, omega: float, k: int, tile_h: int,
                   tile_w: int, double_buffer: bool = False, slots: int | None = None):
    """``iters`` red-black sweeps of ``family`` (``"flow_llin4"`` or
    ``"flow_elin4"``) on the card, in chunks of ``k`` over tiles of
    ``tile_h`` x ``tile_w``, ``slots`` pairs of pixels a thread (the fewest
    that fit by default); the same function as ``solvers/sor.py``'s
    ``sor_<family>``. ``fields`` in the order of ``FIELD_NAMES[family]``.
    Returns the two relaxed fields."""
    if family not in FIELD_NAMES:
        raise ValueError(f"no tile kernel for {family!r}; it has {sorted(FIELD_NAMES)}")
    h, w = _check(family, fields)
    slots = _slots(family, k, tile_h, tile_w, slots, double_buffer)
    iters = max(int(iters), 0)  # as the plain loop: no sweep for iters <= 0
    if iters == 0:
        return fields[0].clone(), fields[1].clone()
    lib = _lib()
    out_a, out_b = (torch.empty_like(x) for x in fields[:2])
    n_chunks = -(-iters // k)
    # the chunks ping-pong between out and tmp, ending in out
    tmp = [torch.empty_like(x) for x in fields[:2]] if n_chunks > 1 else [None, None]
    device = fields[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"tiled_{family}")(
            *(x.data_ptr() for x in fields), out_a.data_ptr(), out_b.data_ptr(),
            *(0 if t is None else t.data_ptr() for t in tmp),
            h, w, iters, k, tile_h, tile_w, slots, int(bool(double_buffer)),
            float(omega), 1.0 - float(omega), stream)
    if err != 0:
        raise RuntimeError(f"tiled_{family} launch failed: cudaError {err} "
                           f"({lib.tiled_sor_error_string(err).decode()})")
    LAUNCHES[f"tiled_{family}" + ("_db" if double_buffer else "")] += n_chunks
    return out_a, out_b


def tiled_flow_sor_window(family: str, fields, iters: int, omega: float, window, tile_h: int,
                          tile_w: int, double_buffer: bool = False, slots: int | None = None):
    """One chunk of ``iters`` red-black sweeps of ``family`` on the card over
    the tiles of ``window.box`` (``kernels/tiled.Window``: the fields are
    part of an image), in tiles of ``tile_h`` x ``tile_w``, ``slots`` pairs
    a thread. Returns the box's part of the two relaxed fields, as the same
    sweeps over the whole image give it."""
    if family not in FIELD_NAMES:
        raise ValueError(f"no tile kernel for {family!r}; it has {sorted(FIELD_NAMES)}")
    if tile_h < 1 or tile_w < 1:
        raise ValueError(f"tile {tile_h}x{tile_w}: each side must be >= 1")
    iters = max(int(iters), 0)
    h, w = _check(family, fields, window, iters)
    slots = _slots(family, max(iters, 1), tile_h, tile_w, slots, double_buffer)
    i0, i1, j0, j1 = window.box
    if iters == 0:
        return fields[0][i0:i1, j0:j1].clone(), fields[1][i0:i1, j0:j1].clone()
    lib = _lib()
    out_a, out_b = (x.new_empty((i1 - i0, j1 - j0)) for x in fields[:2])
    device = fields[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"tiled_{family}_win")(
            *(x.data_ptr() for x in fields), out_a.data_ptr(), out_b.data_ptr(),
            h, w, window.r0, window.c0, window.gh, window.gw, i0, j0, i1 - i0, j1 - j0,
            iters, tile_h, tile_w, slots, int(bool(double_buffer)), float(omega),
            1.0 - float(omega), stream)
    if err != 0:
        raise RuntimeError(f"tiled_{family}_win launch failed: cudaError {err} "
                           f"({lib.tiled_sor_error_string(err).decode()})")
    LAUNCHES[f"tiled_{family}_win" + ("_db" if double_buffer else "")] += 1
    return out_a, out_b
