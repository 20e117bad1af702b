"""ctypes wrapper of the temporally blocked tile kernel
(``csrc/tiled_sor.cu``): the six families of ``kernels/tiled.LAYOUTS``,
serial or double-buffered, a plan of k sweeps a
chunk, a tile and ``slots`` pairs of pixels a thread (``kernels/tiled.py``'s
``TilePlan``). disp llin4 takes a batch of 1 or 2 systems, pde4 and pde8
up to 3 channels, in one launch; each system has its own planes, and a
plane the systems share is passed once. A pde4 or pde8 block relaxes every
channel of its tile, whose weights must be (H, W) planes the channels
share; TRACE and B may be either.

Takes CUDA tensors only and raises on anything else: the choice of the
plain tile schedule for CPU tensors is ``kernels/tiled.py``'s. The library
is built and loaded at the first call, never at import.

``LAUNCHES`` counts the kernel launches this wrapper has made, per family
and variant (``"tiled_<family>"`` serial, ``"tiled_<family>_db"``
double-buffered, for every family): ``ceil(iters / k)`` per call, one a
chunk (the prepare runs inside each chunk, every system of the batch in
the same launch), none for ``iters <= 0``. The windowed variant
(``tiled_sor_window``, one chunk over a box of part of an image: a shard
of ``parallel/tiled.py`` and its halo) counts one a call under
``"tiled_<family>_win"`` (``"_win_db"`` double-buffered), for every family
the sharded solvers run (all but pde8).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pde_tpu_torch.kernels import build

SOURCE = "tiled_sor"
# the fields of each family in tiled_relax's order: the relaxed first
FIELD_NAMES = {
    "flow_llin4": ("du", "dv", "u", "v", "m", "cu", "cv", "duc", "dvc", "ww", "wn", "we", "ws"),
    "flow_elin4": ("u", "v", "m", "cu", "cv", "duc", "dvc", "ww", "wn", "we", "ws"),
    "disp_llin4": ("du", "u", "cu", "duc", "ww", "wn", "we", "ws"),
    "pde4": ("x", "trace", "b", "ww", "wn", "we", "ws"),
    "flow_llin8": ("du", "dv", "u", "v", "m", "cu", "cv", "duc", "dvc",
                   "ww", "wnw", "wn", "wne", "we", "wse", "ws", "wsw"),
    "pde8": ("x", "trace", "b", "ww", "wnw", "wn", "wne", "we", "wse", "ws", "wsw"),
}
# the families of the first kernel (named entry points)
FLOW4 = ("flow_llin4", "flow_elin4")
# the families the windowed variant runs for the sharded solvers
WINDOWED = ("flow_llin4", "flow_elin4", "disp_llin4", "pde4", "flow_llin8")
LAUNCHES = {f"tiled_{family}{variant}": 0 for family in FIELD_NAMES
            for variant in ("", "_db", "_win", "_win_db")
            if family in WINDOWED or "_win" not in variant}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for family in FLOW4:
        names = FIELD_NAMES[family]
        fn = getattr(lib, f"tiled_{family}")
        fn.argtypes = [p] * (len(names) + 4) + [i] * 8 + [f, f, p]
        fn.restype = i
        fn = getattr(lib, f"tiled_{family}_win")
        fn.argtypes = [p] * (len(names) + 2) + [i] * 15 + [f, f, p]
        fn.restype = i
    lib.tiled_sor_family.argtypes = [i, p, p, p] + [i] * 9 + [f, f, p]
    lib.tiled_sor_family.restype = i
    lib.tiled_sor_family_win.argtypes = [i, p, p] + [i] * 16 + [f, f, p]
    lib.tiled_sor_family_win.restype = i
    lib.tiled_sor_slot_bytes.argtypes = [i, i, i, i, i]
    lib.tiled_sor_slot_bytes.restype = i
    lib.tiled_sor_threads.argtypes = [i, i, i, i, i]
    lib.tiled_sor_threads.restype = i
    lib.tiled_sor_error_string.argtypes = [i]
    lib.tiled_sor_error_string.restype = ctypes.c_char_p
    return lib


def _layout(family: str, window: bool = False):
    """The layout of a family the kernel (or its window) has; raises on
    any other."""
    from pde_tpu_torch.kernels import tiled

    if family not in FIELD_NAMES or (window and family not in WINDOWED):
        have = sorted(WINDOWED if window else FIELD_NAMES)
        raise ValueError(f"no tile kernel{' window' if window else ''} for {family!r}; "
                         f"it has {have}")
    return tiled.LAYOUTS[family]


def _systems(family: str, fields) -> list[tuple]:
    """The systems of a call: fields (H, W), or (B, H, W) with a field
    shared by the systems (H, W); each system's (H, W) fields."""
    names = FIELD_NAMES[family]
    if len(fields) != len(names):
        raise ValueError(f"tiled_{family} takes {len(names)} fields {names}, got {len(fields)}")
    batch = max([x.shape[0] for x in fields if x.ndim == 3] or [1])
    if any(x.ndim not in (2, 3) or (x.ndim == 3 and x.shape[0] != batch) for x in fields):
        raise ValueError(f"tiled_{family} takes (H, W) or ({batch}, H, W) fields, got "
                         f"{[tuple(x.shape) for x in fields]}")
    if batch > 1 and fields[0].ndim != 3:
        raise ValueError(f"tiled_{family}: the relaxed {names[0]} must be ({batch}, H, W)")
    return [tuple(x[b] if x.ndim == 3 else x for x in fields) for b in range(batch)]


def _check(family: str, systems, window=None, k: int = 0) -> tuple[int, int]:
    """The systems' (H, W); raises on what the kernel does not take, the
    device last (after the ``window`` of a chunk of ``k`` sweeps)."""
    layout = _layout(family, window is not None)
    names = FIELD_NAMES[family]
    if not 1 <= len(systems) <= layout.max_batch:
        raise ValueError(f"tiled_{family} takes 1 to {layout.max_batch} systems a launch, "
                         f"got {len(systems)}")
    shape, device = systems[0][0].shape, systems[0][0].device
    if len(shape) != 2 or shape[0] < 1 or shape[1] < 1:
        raise ValueError(f"tiled_{family} takes non-empty (H, W) fields, got {tuple(shape)}")
    for fields in systems:
        if len(fields) != len(names):
            raise ValueError(f"tiled_{family} takes {len(names)} fields {names}, "
                             f"got {len(fields)}")
        for name, x in zip(names, fields):
            if x.device != device or x.dtype != torch.float32 or x.shape != shape \
                    or not x.is_contiguous():
                raise ValueError(
                    f"tiled_{family}: {name} must be a contiguous float32 {tuple(shape)} "
                    f"tensor on {device}, got {x.dtype} {tuple(x.shape)} on {x.device} "
                    f"(contiguous={x.is_contiguous()})")
    if window is not None:
        from pde_tpu_torch.kernels.tiled import check_window

        check_window(shape, window, k, family)
    image = (window.gh, window.gw) if window is not None else tuple(shape)
    if layout.block_batch and any(s[f].data_ptr() != systems[0][f].data_ptr()
                                  for s in systems[1:] for f in range(3, len(names))):
        raise ValueError(f"tiled_{family} relaxes the channels over shared weights: "
                         f"{', '.join(names[3:])} must be (H, W)")
    if layout.fill and min(image) < 3:
        # W4: the border fill of a 1- or 2-px image is not the stripe
        # engine's; the global kernels take those shapes
        raise ValueError(f"tiled_{family} fills the border: it takes images of H, W >= 3, "
                         f"got {image[0]}x{image[1]}")
    if device.type != "cuda":
        raise ValueError(f"tiled_{family} takes CUDA tensors, got {device}")
    return shape[0], shape[1]


def _slots(family: str, k: int, tile_h: int, tile_w: int, slots, double_buffer: bool,
           batch: int) -> int:
    """The pairs a thread of the plan for ``batch`` systems (the fewest that
    fit where ``slots`` is None); raises where the kernel does not take the
    plan."""
    from pde_tpu_torch.kernels import tiled

    if k < 1 or tile_h < 1 or tile_w < 1:
        raise ValueError(f"tile plan k={k}, tile {tile_h}x{tile_w}: each must be >= 1")
    plan = tiled.make_plan(tile_h, tile_w, family, k, tile_h, tile_w, slots, double_buffer,
                           batch)
    if plan is None:
        raise ValueError(f"tiled_{family} takes no plan of k={k}, tile {tile_h}x{tile_w}, "
                         f"slots={slots} for {batch} systems (double_buffer={double_buffer})")
    return plan.slots


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*(0 if t is None else t.data_ptr() for t in tensors))


def _raise(lib, entry: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err} "
                           f"({lib.tiled_sor_error_string(err).decode()})")


def _outputs(fields, n_mut: int, shape):
    """The relaxed fields' outputs shaped ``shape`` (with a batch where the
    inputs have one), and each system's views of them."""
    outs = [fields[f].new_empty(fields[f].shape[:-2] + tuple(shape)) for f in range(n_mut)]
    batch = outs[0].shape[0] if outs[0].ndim == 3 else 1
    views = [tuple(o[b] if o.ndim == 3 else o for o in outs) for b in range(batch)]
    return outs, views


def tiled_sor(family: str, fields, iters: int, omega: float, k: int, tile_h: int, tile_w: int,
              double_buffer: bool = False, slots: int | None = None):
    """``iters`` red-black sweeps of ``family`` (``FIELD_NAMES``) on the
    card, in chunks of ``k`` over tiles of ``tile_h`` x ``tile_w``,
    ``slots`` pairs of pixels a thread (the fewest that fit by default);
    the same function as ``solvers/sor.py``'s ``sor_<family>``. ``fields``
    in the order of ``FIELD_NAMES[family]``, (H, W) or, for disp llin4,
    pde4 and pde8, (B, H, W) with fields the systems share (H, W). Returns
    the relaxed fields, shaped as given."""
    n_mut = _layout(family).n_mut
    systems = _systems(family, fields)
    slots = _slots(family, k, tile_h, tile_w, slots, double_buffer, len(systems))
    h, w = _check(family, systems)
    iters = max(int(iters), 0)  # as the plain loop: no sweep for iters <= 0
    if iters == 0:
        return tuple(fields[f].clone() for f in range(n_mut))
    outs, views = _outputs(fields, n_mut, (h, w))
    _run(family, systems, views, iters, omega, k, tile_h, tile_w, double_buffer, slots)
    return tuple(outs)


def tiled_sor_systems(family: str, systems, iters: int, omega: float, k: int, tile_h: int,
                      tile_w: int, slots: int | None = None):
    """As ``tiled_sor`` for a batch of systems given apart, each a tuple of
    (H, W) fields in the order of ``FIELD_NAMES[family]`` (disparity_sym's
    pair: one launch a chunk, never stacked). Returns each system's relaxed
    fields."""
    layout = _layout(family)
    systems = [tuple(s) for s in systems]
    h, w = _check(family, systems)
    slots = _slots(family, k, tile_h, tile_w, slots, False, len(systems))
    iters = max(int(iters), 0)
    if iters == 0:
        return [tuple(s[f].clone() for f in range(layout.n_mut)) for s in systems]
    views = [tuple(s[f].new_empty((h, w)) for f in range(layout.n_mut)) for s in systems]
    _run(family, systems, views, iters, omega, k, tile_h, tile_w, False, slots)
    return views


def _run(family, systems, outs, iters, omega, k, tile_h, tile_w, double_buffer, slots) -> None:
    """The launches of a checked call: ``outs`` each system's outputs."""
    from pde_tpu_torch.kernels import tiled

    lib = _lib()
    layout = tiled.LAYOUTS[family]
    h, w = systems[0][0].shape
    n_chunks = -(-iters // k)
    # the chunks ping-pong between out and tmp, ending in out
    tmp = [tuple(torch.empty_like(o) if n_chunks > 1 else None for o in out) for out in outs]
    device = systems[0][0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if family in FLOW4:
            (fields,), (out,), (tm,) = systems, outs, tmp
            entry = f"tiled_{family}"
            err = getattr(lib, entry)(
                *(x.data_ptr() for x in fields), *(o.data_ptr() for o in out),
                *(0 if t is None else t.data_ptr() for t in tm),
                h, w, iters, k, tile_h, tile_w, slots, int(bool(double_buffer)),
                float(omega), 1.0 - float(omega), stream)
        else:
            entry = "tiled_sor_family"
            err = lib.tiled_sor_family(
                layout.index, _ptrs([x for s in systems for x in s]),
                _ptrs([o for out in outs for o in out]), _ptrs([t for tm in tmp for t in tm]),
                len(systems), h, w, iters, k, tile_h, tile_w, slots, int(bool(double_buffer)),
                float(omega), 1.0 - float(omega), stream)
    _raise(lib, f"{entry} ({family})", err)
    LAUNCHES[f"tiled_{family}" + ("_db" if double_buffer else "")] += n_chunks


def tiled_sor_window(family: str, fields, iters: int, omega: float, window, tile_h: int,
                     tile_w: int, double_buffer: bool = False, slots: int | None = None):
    """One chunk of ``iters`` red-black sweeps of ``family`` on the card over
    the tiles of ``window.box`` (``kernels/tiled.Window``: the fields are
    part of an image), in tiles of ``tile_h`` x ``tile_w``, ``slots`` pairs
    a thread. Returns the box's part of the relaxed fields, as the same
    sweeps over the whole image give it."""
    layout = _layout(family, window=True)
    if tile_h < 1 or tile_w < 1:
        raise ValueError(f"tile {tile_h}x{tile_w}: each side must be >= 1")
    iters = max(int(iters), 0)
    systems = _systems(family, fields)
    slots = _slots(family, max(iters, 1), tile_h, tile_w, slots, double_buffer, len(systems))
    h, w = _check(family, systems, window, iters)
    i0, i1, j0, j1 = window.box
    if iters == 0:
        return tuple(fields[f][..., i0:i1, j0:j1].clone() for f in range(layout.n_mut))
    lib = _lib()
    outs, views = _outputs(fields, layout.n_mut, (i1 - i0, j1 - j0))
    device = fields[0].device
    geometry = (h, w, window.r0, window.c0, window.gh, window.gw, i0, j0, i1 - i0, j1 - j0,
                iters, tile_h, tile_w, slots)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if family in FLOW4:
            entry = f"tiled_{family}_win"
            err = getattr(lib, entry)(
                *(x.data_ptr() for x in systems[0]), *(o.data_ptr() for o in views[0]),
                *geometry, int(bool(double_buffer)), float(omega), 1.0 - float(omega), stream)
        else:
            entry = "tiled_sor_family_win"
            err = lib.tiled_sor_family_win(
                layout.index, _ptrs([x for s in systems for x in s]),
                _ptrs([o for view in views for o in view]), len(systems), *geometry,
                int(bool(double_buffer)), float(omega), 1.0 - float(omega), stream)
    _raise(lib, f"{entry} ({family})", err)
    LAUNCHES[f"tiled_{family}_win" + ("_db" if double_buffer else "")] += 1
    return tuple(outs)
