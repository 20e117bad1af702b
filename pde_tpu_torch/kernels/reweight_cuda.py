"""ctypes wrapper of the reweighting kernels (``csrc/reweight.cu``): the
robust data terms of the warping flows and of the disparity, and the
isotropic diffusion weights ``diffusion_weights_4``.

Takes CUDA tensors only and raises on anything else: the choice of the
plain version for CPU tensors is ``kernels/dispatch.py``'s. The library
is built and loaded at the first call, never at import.

``LAUNCHES`` counts the kernel launches this wrapper has made
(``"robust_flow"``, ``"robust_disp"``, ``"weights4"``): one a call.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from pde_tpu_torch.kernels import build

SOURCE = "reweight"
LAUNCHES = {"robust_flow": 0, "robust_disp": 0, "weights4": 0}
MAX_FIELDS = 8  # weights4's channels (csrc/reweight.cu kMaxFields)
# the second constancy term's kind (csrc/reweight.cu Snd)
SND_NONE, SND_FIRST, SND_GRADMAG = 0, 1, 2
# the derivative planes of each kind of term, in the kernel's order
FLOW_KEYS = {SND_FIRST: ("dt", "dx", "dy"), SND_GRADMAG: ("dxt", "dyt", "dxx", "dyy", "dxy")}
DISP_KEYS = {SND_FIRST: ("dt", "dx"), SND_GRADMAG: ("dxt", "dyt", "dxx", "dxy")}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    p, i, f, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.reweight_flow.argtypes = ([p, p, p, i, i] + [p] * 5 + [i] + [p] * 6 + [q]
                                  + [f] * 5 + [p] * 6)
    lib.reweight_flow.restype = i
    lib.reweight_disp.argtypes = ([p, p, i, i] + [p] * 4 + [i] + [p] * 3 + [q] + [f] * 5
                                  + [p] * 3)
    lib.reweight_disp.restype = i
    lib.reweight_weights4.argtypes = [ctypes.POINTER(p), ctypes.POINTER(p), i, i, i, i, i, f,
                                      p, p, p, p, p]
    lib.reweight_weights4.restype = i
    lib.reweight_error_string.argtypes = [i]
    lib.reweight_error_string.restype = ctypes.c_char_p
    return lib


def _check(fn: str, name: str, x, device, shape) -> None:
    if not torch.is_tensor(x) or x.device != device or x.dtype != torch.float32 \
            or tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        got = (f"{x.dtype} {tuple(x.shape)} on {x.device} (contiguous={x.is_contiguous()})"
               if torch.is_tensor(x) else type(x).__name__)
        raise ValueError(f"{fn}: {name} must be a contiguous float32 {tuple(shape)} tensor "
                         f"on {device}, got {got}")


def _field(fn: str, u) -> tuple[int, int]:
    """(H, W) of the (H, W) field ``u``."""
    if not torch.is_tensor(u) or u.ndim != 2:
        raise ValueError(f"{fn} takes (H, W) fields, got {getattr(u, 'shape', type(u))}")
    return tuple(u.shape)


def _on_card(fn: str, device) -> None:
    """Raise unless ``device`` (every input's, as checked) is a card."""
    if device.type != "cuda":
        raise ValueError(f"{fn} takes CUDA tensors, got {device}")


def _term(fn: str, term: dict, keys, device, hw) -> list:
    """The planes ``keys`` of a term's dict, each (C, H, W) with one C."""
    first = term.get(keys[0])
    if not torch.is_tensor(first) or first.ndim != 3:
        raise ValueError(f"{fn}: a term's {keys[0]} must be a (C, H, W) tensor")
    shape = (first.shape[0], *hw)
    for k in keys:
        _check(fn, k, term.get(k), device, shape)
    return [term[k] for k in keys]


def _snd_kind(t2, gradmag: bool) -> int:
    return SND_NONE if t2 is None else (SND_GRADMAG if gradmag else SND_FIRST)


def _inv_square(x: float) -> float:
    """float32(1 / x^2): a float32 tensor over the Python scalar x^2 on the
    card is, in PyTorch, a product with the scalar's reciprocal, taken in
    double and rounded to float32."""
    return float(np.float32(1.0 / x**2))


def _raise_on(lib, fn: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {err} "
                           f"({lib.reweight_error_string(err).decode()})")


def _ptr(x) -> int | None:
    return None if x is None else x.data_ptr()


def robust_flow(t1: dict, t2: dict | None, u, v, du, dv, us_ap, vs_ap, as_diff: float,
                alpha: float, b1: float, b2: float, gamma: float, gradmag: bool):
    """The channel-summed (M, Cu, Cv, Du, Dv) of one reweighting of the
    warping flows on the card; the same function as
    ``ops/robust.py::robust_terms_flow``. t1 holds the first term's
    ``dt, dx, dy`` (C1, H, W); t2 the second's ``dxt, dyt, dxx, dyy, dxy``
    (``gradmag``) or ``dt, dx, dy``, or is None. u, v, du, dv and the
    priors us_ap, vs_ap (each may be None) are (H, W). Returns five new
    (H, W) tensors."""
    fn = "robust_flow"
    hw = _field(fn, u)
    dev = u.device
    for name, x in (("v", v), ("du", du), ("dv", dv), ("us_ap", us_ap), ("vs_ap", vs_ap)):
        if x is not None or name in ("v", "du", "dv"):
            _check(fn, name, x, dev, hw)
    snd = _snd_kind(t2, gradmag)
    first = _term(fn, t1, FLOW_KEYS[SND_FIRST], dev, hw)
    second = _term(fn, t2, FLOW_KEYS[snd], dev, hw) if snd else []
    c2 = second[0].shape[0] if second else 0
    _on_card(fn, dev)
    s = [_ptr(x) for x in second] + [None] * (5 - len(second))
    lib = _lib()
    out = [torch.empty(hw, dtype=torch.float32, device=dev) for _ in range(5)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.reweight_flow(*(x.data_ptr() for x in first), first[0].shape[0], snd, *s, c2,
                                u.data_ptr(), v.data_ptr(), du.data_ptr(), dv.data_ptr(),
                                _ptr(us_ap), _ptr(vs_ap), hw[0] * hw[1], alpha, b1, b2, gamma,
                                _inv_square(as_diff), *(o.data_ptr() for o in out), stream)
    _raise_on(lib, fn, err)
    LAUNCHES["robust_flow"] += 1
    return tuple(out)


def robust_disp(d1: dict, d2: dict | None, u, du, us_ap, as_diff: float, alpha: float,
                b1: float, b2: float, gamma: float, gradmag: bool):
    """(Cu, Du) of one reweighting of the disparity on the card; the same
    function as ``ops/robust.py::robust_terms_disp``. d1 holds the first
    term's ``dt, dx`` (C1, H, W); d2 the second's ``dxt, dyt, dxx, dxy``
    (``gradmag``) or ``dt, dx``, or is None. u, du and the prior us_ap
    (None for none) are (H, W). Returns two new (H, W) tensors."""
    fn = "robust_disp"
    hw = _field(fn, u)
    dev = u.device
    _check(fn, "du", du, dev, hw)
    if us_ap is not None:
        _check(fn, "us_ap", us_ap, dev, hw)
    snd = _snd_kind(d2, gradmag)
    first = _term(fn, d1, DISP_KEYS[SND_FIRST], dev, hw)
    second = _term(fn, d2, DISP_KEYS[snd], dev, hw) if snd else []
    c2 = second[0].shape[0] if second else 0
    _on_card(fn, dev)
    s = [_ptr(x) for x in second] + [None] * (4 - len(second))
    lib = _lib()
    out = [torch.empty(hw, dtype=torch.float32, device=dev) for _ in range(2)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.reweight_disp(*(x.data_ptr() for x in first), first[0].shape[0], snd, *s, c2,
                                u.data_ptr(), du.data_ptr(), _ptr(us_ap), hw[0] * hw[1], alpha,
                                b1, b2, gamma / alpha, _inv_square(as_diff),
                                *(o.data_ptr() for o in out), stream)
    _raise_on(lib, fn, err)
    LAUNCHES["robust_disp"] += 1
    return tuple(out)


def weights4(fields, increments, eps: float, combine: str, zero_borders: bool):
    """``diffusion_weights_4`` on the card: (wW, wN, wE, wS) of the
    sequence of (H, W) planes ``fields`` (1 to ``MAX_FIELDS``), each plus
    its plane of ``increments`` where that is not None, combined by
    ``combine`` ("sum", else max). Returns four new (H, W) tensors."""
    fn = "weights4"
    fields = list(fields)
    if not 1 <= len(fields) <= MAX_FIELDS:
        raise ValueError(f"{fn} takes 1 to {MAX_FIELDS} field planes, got {len(fields)}")
    hw = _field(fn, fields[0])
    dev = fields[0].device
    for k, x in enumerate(fields):
        _check(fn, f"fields[{k}]", x, dev, hw)
    if increments is not None:
        increments = list(increments)
        if len(increments) != len(fields):
            raise ValueError(f"{fn}: {len(increments)} increments for {len(fields)} fields")
        for k, x in enumerate(increments):
            _check(fn, f"increments[{k}]", x, dev, hw)
    _on_card(fn, dev)
    c = len(fields)
    ptrs = (ctypes.c_void_p * c)(*(x.data_ptr() for x in fields))
    incs = None if increments is None else (ctypes.c_void_p * c)(
        *(x.data_ptr() for x in increments))
    lib = _lib()
    out = [torch.empty(hw, dtype=torch.float32, device=dev) for _ in range(4)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.reweight_weights4(ptrs, incs, c, hw[0], hw[1], int(combine != "sum"),
                                    int(bool(zero_borders)), eps,
                                    *(o.data_ptr() for o in out), stream)
    _raise_on(lib, fn, err)
    LAUNCHES["weights4"] += 1
    return tuple(out)
