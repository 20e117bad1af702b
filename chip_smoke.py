#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pde_tpu_torch``) on one NVIDIA GPU and check it.

Run from the repository root, on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py [--seed N]

Phases; any failure exits non-zero, and nothing falls back to the CPU:

1. Require CUDA; print the card's name and power limit (``nvidia-smi``).
2. Build every CUDA source of the port from ``pde_tpu_torch/csrc``, one
   ``nvcc`` per source, all started together (timed); TF32 is switched
   off for matmuls and cuDNN.
3. Each kernel against its plain PyTorch version on the card, at the
   solvers' shapes, with and without NaN data (the 8-neighbour sweeps with
   diagonal weights of both signs; the tridiagonal solve at line lengths 1
   to 1024 along both axes, whole and by zebra parity, with batched and
   shared coefficients); both timed with CUDA events in turns, beside the
   least time the card could take (the bound) and the kernel's device time
   under ``torch.profiler``.
4. ``flow_nd`` with default parameters on a 3-channel 480x640 pair whose
   second frame is the first shifted by a known sub-pixel amount. The flow
   must be finite and recover the shift, the kernel must have been
   launched exactly as often as the pyramid implies, and the plain path on
   the card must agree. A small pair is also held against the port's CPU
   path, which the CPU tests hold against the JAX package.
5. ``flow_nd_sequence`` on a 3-frame 240x320 clip against per-pair
   ``flow_nd``.
6. ``disparity_nd``, default parameters, on a 3x480x640 stereo pair with a
   known horizontal shift: as phase 4, with the interior-update kernel.
7. ``disparity_sym``, default parameters, on the same kind of pair: both
   fields recover the shift with opposite signs, each solve of the pair is
   one kernel call with a batch of 2.
8. ``tv_denoise4``, default parameters, on a noisy piecewise-flat
   3x480x640 image: exact launches, kernel path against plain path, and
   the noise in a flat patch must fall.
9. ``flow_hs`` with default parameters (the line-implicit PCG, every line
   solve the tridiagonal kernel) on the 3x480x640 pair of phase 4: exact
   launches, finite flow; a small pair against the CPU path, and the
   kernel path against the plain path at a reduced size.
10. ``flow_hs`` with ``solver=1`` (the elin4 kernel): exact launches,
    kernel path against plain path, and a 1-px shift recovered at 400
    sweeps on a 48x56 pair.
11. ``diffusion4``, default parameters, on a noisy 3x480x640 image: exact
    launches, kernel path against plain path, the noise must fall.
12. ``flow_ad`` (anisotropic tensor flow, the llin8 kernel) with default
    parameters on the pair of phase 4: as phase 4.
13. ``tv_denoise8`` (the pde8 kernel), default parameters, on the noisy
    image of phase 8: as phase 8.
14. ``solver=2`` in ``flow_nd``, ``disparity_nd``, ``disparity_sym``,
    ``tv_denoise4``, ``flow_ad`` and ``tv_denoise8`` at 3x480x640: exact
    launches, the shift recovered or the noise reduced, the kernel path
    against the plain path at a reduced size.

Every phase from 4 on sets every kernel's launch count to 0 just before it
drives its entry point and reads all counts just after, and profiles one
more warm frame for the card's busy time. The last lines are
the card's name and power limit, a JSON object of the kernels (launches,
errors, times, bounds) and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

SOR_TOL = 1e-5       # max-abs, kernel vs plain, unit-scale fields (FMA contraction moves ulps)
EXACT_TOL = 1e-6     # max-abs, kernel vs plain: every float op rounded alone in the plain order (0 expected)
FLOW_TOL = 1e-3      # px, mean |Δflow| between two paths of the whole model
SHIFT_TOL = 0.3      # px, median interior flow vs the known shift
DISP_SHIFT_TOL = 0.5  # px, median interior disparity vs the known shift
TV_REL_TOL = 1e-4    # max |Δu| over the image's value range, kernel vs plain path
MAIN_SHAPE = (3, 480, 640)
MAIN_SHIFT = (0.4, 1.3)  # (dy, dx) in px: the second frame moves right and down
DISP_SHIFT = (0.0, 2.6)  # the stereo pair's second frame moves right
SEQ_SHAPE = (3, 240, 320)
SMALL_SHAPE = (3, 36, 44)  # card vs the CPU path
# the main path's finest level and odd neighbours, a coarse level, and
# degenerate shapes where every pixel is an edge pixel
SOR_SHAPES = [(1, 1), (1, 9), (9, 1), (37, 53), (480, 640), (481, 641), (1024, 1024)]
# the interior-update kernels take H, W >= 2: 2xN and 3x3 have no or one
# interior pixel, so their border fill is all there is
INTERIOR_SHAPES = [(2, 5), (3, 3), (37, 53), (480, 640), (481, 641), (1024, 1024)]
TIME_SHAPES = [(481, 641), (1024, 1024)]  # the first one is reported as the kernel's ms
# tridiagonal systems, solved along both axes: line lengths 1, 2, 3, 7, 33,
# 480, 481, 640, 641 and 1024 in each direction
TRIDIAG_SHAPES = [(1, 7), (7, 1), (2, 3), (3, 2), (7, 33), (33, 7), (480, 640), (481, 641),
                  (640, 480), (1024, 1024)]
# the plain scan costs ~5 launches per line step on the card, so the kernel
# path of a line-implicit model is held against its plain path at this size
PLAIN_SHAPE = (3, 32, 40)

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32 outside the
# tensor cores; the bound of a call is the larger of its two times
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# float operations per relaxed pixel and sweep (the kernels' arithmetic)
FLOPS_PER_PX = {"flow_llin4_sor": 40, "flow_elin4_sor": 30, "disp_llin4_sor": 23,
                "pde4_sor": 16, "flow_llin8_sor": 64, "pde8_sor": 28}
# the kernels whose every float operation is rounded alone in the plain
# version's order, held to EXACT_TOL; the others contract to FMA (SOR_TOL)
EXACT = ("tridiag", "pde8_sor")
# float operations per line element of one whole tridiagonal solve
TRIDIAG_FLOPS_PER_PX = 8
# bytes per pixel that each TPU kernel row of PERF.md's table must move at
# least (float32 inputs read once, outputs written once), as that row's
# main-path caller hands them over
ROW_BYTES_PER_PX = {
    "1-2 llin4 (13 in, 2 out)": (13 + 2) * 4,
    "3 elin4 (11 in, 2 out)": (11 + 2) * 4,
    "4 llin8 (17 in, 2 out)": (17 + 2) * 4,
    "5 disp llin4 B=1 (8 in, 1 out)": (8 + 1) * 4,
    "6a pde4 C=3, shared weights (13 in, 3 out)": (3 * 3 + 4 + 3) * 4,
    "6b pde8 C=3, shared weights (17 in, 3 out)": (3 * 3 + 8 + 3) * 4,
    "8 tridiagonal solve (4 in, 1 out)": (4 + 1) * 4,
}
# the __global__ functions of pde_tpu_torch/csrc/*.cu
OWN_KERNELS = {"prepare_kernel", "sweep_kernel", "prepare8_kernel", "sweep8_kernel",
               "disp_color_kernel", "pde4_color_kernel", "pde8_color_kernel", "border_kernel",
               "border_small_kernel", "thomas_kernel", "factor_kernel", "solve_kernel"}
W8 = ("ww", "wnw", "wn", "wne", "we", "wse", "ws", "wsw")


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` calls (CUDA events)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(kern, plain, reps: int = 50, plain_reps: int | None = None):
    """(kernel ms, plain ms, the four readings) timed plain, kernel, kernel,
    plain on one card."""
    plain_reps = plain_reps or reps
    p1, k1, k2, p2 = (cuda_ms(fn, r) for fn, r in ((plain, plain_reps), (kern, reps),
                                                   (kern, reps), (plain, plain_reps)))
    return (k1 + k2) / 2, (p1 + p2) / 2, (p1, k1, k2, p2)


def device_profile(fn, calls: int = 1):
    """What ``calls`` calls of ``fn`` keep the card busy with, from
    ``torch.profiler``: (device ms per call, device operations per call,
    device ms per call in the port's own kernels, [(name, device ms per
    call)] of the five largest). Device time is the self time of every
    kernel and copy, so gaps between them do not count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    # the device's own events; a host operator also carries the time of the
    # kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    events.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / calls
    n_ops = sum(e.count for e in events) / calls
    own = [e for e in events
           if (m := re.search(r"\(anonymous namespace\)::(\w+)", e.key))
           and m.group(1) in OWN_KERNELS]
    own_ms = sum(e.self_device_time_total for e in own) / 1e3 / calls
    top = [(e.key, e.self_device_time_total / 1e3 / calls) for e in events[:5]]
    return busy_ms, n_ops, own_ms, top


def print_profile(what: str, wall_s: float, prof) -> None:
    busy_ms, n_ops, own_ms, top = prof
    print(f"  {what} under torch.profiler: device busy {busy_ms:.3f} ms of a "
          f"{wall_s * 1e3:.1f} ms warm frame ({100 * busy_ms / (wall_s * 1e3):.1f}%), "
          f"{n_ops:.0f} device operations; the port's CUDA kernels {own_ms:.3f} ms",
          flush=True)
    for name, ms in top:
        print(f"    {ms:9.3f} ms  {name[:90]}", flush=True)


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def card_device() -> torch.device:
    return torch.device("cuda", 0)


def unit_field(rng, name: str, shape) -> np.ndarray:
    """Unit-scale solver coefficients, as the CPU tests make them; the
    diagonal weights of the 8-neighbour stencil take both signs."""
    if name in ("duc", "dvc", "trace"):
        return rng.random(shape) + 1.0
    if name == "m":
        return rng.random(shape) * 0.01
    if name in ("wnw", "wne", "wse", "wsw"):
        return rng.random(shape) * 0.3 - 0.15
    if name.startswith("w"):
        return rng.random(shape) + 0.1
    return rng.random(shape) * 0.2


def to_dev(fields, nan_names, rng, dev):
    out = []
    for n, x in fields.items():
        if n in nan_names:
            x = np.where(rng.random(x.shape) < 0.05, np.nan, x)
        out.append(torch.from_numpy(x.astype(np.float32)).to(dev))
    return out


def sor_fields(rng, h, w, nan: bool, dev):
    """llin4 solver fields; 5% NaN in Cu and Du when ``nan``."""
    names = ("u", "v", "du", "dv", "m", "cu", "cv", "duc", "dvc", "ww", "wn", "we", "ws")
    return to_dev({n: unit_field(rng, n, (h, w)) for n in names},
                  ("cu", "duc") if nan else (), rng, dev)


def elin_fields(rng, h, w, nan: bool, dev):
    """elin4 solver fields; 5% NaN in Cu and Du when ``nan``."""
    names = ("u", "v", "m", "cu", "cv", "duc", "dvc", "ww", "wn", "we", "ws")
    return to_dev({n: unit_field(rng, n, (h, w)) for n in names},
                  ("cu", "duc") if nan else (), rng, dev)


def llin8_fields(rng, h, w, nan: bool, dev):
    """llin8 solver fields; 5% NaN in Cu and Du when ``nan``."""
    names = ("u", "v", "du", "dv", "m", "cu", "cv", "duc", "dvc") + W8
    return to_dev({n: unit_field(rng, n, (h, w)) for n in names},
                  ("cu", "duc") if nan else (), rng, dev)


def pde8_fields(rng, c, h, w, nan: bool, dev):
    """pde8 fields as tv_denoise8 hands them over: X, TRACE, B of (H, W)
    for c == 1 else (c, H, W), one shared (H, W) plane per weight, TRACE
    above the weights' absolute sum; 5% NaN in TRACE when ``nan``."""
    shape = (h, w) if c == 1 else (c, h, w)
    f = {n: unit_field(rng, n, shape) for n in ("x", "trace", "b")}
    f.update({n: unit_field(rng, n, (h, w)) for n in W8})
    f["trace"] = f["trace"] + sum(np.abs(f[n]) for n in W8)
    return to_dev(f, ("trace",) if nan else (), rng, dev)


def tridiag_fields(rng, shape, dev, shared=False):
    """A diagonally dominant tridiagonal system (a, b, c, d) of ``shape``,
    as the CPU tests make them; with ``shared``, a and c are one (H, W)
    plane for the leading dims (pcg_pde4's weights)."""
    a = rng.random(shape) * 0.4 - 0.5
    c = rng.random(shape) * 0.4 - 0.5
    b = np.abs(a) + np.abs(c) + rng.random(shape) + 0.5
    d = rng.random(shape) * 2.0 - 1.0
    if shared:
        a, c = a[0], c[0]
    return [torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)
            for x in (a, b, c, d)]


def disp_fields(rng, b, h, w, nan: bool, dev):
    """disp llin4 fields, (H, W) for b == 1 else (b, H, W); 5% NaN in Cu
    and Du when ``nan``."""
    shape = (h, w) if b == 1 else (b, h, w)
    names = ("u", "du", "cu", "duc", "ww", "wn", "we", "ws")
    return to_dev({n: unit_field(rng, n, shape) for n in names},
                  ("cu", "duc") if nan else (), rng, dev)


def pde4_fields(rng, c, h, w, nan: bool, dev):
    """pde4 fields as tv_denoise4 hands them over: X, TRACE, B of (H, W)
    for c == 1 else (c, H, W), one shared (H, W) plane per weight, TRACE
    above the weights' sum; 5% NaN in TRACE when ``nan``."""
    shape = (h, w) if c == 1 else (c, h, w)
    f = {n: unit_field(rng, n, shape) for n in ("x", "trace", "b")}
    f.update({n: unit_field(rng, n, (h, w)) for n in ("ww", "wn", "we", "ws")})
    f["trace"] = f["trace"] + f["ww"] + f["wn"] + f["we"] + f["ws"]
    return to_dev(f, ("trace",) if nan else (), rng, dev)


def shifted_frames(rng, shape, shifts):
    """A seeded smooth colour texture and copies of it translated by each
    (dy, dx) in ``shifts`` (cubic-spline resampling), in 0..255."""
    import scipy.ndimage as ndi

    c, h, w = shape
    pad = 24
    base = ndi.gaussian_filter(rng.random((c, h + 2 * pad, w + 2 * pad)), (0, 2.5, 2.5))
    base = (base - base.min()) / (base.max() - base.min()) * 255.0
    frames = [ndi.shift(base, (0, dy, dx), order=3, mode="nearest") for dy, dx in shifts]
    return [f[:, pad:-pad, pad:-pad].astype(np.float32) for f in frames]


def noisy_blocks(rng, shape):
    """A piecewise-flat image (flat background and two blocks per channel,
    in 0..1) plus N(0, 0.1) noise."""
    c, h, w = shape
    clean = np.zeros(shape, np.float32)
    for k in range(c):
        clean[k] = 0.2 + 0.2 * k
        clean[k, h // 4:3 * h // 4, w // 4:w // 2] = 0.8 - 0.1 * k
        clean[k, h // 8:h // 3, 5 * w // 8:7 * w // 8] = 0.5
    return clean + 0.1 * rng.standard_normal(shape).astype(np.float32)


def partial_pyramid_levels(shape, scl: float, scl_factor: float) -> int:
    """Levels of tv_denoise's partial pyramid (models/tv_denoise.py's stop
    rule) for an image of ``shape``."""
    levels, (h, w) = 1, shape[-2:]
    while True:
        h, w = int(np.ceil(h * scl_factor)), int(np.ceil(w * scl_factor))
        levels += 1
        if h <= np.ceil(shape[-2] * scl) or w <= np.ceil(shape[-1] * scl):
            return levels


def mean_flow_diff(a, b) -> float:
    return float(torch.hypot(a[0] - b[0], a[1] - b[1]).mean())


def timed(fn):
    """(fn's result, host seconds until the card is done)."""
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.time()

    phase("1 device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    if not (HERE / "pde_tpu_torch" / "__init__.py").is_file():
        fail(f"pde_tpu_torch not found beside {Path(__file__).name}: run it from the repository")
    sys.path.insert(0, str(HERE))
    from pde_tpu_torch.core.pyramid import pyramid_scales
    from pde_tpu_torch.kernels import build, dispatch, interior_cuda, sor_cuda, tdma_cuda
    from pde_tpu_torch.models.disparity import DisparityParams, disparity_nd
    from pde_tpu_torch.models.disparity_sym import DisparitySymParams, disparity_sym
    from pde_tpu_torch.models.diffusion import Diffusion4Params, diffusion4
    from pde_tpu_torch.models.flow_ad import FlowADParams, flow_ad
    from pde_tpu_torch.models.flow_hs import FlowHSParams, flow_hs
    from pde_tpu_torch.models.flow_nd import FlowNDParams, flow_nd, flow_nd_sequence
    from pde_tpu_torch.models.tv_denoise import (TVDenoise4Params, TVDenoise8Params,
                                                 tv_denoise4, tv_denoise8)
    from pde_tpu_torch.solvers import sor as plain_sor
    from pde_tpu_torch.solvers import tdma as plain_tdma

    dev = card_device()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
          f"count {torch.cuda.device_count()}", flush=True)

    def reset_counts():
        for launches in (sor_cuda.LAUNCHES, interior_cuda.LAUNCHES, tdma_cuda.LAUNCHES):
            for k in launches:
                launches[k] = 0

    def counts():
        return {"flow_llin4_sor": sor_cuda.LAUNCHES["flow_llin4"],
                "flow_elin4_sor": sor_cuda.LAUNCHES["flow_elin4"],
                "flow_llin8_sor": sor_cuda.LAUNCHES["flow_llin8"],
                "disp_llin4_sor": interior_cuda.LAUNCHES["disp_llin4"],
                "pde4_sor": interior_cuda.LAUNCHES["pde4"],
                "pde8_sor": interior_cuda.LAUNCHES["pde8"],
                **{f"tridiag_{k}": n for k, n in tdma_cuda.LAUNCHES.items()}}

    def check_counts(what: str, expected: dict) -> None:
        got = counts()
        want = {k: expected.get(k, 0) for k in got}
        if got != want:
            fail(f"{what}: kernel launches {got}, expected {want}")
        launched = {k: n for k, n in got.items() if n} or "none"
        print(f"  kernel launches {launched}, as expected; every other kernel 0", flush=True)

    phase("2 build")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    t0 = time.time()
    sources = (sor_cuda.SOURCE, interior_cuda.SOURCE, tdma_cuda.SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(partial(build.build, verbose=True), sources))
    sor_cuda._lib()
    interior_cuda._lib()
    tdma_cuda._lib()
    print(f"built {', '.join(str(p.relative_to(HERE)) for p in libs)} "
          f"in {time.time() - t0:.1f} s", flush=True)

    phase("3 kernels vs plain")
    rng = np.random.default_rng(args.seed)
    max_err = {}

    def hold(name, got, want, label):
        torch.cuda.synchronize()
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        # a 1x1 system with a NaN Du has a zero divisor: the plain version
        # gives a non-finite value there, and the kernel must give it too
        for g, w_ in zip(got, want):
            if not torch.equal(torch.isfinite(g), torch.isfinite(w_)):
                fail(f"{name}: non-finite solver output at other pixels than the plain "
                     f"version's at {label}")
        err = max(float(torch.where(torch.isfinite(w_), g - w_, 0.0).abs().max())
                  for g, w_ in zip(got, want))
        tol = EXACT_TOL if name in EXACT else SOR_TOL
        if err > tol:
            fail(f"{name} disagrees with plain at {label}: {err} > {tol}")
        max_err[name] = max(max_err.get(name, 0.0), err)
        return err

    for h, w in SOR_SHAPES:
        for iters in (4, 5):
            for nan in (False, True):
                fields = sor_fields(rng, h, w, nan, dev)
                err = hold("flow_llin4_sor", sor_cuda.flow_llin4_sor(*fields, iters, 1.9),
                           plain_sor.sor_flow_llin4(*fields, iters, 1.9),
                           f"{h}x{w} iters={iters} nan={nan}")
                print(f"  flow_llin4_sor {h}x{w} iters={iters} nan={nan}: "
                      f"max_abs_err={err:.3g}", flush=True)
    for h, w in INTERIOR_SHAPES:
        for iters in (4, 5):
            for nan in (False, True):
                errs = []
                for b in (1, 2):
                    fields = disp_fields(rng, b, h, w, nan, dev)
                    errs.append(hold("disp_llin4_sor",
                                     interior_cuda.disp_llin4_sor(*fields, iters, 1.9),
                                     plain_sor.sor_disp_llin4(*fields, iters, 1.9),
                                     f"B={b} {h}x{w} iters={iters} nan={nan}"))
                for c in (1, 3):
                    fields = pde4_fields(rng, c, h, w, nan, dev)
                    errs.append(hold("pde4_sor", interior_cuda.pde4_sor(*fields, iters, 1.75),
                                     plain_sor.sor_pde4(*fields, iters, 1.75),
                                     f"C={c} {h}x{w} iters={iters} nan={nan}"))
                print(f"  {h}x{w} iters={iters} nan={nan}: max_abs_err disp B=1,2 "
                      f"{errs[0]:.3g}, {errs[1]:.3g}; pde4 C=1,3 {errs[2]:.3g}, "
                      f"{errs[3]:.3g}", flush=True)

    for h, w in SOR_SHAPES:
        for iters in (4, 5):
            for nan in (False, True):
                fields = llin8_fields(rng, h, w, nan, dev)
                err = hold("flow_llin8_sor", sor_cuda.flow_llin8_sor(*fields, iters, 1.9),
                           plain_sor.sor_flow_llin8(*fields, iters, 1.9),
                           f"{h}x{w} iters={iters} nan={nan}")
                print(f"  flow_llin8_sor {h}x{w} iters={iters} nan={nan}: "
                      f"max_abs_err={err:.3g}", flush=True)
    for h, w in INTERIOR_SHAPES:
        for iters in (4, 5):
            for nan in (False, True):
                errs = []
                for c in (1, 3):
                    fields = pde8_fields(rng, c, h, w, nan, dev)
                    errs.append(hold("pde8_sor", interior_cuda.pde8_sor(*fields, iters, 1.75),
                                     plain_sor.sor_pde8(*fields, iters, 1.75),
                                     f"C={c} {h}x{w} iters={iters} nan={nan}"))
                print(f"  pde8_sor {h}x{w} iters={iters} nan={nan}: max_abs_err C=1,3 "
                      f"{errs[0]:.3g}, {errs[1]:.3g}", flush=True)

    for h, w in SOR_SHAPES:
        for iters in (4, 5):
            for nan in (False, True):
                fields = elin_fields(rng, h, w, nan, dev)
                err = hold("flow_elin4_sor", sor_cuda.flow_elin4_sor(*fields, iters, 1.9),
                           plain_sor.sor_flow_elin4(*fields, iters, 1.9),
                           f"{h}x{w} iters={iters} nan={nan}")
                print(f"  flow_elin4_sor {h}x{w} iters={iters} nan={nan}: "
                      f"max_abs_err={err:.3g}", flush=True)

    def hold_tridiag(a, b, c, d, label):
        """Whole solves and zebra parity solves along both axes, kernel
        against plain on the same inputs."""
        errs = []
        for axis in (-2, -1):
            vertical = axis == -2
            with dispatch.plain_solvers():
                want = dispatch.thomas_solve(a, b, c, d, axis)
                facs = dispatch.line_factors(a, b, c, vertical)
                want_par = [dispatch.line_solve(facs, d, par, vertical) for par in (0, 1)]
            errs.append(hold("tridiag", tdma_cuda.thomas_solve(a, b, c, d, axis), want,
                             f"{label} axis={axis} whole"))
            fac = tdma_cuda.tridiag_factor(a, b, c, axis)
            errs.append(hold("tridiag", tdma_cuda.tridiag_solve(fac, d), want,
                             f"{label} axis={axis} factor/replay"))
            for par in (0, 1):
                got = tdma_cuda.tridiag_solve(fac, d, par)
                if got.shape != want_par[par].shape:
                    fail(f"tridiag parity {par} at {label} axis={axis}: shape "
                         f"{tuple(got.shape)}, plain {tuple(want_par[par].shape)}")
                if got.numel():
                    errs.append(hold("tridiag", got, want_par[par],
                                     f"{label} axis={axis} parity={par}"))
        print(f"  tridiag {label}: max_abs_err {max(errs):.3g} over {len(errs)} solves "
              f"(whole, factor/replay, parity 0 and 1, both axes)", flush=True)

    for shape in TRIDIAG_SHAPES:
        hold_tridiag(*tridiag_fields(rng, shape, dev), f"{shape[0]}x{shape[1]}")
    # pcg_pde4's coefficients: (H, W) off-diagonals shared by a (3, H, W)
    # diagonal; the symmetric pair's: a batch of 2 with its own planes
    hold_tridiag(*tridiag_fields(rng, (3,) + MAIN_SHAPE[1:], dev, shared=True),
                 f"{MAIN_SHAPE} shared a, c")
    hold_tridiag(*tridiag_fields(rng, (2, 481, 641), dev), "(2, 481, 641)")
    # diffusion4's: every coefficient one shared plane, d (3, H, W)
    a, b, c, d = tridiag_fields(rng, (3,) + MAIN_SHAPE[1:], dev)
    hold_tridiag(a[0], b[0], c[0], d, f"{MAIN_SHAPE} shared a, b, c")

    times, bounds = {}, {}
    for h, w in TIME_SHAPES:
        px = h * w
        cases = {
            # (kernel, plain, bytes each input read once and each output
            # written once, relaxed pixels per sweep)
            "flow_llin4_sor": (sor_cuda.flow_llin4_sor, plain_sor.sor_flow_llin4,
                               sor_fields(rng, h, w, True, dev), 1.9, (13 + 2) * 4 * px, px),
            # disparity_nd's call: B = 1
            "disp_llin4_sor": (interior_cuda.disp_llin4_sor, plain_sor.sor_disp_llin4,
                               disp_fields(rng, 1, h, w, True, dev), 1.9, (8 + 1) * 4 * px,
                               (h - 2) * (w - 2)),
            # tv_denoise4's call: C = 3 channels, shared weights
            "pde4_sor": (interior_cuda.pde4_sor, plain_sor.sor_pde4,
                         pde4_fields(rng, 3, h, w, True, dev), 1.75, (4 * 3 + 4) * 4 * px,
                         3 * (h - 2) * (w - 2)),
            # flow_hs's call with solver=1: every pixel relaxed
            "flow_elin4_sor": (sor_cuda.flow_elin4_sor, plain_sor.sor_flow_elin4,
                               elin_fields(rng, h, w, True, dev), 1.9, (11 + 2) * 4 * px, px),
            # flow_ad's call: every pixel relaxed
            "flow_llin8_sor": (sor_cuda.flow_llin8_sor, plain_sor.sor_flow_llin8,
                               llin8_fields(rng, h, w, True, dev), 1.9, (17 + 2) * 4 * px, px),
            # tv_denoise8's call: C = 3 channels, shared weights
            "pde8_sor": (interior_cuda.pde8_sor, plain_sor.sor_pde8,
                         pde8_fields(rng, 3, h, w, True, dev), 1.75, (4 * 3 + 8) * 4 * px,
                         3 * (h - 2) * (w - 2)),
        }
        for name, (kern, plain, fields, omega, nbytes, relaxed) in cases.items():
            k_ms, p_ms, turns = in_turns(partial(kern, *fields, 4, omega),
                                         partial(plain, *fields, 4, omega))
            b_ms, b_by = bound(nbytes, 4 * relaxed * FLOPS_PER_PX[name])
            dev_ms, dev_ops, _, _ = device_profile(partial(kern, *fields, 4, omega), 20)
            times[(name, h, w)] = (k_ms, p_ms)
            bounds[(name, h, w)] = (b_ms, b_by)
            print(f"  time {name} {h}x{w} iters=4 per call: kernel {turns[1]:.4f} / "
                  f"{turns[2]:.4f} ms (device busy {dev_ms:.4f} ms in {dev_ops:.0f} "
                  f"operations), plain {turns[0]:.4f} / {turns[3]:.4f} ms, "
                  f"bound {b_ms:.4f} ms ({b_by})", flush=True)

    # one whole tridiagonal solve (diffusion4's call) along each axis, and
    # one zebra parity solve with a factor (the PCG preconditioner's call)
    for h, w in TIME_SHAPES:
        a, b, c, d = tridiag_fields(rng, (h, w), dev)
        b_ms, b_by = bound((4 + 1) * 4 * h * w, TRIDIAG_FLOPS_PER_PX * h * w)
        for axis in (-2, -1):
            fac = tdma_cuda.tridiag_factor(a, b, c, axis)
            cases = {
                "whole": (partial(tdma_cuda.thomas_solve, a, b, c, d, axis),
                          partial(plain_tdma.thomas_solve, a, b, c, d, axis), b_ms),
                "parity 0": (partial(tdma_cuda.tridiag_solve, fac, d, 0),
                             partial(plain_tdma.line_solve,
                                     plain_tdma.line_factors(a, b, c, axis == -2), d, 0,
                                     axis == -2),
                             # half the lines: a, denom, cp and d of them read, x written
                             bound((4 + 1) * 4 * h * w / 2, 0)[0]),
            }
            for what, (kern, plain, case_bound) in cases.items():
                k_ms, p_ms, turns = in_turns(kern, plain, reps=20, plain_reps=2)
                dev_ms, dev_ops, _, _ = device_profile(kern, 10)
                if what == "whole":
                    times[("tridiag", axis, h, w)] = (k_ms, p_ms)
                    bounds[("tridiag", axis, h, w)] = (b_ms, b_by)
                print(f"  time tridiag {what} axis={axis} {h}x{w} per call: kernel "
                      f"{turns[1]:.4f} / {turns[2]:.4f} ms (device busy {dev_ms:.4f} ms in "
                      f"{dev_ops:.0f} operations), plain {turns[0]:.4f} / {turns[3]:.4f} ms, "
                      f"bound {case_bound:.4f} ms", flush=True)

    for label, bpp in ROW_BYTES_PER_PX.items():
        print(f"  bound of row {label}: " + ", ".join(
            f"{h}x{w} {bound(bpp * h * w, 0)[0]:.4f} ms" for h, w in TIME_SHAPES), flush=True)

    main_launches = {}

    phase(f"4 main path: flow_nd {MAIN_SHAPE}, default parameters")
    p = FlowNDParams()
    it0, it1 = (torch.from_numpy(f).to(dev)
                for f in shifted_frames(rng, MAIN_SHAPE, [(0.0, 0.0), MAIN_SHIFT]))
    n_levels = len(pyramid_scales(MAIN_SHAPE[1], MAIN_SHAPE[2], p.scl_factor, 20, p.scales))
    expected = n_levels * p.firstLoop * p.secondLoop * (1 + 2 * p.iter)
    frame_s = []
    for _ in range(3):
        reset_counts()
        (u, v), sec = timed(lambda: flow_nd(it0, it1, "grad", "gradmag"))
        frame_s.append(sec)
        check_counts("flow_nd", {"flow_llin4_sor": expected})
    main_launches["flow_llin4_sor"] = expected
    print(f"  {n_levels} levels; frame time: cold {frame_s[0]:.3f} s, "
          f"warm {frame_s[1]:.3f} / {frame_s[2]:.3f} s", flush=True)
    print_profile("flow_nd", min(frame_s[1:]),
                  device_profile(lambda: flow_nd(it0, it1, "grad", "gradmag")))
    if u.shape != MAIN_SHAPE[1:] or v.shape != MAIN_SHAPE[1:] or u.device != dev:
        fail(f"flow of shape {tuple(u.shape)} on {u.device}")
    if not (torch.isfinite(u).all() and torch.isfinite(v).all()):
        fail("non-finite flow on the main path")
    inner = (slice(16, -16), slice(16, -16))
    mu, mv = float(u[inner].median()), float(v[inner].median())
    print(f"  median interior flow U={mu:.4f} V={mv:.4f} (shift {MAIN_SHIFT[1]}, "
          f"{MAIN_SHIFT[0]})", flush=True)
    if abs(mu - MAIN_SHIFT[1]) > SHIFT_TOL or abs(mv - MAIN_SHIFT[0]) > SHIFT_TOL:
        fail(f"flow ({mu}, {mv}) misses the shift {MAIN_SHIFT[::-1]} by more than {SHIFT_TOL} px")
    reset_counts()
    with dispatch.plain_solvers():
        (up, vp), plain_frame_s = timed(lambda: flow_nd(it0, it1, "grad", "gradmag"))
    check_counts("the plain path", {})
    d_plain = mean_flow_diff((u, v), (up, vp))
    print(f"  plain path on the card: frame {plain_frame_s:.3f} s, "
          f"mean |dflow| vs kernel path {d_plain:.3g} px", flush=True)
    if not d_plain <= FLOW_TOL:
        fail(f"kernel path and plain path differ by {d_plain} px > {FLOW_TOL}")
    small0, small1 = shifted_frames(rng, SMALL_SHAPE, [(0.0, 0.0), MAIN_SHIFT])
    ug, vg = flow_nd(torch.from_numpy(small0).to(dev), torch.from_numpy(small1).to(dev))
    uc, vc = flow_nd(small0, small1, device="cpu")
    d_cpu = mean_flow_diff((ug.cpu(), vg.cpu()), (uc, vc))
    print(f"  {SMALL_SHAPE} card vs CPU path: mean |dflow| {d_cpu:.3g} px", flush=True)
    if not d_cpu <= FLOW_TOL:
        fail(f"card and CPU paths differ by {d_cpu} px > {FLOW_TOL}")

    phase(f"5 flow_nd_sequence, 3 frames of {SEQ_SHAPE}")
    clip = torch.from_numpy(np.stack(shifted_frames(
        rng, SEQ_SHAPE, [(0.0, 0.0), MAIN_SHIFT, (2 * MAIN_SHIFT[0], 2 * MAIN_SHIFT[1])]))).to(dev)
    reset_counts()
    us, vs = flow_nd_sequence(clip, "grad", "gradmag")
    torch.cuda.synchronize()
    seq_levels = len(pyramid_scales(SEQ_SHAPE[1], SEQ_SHAPE[2], p.scl_factor, 20, p.scales))
    check_counts("flow_nd_sequence", {
        "flow_llin4_sor": 2 * seq_levels * p.firstLoop * p.secondLoop * (1 + 2 * p.iter)})
    if us.shape != (2,) + SEQ_SHAPE[1:]:
        fail(f"sequence flow of shape {tuple(us.shape)}")
    seq_err = 0.0
    for t in range(2):
        u_t, v_t = flow_nd(clip[t], clip[t + 1], "grad", "gradmag")
        seq_err = max(seq_err, float((us[t] - u_t).abs().max()), float((vs[t] - v_t).abs().max()))
    print(f"  max |dflow| vs per-pair flow_nd {seq_err:.3g} px", flush=True)
    if not seq_err <= FLOW_TOL:
        fail(f"flow_nd_sequence differs from per-pair flow_nd by {seq_err} px")

    phase(f"6 disparity_nd {MAIN_SHAPE}, default parameters")
    dp = DisparityParams()
    il, ir = (torch.from_numpy(f).to(dev)
              for f in shifted_frames(rng, MAIN_SHAPE, [(0.0, 0.0), DISP_SHIFT]))
    d_levels = len(pyramid_scales(MAIN_SHAPE[1], MAIN_SHAPE[2], dp.scl_factor, 10, dp.scales))
    d_expected = d_levels * dp.firstLoop * dp.secondLoop * 3 * dp.iter
    frame_s = []
    for _ in range(3):
        reset_counts()
        ud, sec = timed(lambda: disparity_nd(il, ir, "grad", "gradmag"))
        frame_s.append(sec)
        check_counts("disparity_nd", {"disp_llin4_sor": d_expected})
    main_launches["disp_llin4_sor"] = d_expected
    print(f"  {d_levels} levels x {dp.firstLoop} x {dp.secondLoop} calls x 3*{dp.iter}; "
          f"frame time: cold {frame_s[0]:.3f} s, warm {frame_s[1]:.3f} / {frame_s[2]:.3f} s",
          flush=True)
    print_profile("disparity_nd", min(frame_s[1:]),
                  device_profile(lambda: disparity_nd(il, ir, "grad", "gradmag")))
    if ud.shape != MAIN_SHAPE[1:] or ud.device != dev or not torch.isfinite(ud).all():
        fail(f"disparity of shape {tuple(ud.shape)} on {ud.device}, or not finite")
    md = float(ud[inner].median())
    print(f"  median interior disparity {md:.4f} (shift {DISP_SHIFT[1]})", flush=True)
    if abs(md - DISP_SHIFT[1]) > DISP_SHIFT_TOL:
        fail(f"disparity {md} misses the shift {DISP_SHIFT[1]} by more than {DISP_SHIFT_TOL} px")
    reset_counts()
    with dispatch.plain_solvers():
        udp, plain_frame_s = timed(lambda: disparity_nd(il, ir, "grad", "gradmag"))
    check_counts("the plain path", {})
    d_plain = float((ud - udp).abs().mean())
    print(f"  plain path on the card: frame {plain_frame_s:.3f} s, "
          f"mean |dU| vs kernel path {d_plain:.3g} px", flush=True)
    if not d_plain <= FLOW_TOL:
        fail(f"disparity kernel path and plain path differ by {d_plain} px > {FLOW_TOL}")
    small0, small1 = shifted_frames(rng, SMALL_SHAPE, [(0.0, 0.0), DISP_SHIFT])
    ug = disparity_nd(torch.from_numpy(small0).to(dev), torch.from_numpy(small1).to(dev))
    uc = disparity_nd(small0, small1, device="cpu")
    d_cpu = float((ug.cpu() - uc).abs().mean())
    print(f"  {SMALL_SHAPE} card vs CPU path: mean |dU| {d_cpu:.3g} px", flush=True)
    if not d_cpu <= FLOW_TOL:
        fail(f"disparity card and CPU paths differ by {d_cpu} px > {FLOW_TOL}")

    phase(f"7 disparity_sym {MAIN_SHAPE}, default parameters")
    sp = DisparitySymParams()
    s_levels = len(pyramid_scales(MAIN_SHAPE[1], MAIN_SHAPE[2], sp.scl_factor, 10, sp.scales))
    # one call with B = 2 per solve of the pair: two calls would count twice
    s_expected = s_levels * sp.firstLoop * sp.secondLoop * 3 * sp.iter
    frame_s = []
    for _ in range(2):
        reset_counts()
        us_, sec = timed(lambda: disparity_sym(il, ir))
        frame_s.append(sec)
        check_counts("disparity_sym", {"disp_llin4_sor": s_expected})
    if us_.shape != (2,) + MAIN_SHAPE[1:] or not torch.isfinite(us_).all():
        fail(f"symmetric disparity of shape {tuple(us_.shape)}, or not finite")
    m0, m1 = float(us_[0][inner].median()), float(us_[1][inner].median())
    print(f"  {s_levels} levels; frame time: cold {frame_s[0]:.3f} s, warm {frame_s[1]:.3f} s; "
          f"median interior U0 {m0:.4f}, U1 {m1:.4f} (shift +-{DISP_SHIFT[1]})", flush=True)
    print_profile("disparity_sym", frame_s[1], device_profile(lambda: disparity_sym(il, ir)))
    if abs(m0 - DISP_SHIFT[1]) > DISP_SHIFT_TOL or abs(m1 + DISP_SHIFT[1]) > DISP_SHIFT_TOL:
        fail(f"symmetric disparity ({m0}, {m1}) misses +-{DISP_SHIFT[1]} by more than "
             f"{DISP_SHIFT_TOL} px")
    reset_counts()
    with dispatch.plain_solvers():
        usp, plain_frame_s = timed(lambda: disparity_sym(il, ir))
    check_counts("the plain path", {})
    d_plain = float((us_ - usp).abs().mean())
    print(f"  plain path on the card: frame {plain_frame_s:.3f} s, "
          f"mean |dU| vs kernel path {d_plain:.3g} px", flush=True)
    if not d_plain <= FLOW_TOL:
        fail(f"disparity_sym kernel path and plain path differ by {d_plain} px > {FLOW_TOL}")

    phase(f"8 tv_denoise4 {MAIN_SHAPE}, default parameters")
    tp = TVDenoise4Params()
    noisy = torch.from_numpy(noisy_blocks(rng, MAIN_SHAPE)).to(dev)
    tv_levels = partial_pyramid_levels(MAIN_SHAPE, tp.scl, tp.scl_factor)
    tv_expected = tv_levels * (tp.outer_iter + 1) * 3 * tp.inner_iter
    frame_s = []
    for _ in range(2):
        reset_counts()
        den, sec = timed(lambda: tv_denoise4(noisy))
        frame_s.append(sec)
        check_counts("tv_denoise4", {"pde4_sor": tv_expected})
    main_launches["pde4_sor"] = tv_expected
    print(f"  {tv_levels} levels x {tp.outer_iter + 1} calls x 3*{tp.inner_iter}; "
          f"image time: cold {frame_s[0]:.3f} s, warm {frame_s[1]:.3f} s", flush=True)
    print_profile("tv_denoise4", frame_s[1], device_profile(lambda: tv_denoise4(noisy)))
    if den.shape != MAIN_SHAPE or not torch.isfinite(den).all():
        fail(f"denoised image of shape {tuple(den.shape)}, or not finite")
    reset_counts()
    with dispatch.plain_solvers():
        denp, plain_s = timed(lambda: tv_denoise4(noisy))
    check_counts("the plain path", {})
    scale = float(noisy.max() - noisy.min())
    d_rel = float((den - denp).abs().max()) / scale
    # a patch of the flat background; noise std per channel, averaged
    flat = (slice(None), slice(3 * MAIN_SHAPE[1] // 4 + 8, -8), slice(8, MAIN_SHAPE[2] // 2))
    sd_in_tv = float(noisy[flat].std(dim=(1, 2)).mean())
    sd_out = float(den[flat].std(dim=(1, 2)).mean())
    print(f"  plain path on the card: {plain_s:.3f} s, max |du| / range vs kernel path "
          f"{d_rel:.3g}; flat-patch noise std {sd_in_tv:.4f} -> {sd_out:.4f}", flush=True)
    if not d_rel <= TV_REL_TOL:
        fail(f"tv_denoise4 kernel path and plain path differ by {d_rel} > {TV_REL_TOL} "
             f"of the range")
    if not sd_out < 0.5 * sd_in_tv:
        fail(f"flat-patch noise {sd_out} is not under half of the input's {sd_in_tv}")

    def pcg_launches(calls: int, fields: int, iters: int) -> dict:
        """Line-solve launches of ``calls`` PCG solves of ``fields`` coupled
        fields: per call one factor per field and direction, and per
        preconditioner pass (``iters + 1``) 8 parity solves per field."""
        return {"tridiag_factor": calls * 2 * fields,
                "tridiag_solve": calls * (iters + 1) * 8 * fields}

    def kernel_vs_plain(what, run, diff, tol):
        """``run()`` on the kernel path and on the plain path at
        PLAIN_SHAPE; fails if ``diff`` of the two exceeds ``tol``."""
        got = run()
        reset_counts()
        with dispatch.plain_solvers():
            want, plain_s = timed(run)
        check_counts(f"{what}'s plain path", {})
        err = diff(got, want)
        print(f"  {what} at {PLAIN_SHAPE}: kernel path vs plain path {err:.3g} "
              f"(plain path {plain_s:.3f} s on the card)", flush=True)
        if not err <= tol:
            fail(f"{what}: kernel path and plain path differ by {err} > {tol}")

    small0, small1 = (torch.from_numpy(f).to(dev)
                      for f in shifted_frames(rng, PLAIN_SHAPE, [(0.0, 0.0), MAIN_SHIFT]))

    phase(f"9 flow_hs {MAIN_SHAPE}, default parameters (solver=2, PCG)")
    hp = FlowHSParams()
    hs_levels = len(pyramid_scales(MAIN_SHAPE[1], MAIN_SHAPE[2], hp.scl_factor, 20, hp.scales))
    hs_expected = pcg_launches(hs_levels, 2, hp.iter)
    frame_s = []
    for _ in range(3):
        reset_counts()
        (uh, vh), sec = timed(lambda: flow_hs(it0, it1))
        frame_s.append(sec)
        check_counts("flow_hs", hs_expected)
    main_launches["tridiag"] = sum(hs_expected.values())
    print(f"  {hs_levels} levels x (4 factors + {hp.iter + 1} preconditioner passes x 16 "
          f"parity solves); frame time: cold {frame_s[0]:.3f} s, warm {frame_s[1]:.3f} / "
          f"{frame_s[2]:.3f} s", flush=True)
    print_profile("flow_hs", min(frame_s[1:]), device_profile(lambda: flow_hs(it0, it1)))
    if uh.shape != MAIN_SHAPE[1:] or not (torch.isfinite(uh).all() and torch.isfinite(vh).all()):
        fail(f"flow_hs flow of shape {tuple(uh.shape)}, or not finite")
    print(f"  median interior flow U={float(uh[inner].median()):.4f} "
          f"V={float(vh[inner].median()):.4f} (shift {MAIN_SHIFT[1]}, {MAIN_SHIFT[0]})",
          flush=True)
    kernel_vs_plain("flow_hs", lambda: flow_hs(small0, small1), mean_flow_diff, FLOW_TOL)
    s0, s1 = shifted_frames(rng, SMALL_SHAPE, [(0.0, 0.0), MAIN_SHIFT])
    ug, vg = flow_hs(torch.from_numpy(s0).to(dev), torch.from_numpy(s1).to(dev))
    d_cpu = mean_flow_diff((ug.cpu(), vg.cpu()), flow_hs(s0, s1, device="cpu"))
    print(f"  {SMALL_SHAPE} card vs CPU path: mean |dflow| {d_cpu:.3g} px", flush=True)
    if not d_cpu <= FLOW_TOL:
        fail(f"flow_hs card and CPU paths differ by {d_cpu} px > {FLOW_TOL}")

    phase(f"10 flow_hs {MAIN_SHAPE}, solver=1 (elin4 SOR)")
    elin_expected = hs_levels * (1 + 2 * hp.iter)
    reset_counts()
    (u1, v1), sec = timed(lambda: flow_hs(it0, it1, solver=1))
    check_counts("flow_hs solver=1", {"flow_elin4_sor": elin_expected})
    main_launches["flow_elin4_sor"] = elin_expected
    if not (torch.isfinite(u1).all() and torch.isfinite(v1).all()):
        fail("flow_hs solver=1: non-finite flow")
    reset_counts()
    with dispatch.plain_solvers():
        (u1p, v1p), plain_s = timed(lambda: flow_hs(it0, it1, solver=1))
    check_counts("the plain path", {})
    d_plain = mean_flow_diff((u1, v1), (u1p, v1p))
    print(f"  {hs_levels} levels x (1 + 2*{hp.iter}) launches; frame {sec:.3f} s; plain path "
          f"{plain_s:.3f} s, mean |dflow| vs kernel path {d_plain:.3g} px", flush=True)
    if not d_plain <= FLOW_TOL:
        fail(f"flow_hs solver=1 kernel path and plain path differ by {d_plain} px")
    # the pair of tests/test_models.py: HS relaxed pointwise needs ~400
    # sweeps to approach a 1-px shift on this smooth pattern
    import scipy.ndimage as ndi
    base = ndi.gaussian_filter(rng.random((48, 56)).astype(np.float32), 3.0) * 255.0
    us1, vs1 = flow_hs(torch.from_numpy(base).to(dev),
                       torch.from_numpy(np.roll(base, 1, axis=1)).to(dev), iter=400, solver=1)
    mu, mv = float(us1[8:-8, 8:-8].median()), float(vs1[8:-8, 8:-8].median())
    print(f"  48x56 pair shifted 1 px, iter=400: median U={mu:.4f} V={mv:.4f}", flush=True)
    if not (torch.isfinite(us1).all() and abs(mu) > 0.55 and abs(mv) < 0.2):
        fail(f"flow_hs solver=1 misses the 1-px shift: median ({mu}, {mv})")

    phase(f"11 diffusion4 {MAIN_SHAPE}, default parameters")
    fp = Diffusion4Params()
    img = noisy * 255.0
    diff_expected = 2 * (fp.outer_iter + 1)
    frame_s = []
    for _ in range(2):
        reset_counts()
        dif, sec = timed(lambda: diffusion4(img))
        frame_s.append(sec)
        check_counts("diffusion4", {"tridiag_thomas": diff_expected})
    if dif.shape != MAIN_SHAPE or not torch.isfinite(dif).all():
        fail(f"diffused image of shape {tuple(dif.shape)}, or not finite")
    reset_counts()
    with dispatch.plain_solvers():
        difp, plain_s = timed(lambda: diffusion4(img))
    check_counts("the plain path", {})
    d_rel = float((dif - difp).abs().max()) / float(img.max() - img.min())
    sd_in = float(img[flat].std(dim=(1, 2)).mean())
    sd_out = float(dif[flat].std(dim=(1, 2)).mean())
    print(f"  {fp.outer_iter + 1} iterations x 2 solves; image time: cold {frame_s[0]:.4f} s, "
          f"warm {frame_s[1]:.4f} s; plain path {plain_s:.3f} s, max |du| / range vs kernel "
          f"path {d_rel:.3g}; flat-patch noise std {sd_in:.3f} -> {sd_out:.3f}", flush=True)
    if not d_rel <= TV_REL_TOL:
        fail(f"diffusion4 kernel path and plain path differ by {d_rel} of the range")
    if not sd_out < 0.5 * sd_in:
        fail(f"diffusion4: flat-patch noise {sd_out} is not under half of the input's {sd_in}")

    phase(f"12 flow_ad {MAIN_SHAPE}, default parameters (anisotropic tensor, llin8)")
    ap_ = FlowADParams()
    ad_levels = len(pyramid_scales(MAIN_SHAPE[1], MAIN_SHAPE[2], ap_.scl_factor, 20,
                                   ap_.scales))
    ad_expected = ad_levels * ap_.firstLoop * ap_.secondLoop * (1 + 2 * ap_.iter)
    frame_s = []
    for _ in range(3):
        reset_counts()
        (ua, va), sec = timed(lambda: flow_ad(it0, it1, "grad", "gradmag"))
        frame_s.append(sec)
        check_counts("flow_ad", {"flow_llin8_sor": ad_expected})
    main_launches["flow_llin8_sor"] = ad_expected
    print(f"  {ad_levels} levels x {ap_.firstLoop} x {ap_.secondLoop} calls x "
          f"(1 + 2*{ap_.iter}); frame time: cold {frame_s[0]:.3f} s, warm {frame_s[1]:.3f} / "
          f"{frame_s[2]:.3f} s", flush=True)
    print_profile("flow_ad", min(frame_s[1:]),
                  device_profile(lambda: flow_ad(it0, it1, "grad", "gradmag")))
    if ua.shape != MAIN_SHAPE[1:] or ua.device != dev or not (
            torch.isfinite(ua).all() and torch.isfinite(va).all()):
        fail(f"flow_ad flow of shape {tuple(ua.shape)} on {ua.device}, or not finite")
    mu, mv = float(ua[inner].median()), float(va[inner].median())
    print(f"  median interior flow U={mu:.4f} V={mv:.4f} (shift {MAIN_SHIFT[1]}, "
          f"{MAIN_SHIFT[0]})", flush=True)
    if abs(mu - MAIN_SHIFT[1]) > SHIFT_TOL or abs(mv - MAIN_SHIFT[0]) > SHIFT_TOL:
        fail(f"flow_ad ({mu}, {mv}) misses the shift {MAIN_SHIFT[::-1]} by more than "
             f"{SHIFT_TOL} px")
    reset_counts()
    with dispatch.plain_solvers():
        (uap, vap), plain_frame_s = timed(lambda: flow_ad(it0, it1, "grad", "gradmag"))
    check_counts("the plain path", {})
    d_plain = mean_flow_diff((ua, va), (uap, vap))
    print(f"  plain path on the card: frame {plain_frame_s:.3f} s, "
          f"mean |dflow| vs kernel path {d_plain:.3g} px", flush=True)
    if not d_plain <= FLOW_TOL:
        fail(f"flow_ad kernel path and plain path differ by {d_plain} px > {FLOW_TOL}")
    s0, s1 = shifted_frames(rng, SMALL_SHAPE, [(0.0, 0.0), MAIN_SHIFT])
    ug, vg = flow_ad(torch.from_numpy(s0).to(dev), torch.from_numpy(s1).to(dev))
    d_cpu = mean_flow_diff((ug.cpu(), vg.cpu()), flow_ad(s0, s1, device="cpu"))
    print(f"  {SMALL_SHAPE} card vs CPU path: mean |dflow| {d_cpu:.3g} px", flush=True)
    if not d_cpu <= FLOW_TOL:
        fail(f"flow_ad card and CPU paths differ by {d_cpu} px > {FLOW_TOL}")

    phase(f"13 tv_denoise8 {MAIN_SHAPE}, default parameters (anisotropic tensor, pde8)")
    tp8 = TVDenoise8Params()
    tv8_levels = partial_pyramid_levels(MAIN_SHAPE, tp8.scl, tp8.scl_factor)
    tv8_expected = tv8_levels * (tp8.outer_iter + 1) * 3 * tp8.inner_iter
    frame_s = []
    for _ in range(2):
        reset_counts()
        den8, sec = timed(lambda: tv_denoise8(noisy))
        frame_s.append(sec)
        check_counts("tv_denoise8", {"pde8_sor": tv8_expected})
    main_launches["pde8_sor"] = tv8_expected
    print(f"  {tv8_levels} levels x {tp8.outer_iter + 1} calls x 3*{tp8.inner_iter}; "
          f"image time: cold {frame_s[0]:.3f} s, warm {frame_s[1]:.3f} s", flush=True)
    print_profile("tv_denoise8", frame_s[1], device_profile(lambda: tv_denoise8(noisy)))
    if den8.shape != MAIN_SHAPE or not torch.isfinite(den8).all():
        fail(f"tv_denoise8 image of shape {tuple(den8.shape)}, or not finite")
    reset_counts()
    with dispatch.plain_solvers():
        den8p, plain_s = timed(lambda: tv_denoise8(noisy))
    check_counts("the plain path", {})
    d_rel = float((den8 - den8p).abs().max()) / scale
    sd_out = float(den8[flat].std(dim=(1, 2)).mean())
    print(f"  plain path on the card: {plain_s:.3f} s, max |du| / range vs kernel path "
          f"{d_rel:.3g}; flat-patch noise std {sd_in_tv:.4f} -> {sd_out:.4f}", flush=True)
    if not d_rel <= TV_REL_TOL:
        fail(f"tv_denoise8 kernel path and plain path differ by {d_rel} > {TV_REL_TOL} "
             f"of the range")
    if not sd_out < 0.5 * sd_in_tv:
        fail(f"tv_denoise8: flat-patch noise {sd_out} is not under half of the input's "
             f"{sd_in_tv}")

    phase(f"14 solver=2 (PCG) in flow_nd, disparity_nd, disparity_sym, tv_denoise4, "
          f"flow_ad, tv_denoise8 {MAIN_SHAPE}")
    loops = dict(firstLoop=2, secondLoop=2)  # the plain comparisons' loop counts
    # (name, run at full size, expected launches, check of the result, run
    # at PLAIN_SHAPE, difference of two results, tolerance)
    cases = [
        ("flow_nd", lambda: flow_nd(it0, it1, "grad", "gradmag", solver=2),
         pcg_launches(n_levels * p.firstLoop * p.secondLoop, 2, p.iter),
         lambda f: ((float(f[0][inner].median()), float(f[1][inner].median())),
                    abs(float(f[0][inner].median()) - MAIN_SHIFT[1]) <= SHIFT_TOL
                    and abs(float(f[1][inner].median()) - MAIN_SHIFT[0]) <= SHIFT_TOL),
         lambda: flow_nd(small0, small1, "grad", "gradmag", solver=2, **loops),
         mean_flow_diff, FLOW_TOL),
        ("disparity_nd", lambda: disparity_nd(il, ir, "grad", "gradmag", solver=2),
         pcg_launches(d_levels * dp.firstLoop * dp.secondLoop, 1, dp.iter),
         lambda u: (float(u[inner].median()),
                    abs(float(u[inner].median()) - DISP_SHIFT[1]) <= DISP_SHIFT_TOL),
         lambda: disparity_nd(small0, small1, "grad", "gradmag", solver=2, **loops),
         lambda a, b: float((a - b).abs().mean()), FLOW_TOL),
        ("disparity_sym", lambda: disparity_sym(il, ir, solver=2),
         pcg_launches(s_levels * sp.firstLoop * sp.secondLoop, 1, sp.iter),
         lambda u: ((float(u[0][inner].median()), float(u[1][inner].median())),
                    abs(float(u[0][inner].median()) - DISP_SHIFT[1]) <= DISP_SHIFT_TOL
                    and abs(float(u[1][inner].median()) + DISP_SHIFT[1]) <= DISP_SHIFT_TOL),
         lambda: disparity_sym(small0, small1, solver=2, **loops),
         lambda a, b: float((a - b).abs().mean()), FLOW_TOL),
        ("tv_denoise4", lambda: tv_denoise4(noisy, solver=2),
         pcg_launches(tv_levels * (tp.outer_iter + 1), 1, tp.inner_iter),
         lambda u: ((float(noisy[flat].std(dim=(1, 2)).mean()),
                     float(u[flat].std(dim=(1, 2)).mean())),
                    float(u[flat].std(dim=(1, 2)).mean())
                    < 0.5 * float(noisy[flat].std(dim=(1, 2)).mean())),
         lambda: tv_denoise4(small0 / 255.0, solver=2, outer_iter=2),
         lambda a, b: float((a - b).abs().max()) / float((small0 / 255.0).max()
                                                       - (small0 / 255.0).min()),
         TV_REL_TOL),
        ("flow_ad", lambda: flow_ad(it0, it1, "grad", "gradmag", solver=2),
         pcg_launches(ad_levels * ap_.firstLoop * ap_.secondLoop, 2, ap_.iter),
         lambda f: ((float(f[0][inner].median()), float(f[1][inner].median())),
                    abs(float(f[0][inner].median()) - MAIN_SHIFT[1]) <= SHIFT_TOL
                    and abs(float(f[1][inner].median()) - MAIN_SHIFT[0]) <= SHIFT_TOL),
         lambda: flow_ad(small0, small1, "grad", "gradmag", solver=2, **loops),
         mean_flow_diff, FLOW_TOL),
        ("tv_denoise8", lambda: tv_denoise8(noisy, solver=2),
         pcg_launches(tv8_levels * (tp8.outer_iter + 1), 1, tp8.inner_iter),
         lambda u: ((sd_in_tv, float(u[flat].std(dim=(1, 2)).mean())),
                    float(u[flat].std(dim=(1, 2)).mean()) < 0.5 * sd_in_tv),
         lambda: tv_denoise8(small0 / 255.0, solver=2, outer_iter=2),
         lambda a, b: float((a - b).abs().max()) / float((small0 / 255.0).max()
                                                       - (small0 / 255.0).min()),
         TV_REL_TOL),
    ]
    for name, run, expected, check, run_small, diff, tol in cases:
        frame_s = []
        for _ in range(2):
            reset_counts()
            out, sec = timed(run)
            frame_s.append(sec)
            check_counts(f"{name} solver=2", expected)
        outs = out if isinstance(out, tuple) else (out,)
        if not all(torch.isfinite(o).all() for o in outs):
            fail(f"{name} solver=2: non-finite result")
        value, ok = check(out)
        print(f"  {name}: {sum(expected.values())} line-solve launches; frame time: cold "
              f"{frame_s[0]:.3f} s, warm {frame_s[1]:.3f} s; result check {value}", flush=True)
        if not ok:
            fail(f"{name} solver=2: result check failed ({value})")
        kernel_vs_plain(f"{name} solver=2", run_small, diff, tol)

    sources = {"flow_llin4_sor": ("pde_tpu_torch/csrc/flow_llin4_sor.cu",
                                  "pde_tpu/kernels/sor_pallas.py:71"),
               "disp_llin4_sor": ("pde_tpu_torch/csrc/interior_sor.cu",
                                  "pde_tpu/kernels/sweeps.py:145"),
               "pde4_sor": ("pde_tpu_torch/csrc/interior_sor.cu",
                            "pde_tpu/kernels/sweeps.py:174"),
               "flow_elin4_sor": ("pde_tpu_torch/csrc/flow_llin4_sor.cu",
                                  "pde_tpu/kernels/sweeps.py:234"),
               "flow_llin8_sor": ("pde_tpu_torch/csrc/flow_llin4_sor.cu",
                                  "pde_tpu/kernels/sweeps.py:106"),
               "pde8_sor": ("pde_tpu_torch/csrc/interior_sor.cu",
                            "pde_tpu/kernels/sweeps.py:203"),
               "tridiag": ("pde_tpu_torch/csrc/tridiag.cu",
                           "pde_tpu/kernels/tdma_pallas.py:82")}
    th, tw = TIME_SHAPES[0]
    # the tridiagonal solve is reported whole, along axis -2
    key = {name: ((name, -2, th, tw) if name == "tridiag" else (name, th, tw))
           for name in sources}
    report = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": src,
        "replaces": replaces,
        "launches": main_launches[name],
        "max_abs_err": max_err[name],
        "ms": times[key[name]][0],
        "plain_ms": times[key[name]][1],
        "bound_ms": bounds[key[name]][0],
        "bound_by": bounds[key[name]][1],
        # no single PyTorch call computes a red-black SOR sweep or a batched
        # tridiagonal solve
        "library_ms": None,
    } for name, (src, replaces) in sources.items()]}
    print(f"total {time.time() - t_start:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
