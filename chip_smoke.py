#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pde_tpu_torch``) on one NVIDIA GPU and check it.

Run from the repository root, on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py [--seed N]

Phases; any failure exits non-zero, and nothing falls back to the CPU:

1. Require CUDA; print the card's name and power limit (``nvidia-smi``).
2. Build every kernel of the main path from ``pde_tpu_torch/csrc`` (timed);
   TF32 is switched off for matmuls and cuDNN.
3. Each kernel against its plain PyTorch version on the card, at the
   solver's shapes, with and without NaN data; both timed with CUDA events.
4. The main path: ``flow_nd`` with default parameters on a 3-channel
   480x640 pair whose second frame is the first shifted by a known
   sub-pixel amount. The flow must be finite and recover the shift, the
   kernel must have been launched exactly as often as the pyramid
   implies, and the plain path on the card must agree. A small pair is
   also held against the port's CPU path, which the CPU tests hold
   against the JAX package.
5. ``flow_nd_sequence`` on a 3-frame 240x320 clip against per-pair
   ``flow_nd``.

The last lines are a JSON object of the kernels (launches, errors, times)
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

SOR_TOL = 1e-5       # max-abs, kernel vs plain, unit-scale fields (FMA contraction moves ulps)
FLOW_TOL = 1e-3      # px, mean |Δflow| between two paths of the whole model
SHIFT_TOL = 0.3      # px, median interior flow vs the known shift
MAIN_SHAPE = (3, 480, 640)
MAIN_SHIFT = (0.4, 1.3)  # (dy, dx) in px: the second frame moves right and down
SEQ_SHAPE = (3, 240, 320)
# the main path's finest level and odd neighbours, a coarse level, and
# degenerate shapes where every pixel is an edge pixel
SOR_SHAPES = [(1, 1), (1, 9), (9, 1), (37, 53), (480, 640), (481, 641), (1024, 1024)]
TIME_SHAPES = [(481, 641), (1024, 1024)]  # the first one is reported as the kernel's ms


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


def sor_fields(rng, h, w, nan: bool, dev):
    """Unit-scale llin4 solver fields; 5% NaN in Cu and Du when ``nan``."""
    f = {}
    for n in ("u", "v", "du", "dv", "m", "cu", "cv", "duc", "dvc", "ww", "wn", "we", "ws"):
        if n in ("duc", "dvc"):
            x = rng.random((h, w)) + 1.0
        elif n == "m":
            x = rng.random((h, w)) * 0.01
        elif n.startswith("w"):
            x = rng.random((h, w)) + 0.1
        else:
            x = rng.random((h, w)) * 0.2
        if nan and n in ("cu", "duc"):
            x = np.where(rng.random((h, w)) < 0.05, np.nan, x)
        f[n] = torch.from_numpy(x.astype(np.float32)).to(dev)
    return list(f.values())


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


def mean_flow_diff(a, b) -> float:
    return float(torch.hypot(a[0] - b[0], a[1] - b[1]).mean())


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
    from pde_tpu_torch.kernels import build, dispatch, sor_cuda
    from pde_tpu_torch.models.flow_nd import FlowNDParams, flow_nd, flow_nd_sequence
    from pde_tpu_torch.solvers import sor as plain_sor

    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
          f"count {torch.cuda.device_count()}", flush=True)

    phase("2 build")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    t0 = time.time()
    lib = build.build(sor_cuda.SOURCE, verbose=True)
    sor_cuda._lib()
    print(f"built {lib.relative_to(HERE)} in {time.time() - t0:.1f} s", flush=True)

    phase("3 kernel vs plain")
    rng = np.random.default_rng(args.seed)
    omega = 1.9
    max_err = 0.0
    for h, w in SOR_SHAPES:
        for iters in (4, 5):
            for nan in (False, True):
                fields = sor_fields(rng, h, w, nan, dev)
                got = sor_cuda.flow_llin4_sor(*fields, iters, omega)
                want = plain_sor.sor_flow_llin4(*fields, iters, omega)
                torch.cuda.synchronize()
                for g, w_ in zip(got, want):
                    if not (torch.isfinite(g).all() and torch.isfinite(w_).all()):
                        fail(f"non-finite solver output at {h}x{w} iters={iters} nan={nan}")
                err = max(float((g - w_).abs().max()) for g, w_ in zip(got, want))
                print(f"  {h}x{w} iters={iters} nan={nan}: max_abs_err={err:.3g}", flush=True)
                if err > SOR_TOL:
                    fail(f"kernel disagrees with plain at {h}x{w} iters={iters}: {err} > {SOR_TOL}")
                max_err = max(max_err, err)
    times = {}
    for h, w in TIME_SHAPES:
        fields = sor_fields(rng, h, w, True, dev)
        kern = partial(sor_cuda.flow_llin4_sor, *fields, 4, omega)
        plain = partial(plain_sor.sor_flow_llin4, *fields, 4, omega)
        # in turns, plain kernel kernel plain, on one card
        p1, k1, k2, p2 = (cuda_ms(fn, 50) for fn in (plain, kern, kern, plain))
        times[(h, w)] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"  time {h}x{w} iters=4 per call: kernel {k1:.4f} / {k2:.4f} ms, "
              f"plain {p1:.4f} / {p2:.4f} ms", flush=True)

    phase(f"4 main path: flow_nd {MAIN_SHAPE}, default parameters")
    p = FlowNDParams()
    it0, it1 = (torch.from_numpy(f).to(dev)
                for f in shifted_frames(rng, MAIN_SHAPE, [(0.0, 0.0), MAIN_SHIFT]))
    n_levels = len(pyramid_scales(MAIN_SHAPE[1], MAIN_SHAPE[2], p.scl_factor, 20, p.scales))
    expected = n_levels * p.firstLoop * p.secondLoop * (1 + 2 * p.iter)
    frame_s = []
    for run in range(3):
        sor_cuda.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.time()
        u, v = flow_nd(it0, it1, "grad", "gradmag")
        torch.cuda.synchronize()
        frame_s.append(time.time() - t0)
        launches = sor_cuda.LAUNCHES
        if launches != expected:
            fail(f"kernel launched {launches} times on the main path, expected {expected} "
                 f"= {n_levels} levels x {p.firstLoop} x {p.secondLoop} x (1 + 2*{p.iter})")
    print(f"  kernel launches {launches} (expected {expected}, {n_levels} levels)", flush=True)
    print(f"  frame time: cold {frame_s[0]:.3f} s, warm {frame_s[1]:.3f} / {frame_s[2]:.3f} s",
          flush=True)
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
    sor_cuda.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.time()
    with dispatch.plain_solvers():
        up, vp = flow_nd(it0, it1, "grad", "gradmag")
    torch.cuda.synchronize()
    plain_frame_s = time.time() - t0
    if sor_cuda.LAUNCHES != 0:
        fail("the plain path launched the kernel")
    d_plain = mean_flow_diff((u, v), (up, vp))
    print(f"  plain path on the card: frame {plain_frame_s:.3f} s, "
          f"mean |dflow| vs kernel path {d_plain:.3g} px", flush=True)
    if not d_plain <= FLOW_TOL:
        fail(f"kernel path and plain path differ by {d_plain} px > {FLOW_TOL}")
    small0, small1 = shifted_frames(rng, (3, 36, 44), [(0.0, 0.0), MAIN_SHIFT])
    ug, vg = flow_nd(torch.from_numpy(small0).to(dev), torch.from_numpy(small1).to(dev))
    uc, vc = flow_nd(small0, small1)
    d_cpu = mean_flow_diff((ug.cpu(), vg.cpu()), (uc, vc))
    print(f"  3x36x44 card vs CPU path: mean |dflow| {d_cpu:.3g} px", flush=True)
    if not d_cpu <= FLOW_TOL:
        fail(f"card and CPU paths differ by {d_cpu} px > {FLOW_TOL}")

    phase(f"5 flow_nd_sequence, 3 frames of {SEQ_SHAPE}")
    clip = torch.from_numpy(np.stack(shifted_frames(
        rng, SEQ_SHAPE, [(0.0, 0.0), MAIN_SHIFT, (2 * MAIN_SHIFT[0], 2 * MAIN_SHIFT[1])]))).to(dev)
    sor_cuda.LAUNCHES = 0
    us, vs = flow_nd_sequence(clip, "grad", "gradmag")
    torch.cuda.synchronize()
    seq_levels = len(pyramid_scales(SEQ_SHAPE[1], SEQ_SHAPE[2], p.scl_factor, 20, p.scales))
    seq_expected = 2 * seq_levels * p.firstLoop * p.secondLoop * (1 + 2 * p.iter)
    if sor_cuda.LAUNCHES != seq_expected:
        fail(f"sequence launched the kernel {sor_cuda.LAUNCHES} times, expected {seq_expected}")
    if us.shape != (2,) + SEQ_SHAPE[1:]:
        fail(f"sequence flow of shape {tuple(us.shape)}")
    seq_err = 0.0
    for t in range(2):
        u_t, v_t = flow_nd(clip[t], clip[t + 1], "grad", "gradmag")
        seq_err = max(seq_err, float((us[t] - u_t).abs().max()), float((vs[t] - v_t).abs().max()))
    print(f"  launches {seq_expected}; max |dflow| vs per-pair flow_nd {seq_err:.3g} px",
          flush=True)
    if not seq_err <= FLOW_TOL:
        fail(f"flow_nd_sequence differs from per-pair flow_nd by {seq_err} px")

    k_ms, plain_ms = times[TIME_SHAPES[0]]
    report = {"kernels": [{
        "name": "flow_llin4_sor",
        "route": "cuda",
        "source": "pde_tpu_torch/csrc/flow_llin4_sor.cu",
        "replaces": "pde_tpu/kernels/sor_pallas.py:71",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": plain_ms,
    }]}
    print(f"total {time.time() - t_start:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
