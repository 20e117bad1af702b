#!/usr/bin/env python3
"""Warm frame times of the SOR paths whose solves the resident kernels take
(``flow_nd``, ``disparity_nd``, ``disparity_sym``, ``tv_denoise4``,
``flow_hs`` with ``solver=1`` (``flow_hs_sor``), ``flow_ad``,
``tv_denoise8``; default parameters, 3x480x640 or ``--shape C H W``) on one
CUDA card, for the ``pde_tpu_torch`` package under ``--root``.

    python3 scripts/sor_frame_times.py [--root DIR] [--frames N] [--seed N] [--label TEXT]
        [--models NAME ...] [--shape C H W]

To compare two checkouts on one card, run it for each in turns (parent,
change, change, parent) within one call. For each model: one cold frame
(it builds the kernels), ``N`` warm frames on the host clock (each ends in
``torch.cuda.synchronize()``), then one frame under ``torch.profiler``: the
device busy time, the device operations and the device time in the port's
own kernels (``chip_smoke.device_profile``), and in each of them by name.
Prints the card's name and
power limit, a line per model and, last, one JSON object; exits non-zero
without a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent.parent
SHAPE = (3, 480, 640)
FLOW_SHIFT, DISP_SHIFT = (0.4, 1.3), (0.0, 2.6)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE,
                    help="the checkout whose pde_tpu_torch is timed")
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--label", default=None)
    ap.add_argument("--models", nargs="+", default=None,
                    help="the models to time (default: all)")
    ap.add_argument("--shape", type=int, nargs=3, default=SHAPE, metavar=("C", "H", "W"),
                    help="the frames' shape (default: 3 480 640)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA card: the frames are timed on the card")
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    # this checkout's chip_smoke.py for its helpers, whatever --root is
    spec = importlib.util.spec_from_file_location("smoke_helpers", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import pde_tpu_torch
    from pde_tpu_torch.models.disparity import disparity_nd
    from pde_tpu_torch.models.disparity_sym import disparity_sym
    from pde_tpu_torch.models.flow_ad import flow_ad
    from pde_tpu_torch.models.flow_hs import flow_hs
    from pde_tpu_torch.models.flow_nd import flow_nd
    from pde_tpu_torch.models.tv_denoise import tv_denoise4, tv_denoise8

    if Path(pde_tpu_torch.__file__).resolve().parent.parent != root:
        sys.exit(f"pde_tpu_torch came from {pde_tpu_torch.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = smoke.nvidia_smi_line()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    shape = tuple(args.shape)
    f0, f1 = (torch.from_numpy(f).to(dev)
              for f in smoke.shifted_frames(rng, shape, [(0.0, 0.0), FLOW_SHIFT]))
    l0, l1 = (torch.from_numpy(f).to(dev)
              for f in smoke.shifted_frames(rng, shape, [(0.0, 0.0), DISP_SHIFT]))
    noisy = torch.from_numpy(smoke.noisy_blocks(rng, shape)).to(dev)
    runs = {"flow_nd": lambda: flow_nd(f0, f1, "grad", "gradmag"),
            "disparity_nd": lambda: disparity_nd(l0, l1, "grad", "gradmag"),
            "disparity_sym": lambda: disparity_sym(l0, l1),
            "tv_denoise4": lambda: tv_denoise4(noisy),
            "flow_hs_sor": lambda: flow_hs(f0, f1, solver=1),
            "flow_ad": lambda: flow_ad(f0, f1, "grad", "gradmag"),
            "tv_denoise8": lambda: tv_denoise8(noisy)}
    runs = {k: v for k, v in runs.items() if args.models is None or k in args.models}
    out = {"root": str(root), "label": args.label or root.name, "nvidia_smi": smi,
           "device": torch.cuda.get_device_name(0), "shape": shape, "models": {}}
    for name, run in runs.items():
        cold = smoke.timed(run)[1]
        warm = [smoke.timed(run)[1] for _ in range(args.frames)]
        events = smoke.device_events(run)
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        n_ops = sum(e.count for e in events)
        own = {}
        for e in events:
            if kernel := smoke.own_kernel(e.key):
                own[kernel] = own.get(kernel, 0.0) + e.self_device_time_total / 1e3
        own_ms = sum(own.values())
        out["models"][name] = {"cold_s": cold, "warm_s": warm, "device_busy_ms": busy_ms,
                               "device_ops": n_ops, "own_kernels_ms": own_ms,
                               "own_kernels_by_name_ms": own}
        print(f"{out['label']} {name} {shape}: warm min {min(warm):.4f} s, median "
              f"{statistics.median(warm):.4f} s over {len(warm)}; device busy {busy_ms:.3f} ms, "
              f"{n_ops:.0f} device operations, the port's kernels {own_ms:.3f} ms ("
              + ", ".join(f"{k} {v:.4f}" for k, v in sorted(own.items())) + ")", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
