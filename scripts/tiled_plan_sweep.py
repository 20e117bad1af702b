#!/usr/bin/env python3
"""Sustained sweep rate of the tile kernel (``pde_tpu_torch/csrc/tiled_sor.cu``)
over tile plans, on one CUDA card.

    python3 scripts/tiled_plan_sweep.py [--seed N]

For llin4 and elin4, serial and double-buffered, every k in ``KS`` and
tile in ``TILES`` whose shared memory fits a block: the rate in
Mpix-iters/s at 1024x1024 on ``bench.py``'s inputs, by chained
differencing between 128 and 512 sweeps (as ``chip_smoke.py`` phase 15),
with the plan's shared memory a block and bytes per pixel-iteration, and
the default plan (``kernels/tiled.py::plan_tiles``) first. Exits non-zero
without a CUDA card; prints the card's name and power limit and one JSON
object of every rate last.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SHAPE = (1024, 1024)
ITERS = (128, 512)
KS = (1, 2, 3, 4)
TILES = ((8, 32), (16, 16), (16, 32), (16, 64), (24, 32), (24, 48), (32, 32), (32, 64),
         (40, 40), (48, 48))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA card: the tile kernel runs only on the card")
    from pde_tpu_torch.kernels import sweeps, tiled

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)

    def field(scale=1.0):
        return torch.from_numpy((rng.random(SHAPE) * scale).astype(np.float32)).to(dev)

    u, v, du, dv = field(0.1), field(0.1), field(0.0), field(0.0)
    coef = (field(0.01), field(), field(), field() + 1.0, field() + 1.0) + (
        torch.full(SHAPE, 0.25, device=dev),) * 4
    families = {"flow_llin4": ((du, dv), (u, v) + coef), "flow_elin4": ((u, v), coef)}
    px = SHAPE[0] * SHAPE[1]

    def rate(family, k, tile, double_buffer):
        start, const = families[family]
        prep, sw = getattr(sweeps, f"{family}_sweep")(1.9)

        def two(iters):
            a, b = start
            for _ in range(2):
                a, b = tiled.tiled_relax((a, b) + const, sw, 2, iters, prepare_fn=prep,
                                         plan_override=(k, tile), double_buffer=double_buffer)

        ms = []
        for iters in ITERS:
            two(iters)
            best = float("inf")
            for _ in range(3):
                t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0.record()
                two(iters)
                t1.record()
                t1.synchronize()
                best = min(best, t0.elapsed_time(t1) / 2)
            ms.append(best)
        return px / ((ms[1] - ms[0]) / (ITERS[1] - ITERS[0]) * 1e-3) / 1e6

    results = []
    for family, (_, const) in families.items():
        n_fields = 2 + len(const)
        for double_buffer in (False, True):
            default = tiled.plan_tiles(*SHAPE, n_fields, ITERS[1], 4, double_buffer=double_buffer)
            plans = [(default.k, (default.tile_h, default.tile_w))]
            plans += [(k, t) for k in KS for t in TILES if (k, t) != plans[0]]
            for k, (th, tw) in plans:
                smem = (2 if double_buffer else 1) * tiled.slot_bytes(n_fields, k, th, tw)
                if smem > tiled.SMEM_PER_BLOCK:
                    continue
                plan = tiled.TilePlan(k, th, tw, 0, 0, smem)
                r = rate(family, k, (th, tw), double_buffer)
                bpp = tiled.bytes_per_pixel_iter(plan, n_fields, 2)
                results.append({"family": family, "double_buffer": double_buffer, "k": k,
                                "tile": [th, tw], "smem_bytes": smem, "bytes_per_px_iter": bpp,
                                "mpix_iters_per_s": r, "default": (k, (th, tw)) == plans[0]})
                print(f"{family} double_buffer={double_buffer} k={k} tile {th}x{tw}: "
                      f"{r:.0f} Mpix-iters/s, smem {smem} B a block, {bpp:.1f} B a "
                      f"pixel-iteration{' (default plan)' if results[-1]['default'] else ''}",
                      flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "shape": SHAPE,
                      "iters": ITERS, "plans": results}), flush=True)


if __name__ == "__main__":
    main()
