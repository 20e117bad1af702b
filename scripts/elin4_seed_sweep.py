#!/usr/bin/env python3
"""The resident elin4 kernel against its plain version over many draws,
beside the plain version's own rounding spread, on one CUDA card.

    python3 scripts/elin4_seed_sweep.py [--seeds N] [--first S] [--out FILE]

For each seed S .. S + N - 1 (default 0 .. 23), a generator of its own
draws ``chip_smoke.py``'s elin4 fields (unit scale, 5% NaN in Cu and Du or
none) at every level of ``flow_hs``'s pyramid over a 3x480x640 frame (20
sweeps a call, as ``flow_hs`` ``solver=1`` calls it) and of ``flow_fmg``'s
(4 sweeps, as its smoother calls it). Each draw is solved three ways: the
resident kernel (``kernels/resident_cuda.flow_elin4_sor``), the plain
version (``solvers/sor.sor_flow_elin4``) in float32, and the same plain
arithmetic in float64 on the card. Reported per case, over the pixels
where the float64 solve is finite:

* ``err``: max |kernel - plain float32|, what ``chip_smoke.py`` bounds;
* ``spread``: max |plain float32 - plain float64|, how far float32
  rounding alone moves the plain version (its reordering by FMA
  contraction is the kernel's only difference, ``csrc/flow_update.cuh``);
* ``err64``: max |kernel - plain float64|.

A kernel that computed other arithmetic than the plain version would
stand further from the float64 solve than the float32 plain version does
(``err64`` >> ``spread``); a kernel that rounds otherwise but computes the
same function stands as far (``err64 / spread`` about 1, ``err / spread``
at most about 2). Prints a line a seed, the largest ratios over every
case, the card's name and power limit, and, last, one JSON object of
every case. Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

MAIN_SHAPE = (3, 480, 640)
OMEGA = 1.9


def max_abs(a, b, finite) -> float:
    return float(torch.where(finite, (a.double() - b.double()).abs(), 0.0).max())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=24)
    ap.add_argument("--first", type=int, default=0)
    ap.add_argument("--out", type=Path, help="write the JSON object here too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA card: the resident kernel runs only on the card")
    import chip_smoke
    from pde_tpu_torch.core.pyramid import pyramid_scales
    from pde_tpu_torch.kernels import build, resident_cuda
    from pde_tpu_torch.models.flow_fmg import FlowFMGParams
    from pde_tpu_torch.models.flow_hs import FlowHSParams
    from pde_tpu_torch.solvers import sor

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    build.build(resident_cuda.SOURCE)
    sms = resident_cuda.sm_count(0)
    hp, fp = FlowHSParams(), FlowFMGParams()
    levels = ([("flow_hs", hw, hp.iter)
               for hw in pyramid_scales(*MAIN_SHAPE[1:], hp.scl_factor, 20, hp.scales)]
              + [("flow_fmg", hw, fp.iter) for hw in chip_smoke.fmg_levels(MAIN_SHAPE)])
    levels = [(m, hw, it) for m, hw, it in levels
              if resident_cuda.plan_resident(*hw, "elin4", 1, sms) is not None]
    cases = []
    for seed in range(args.first, args.first + args.seeds):
        rng = np.random.default_rng(seed)
        worst = {"err": 0.0, "spread": 0.0, "err64": 0.0}
        for model, (h, w), iters in levels:
            for nan in (False, True):
                fields = chip_smoke.elin_fields(rng, h, w, nan, dev)
                got = resident_cuda.flow_elin4_sor(*fields, iters, OMEGA)
                p32 = sor.sor_flow_elin4(*fields, iters, OMEGA)
                p64 = sor.sor_flow_elin4(*(x.double() for x in fields), iters, OMEGA)
                torch.cuda.synchronize()
                case = {"seed": seed, "model": model, "shape": [h, w], "iters": iters,
                        "nan": nan, "err": 0.0, "spread": 0.0, "err64": 0.0}
                for g, a, b in zip(got, p32, p64):
                    finite = torch.isfinite(b)
                    if not torch.equal(torch.isfinite(g), finite):
                        sys.exit(f"seed {seed} {model} {h}x{w} nan={nan}: the kernel is "
                                 f"non-finite at other pixels than the float64 solve")
                    case["err"] = max(case["err"], max_abs(g, a, finite))
                    case["spread"] = max(case["spread"], max_abs(a, b, finite))
                    case["err64"] = max(case["err64"], max_abs(g, b, finite))
                cases.append(case)
                for key in worst:
                    worst[key] = max(worst[key], case[key])
        print(f"seed {seed}: err {worst['err']:.3g}, spread {worst['spread']:.3g}, "
              f"err64 {worst['err64']:.3g} (max over {2 * len(levels)} cases)", flush=True)
    spread_cases = [c for c in cases if c["spread"] > 0]
    ratio = max(c["err"] / c["spread"] for c in spread_cases)
    ratio64 = max(c["err64"] / c["spread"] for c in spread_cases)
    top = max(cases, key=lambda c: c["err"])
    print(f"over {len(cases)} cases: max err {top['err']:.4g} (seed {top['seed']} {top['model']} "
          f"{top['shape'][0]}x{top['shape'][1]} nan={top['nan']}, spread there "
          f"{top['spread']:.4g}); max spread {max(c['spread'] for c in cases):.4g}; "
          f"max err / spread {ratio:.3f}; max err64 / spread {ratio64:.3f}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    report = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi.stdout.strip(),
              "levels": [[m, list(hw), it] for m, hw, it in levels], "cases": cases,
              "max_err_over_spread": ratio, "max_err64_over_spread": ratio64}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report))
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
