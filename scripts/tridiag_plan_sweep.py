#!/usr/bin/env python3
"""Device time of the tridiagonal line-solve kernel (``pde_tpu_torch/csrc/tridiag.cu``)
over launch plans, on one CUDA card.

    python3 scripts/tridiag_plan_sweep.py [--seed N] [--parent-source OLD.cu] [--out FILE]

For a zebra parity solve, a whole solve and the fused zebra pass (scalar
and coupled, 4 neighbours), along both axes at 481x641 and 1024x1024,
every plan (G lines a block, R elements a chunk, S stages) whose shared
memory fits a block: the device time of one launch, with the default plan
(``kernels/tdma_cuda.py::plan_lines``) marked. Device time: ``REPS``
launches queued behind a ``torch.cuda._sleep`` that keeps the card busy
while the host enqueues them, between two CUDA events, so the host's
per-call cost is not counted. With ``--parent-source``, an earlier
``tridiag.cu`` (one thread a line, the C interface without plans) is built
with the same flags and its parity and whole solves timed the same way in
the same run. Exits non-zero without a CUDA card; prints the card's name
and power limit and, last, one JSON object of every time.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SHAPES = ((481, 641), (1024, 1024))
GS = (1, 2, 4, 8)
RS = (32, 64)
SS = (2, 3)
REPS = 40
SLEEP_CYCLES = 40_000_000  # ~20 ms at the H100's clock: longer than the host's enqueue


def device_ms(fn, reps: int = REPS) -> float:
    """Device ms per call of ``fn``: ``reps`` calls queued behind a sleep
    kernel, timed between two events on the card."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def parent_lib(source: Path):
    """Build an earlier tridiag.cu (the interface of one thread a line) and
    bind its three entry points."""
    from pde_tpu_torch.kernels import build

    out = Path(tempfile.mkdtemp()) / "libtridiag_parent.so"
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(source)],
                   check=True)
    lib = ctypes.CDLL(str(out))
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.tridiag_thomas.argtypes = [p] * 6 + [q, q, q, i, i, i, i, p]
    lib.tridiag_factor.argtypes = [p] * 5 + [q, q, q, i, i, i, i, p]
    lib.tridiag_solve.argtypes = [p] * 5 + [q, q, i, i, i, i, i, p]
    return lib


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent-source", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA card: the tridiagonal kernel runs only on the card")
    from pde_tpu_torch.kernels import tdma_cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    old = parent_lib(args.parent_source) if args.parent_source else None
    results = []

    def field(shape, lo, hi):
        return torch.from_numpy((rng.random(shape) * (hi - lo) + lo).astype(np.float32)).to(dev)

    for (h, w), axis in itertools.product(SHAPES, (-2, -1)):
        vertical = axis == -2
        a, c = field((h, w), -0.5, -0.1), field((h, w), -0.5, -0.1)
        b = a.abs() + c.abs() + field((h, w), 0.5, 1.5)
        d, z, z_o, m = (field((h, w), -1, 1), field((h, w), -1, 1), field((h, w), -1, 1),
                        field((h, w), 0, 0.01))
        w_lo, w_hi = field((h, w), 0.1, 1.1), field((h, w), 0.1, 1.1)
        fac = tdma_cuda.tridiag_factor(a, b, c, axis)
        cases = {
            "parity": ("solve", False, lambda pl: tdma_cuda.tridiag_solve(fac, d, 0, plan=pl)),
            "whole": ("thomas", False,
                      lambda pl: tdma_cuda.thomas_solve(a, b, c, d, axis, plan=pl)),
            "zebra": ("zebra", False,
                      lambda pl: tdma_cuda.zebra_pass(fac, z, d, w_lo, w_hi, 0, plan=pl)),
            "zebra coupled": ("zebra", True, lambda pl: tdma_cuda.zebra_pass(
                fac, z, d, w_lo, w_hi, 0, z_o, m, plan=pl)),
        }
        for case, (mode, coupled, run) in cases.items():
            default = tdma_cuda.plan_lines(1, h, w, vertical, 0 if mode != "thomas" else None,
                                           mode, coupled)
            best = None
            for g, r, s in itertools.product(GS, RS, SS):
                length = h if vertical else w
                if tdma_cuda.smem_bytes(mode, length, g, r, s, coupled) > tdma_cuda.MAX_SMEM:
                    continue
                ms = device_ms(lambda: run((g, r, s)))
                is_default = (g, r, s) == (default.g, default.r, default.stages)
                results.append({"shape": [h, w], "axis": axis, "case": case, "g": g, "r": r,
                                "stages": s, "device_ms": ms, "default": is_default})
                if best is None or ms < best[0]:
                    best = (ms, g, r, s)
                if is_default:
                    dflt = ms
            print(f"{h}x{w} axis={axis} {case}: default G={default.g} R={default.r} "
                  f"S={default.stages} {dflt:.5f} ms; best G={best[1]} R={best[2]} S={best[3]} "
                  f"{best[0]:.5f} ms", flush=True)
        if old is not None:
            stream = torch.cuda.current_stream().cuda_stream
            cp, dn = torch.empty_like(d), torch.empty_like(d)
            old.tridiag_factor(a.data_ptr(), b.data_ptr(), c.data_ptr(), cp.data_ptr(),
                               dn.data_ptr(), 0, 0, 0, 1, h, w, int(vertical), stream)
            n_sel = len(range(0, w if vertical else h, 2))
            xp = torch.empty((h, n_sel) if vertical else (n_sel, w), device=dev)
            xw, scratch = torch.empty_like(d), torch.empty_like(d)
            t_par = device_ms(lambda: old.tridiag_solve(
                a.data_ptr(), cp.data_ptr(), dn.data_ptr(), d.data_ptr(), xp.data_ptr(), 0, 0, 1,
                h, w, int(vertical), 0, stream))
            t_whole = device_ms(lambda: old.tridiag_thomas(
                a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(), scratch.data_ptr(),
                xw.data_ptr(), 0, 0, 0, 1, h, w, int(vertical), stream))
            new_par = tdma_cuda.tridiag_solve(fac, d, 0)
            torch.cuda.synchronize()
            same = torch.equal(new_par, xp)
            results.append({"shape": [h, w], "axis": axis, "case": "parent", "parity_ms": t_par,
                            "whole_ms": t_whole, "parity_equal": same})
            print(f"{h}x{w} axis={axis} parent kernel: parity {t_par:.5f} ms, whole "
                  f"{t_whole:.5f} ms; new parity solve == parent's bit for bit: {same}",
                  flush=True)
    report = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "results": results}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report))
    print(smi, flush=True)
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
