#!/usr/bin/env python3
"""Device time of the resident SOR kernels (``pde_tpu_torch/csrc/resident_sor.cu``,
``resident8_sor.cu``) over launch plans, beside the global kernels, on one
CUDA card.

    python3 scripts/resident_plan_sweep.py [--seed N] [--reps N] [--out FILE]
        [--families llin4 disp pde4 elin4 llin8 pde8]

At every level shape of ``flow_nd``'s pyramid (llin4, B = 1), of the
stereo pyramid (disp llin4, B = 1 and 2), of ``tv_denoise4``'s (pde4,
C = 1 and 3 over shared weights), of ``flow_hs``'s (elin4, the same levels
as ``flow_nd``'s), of ``flow_ad``'s (llin8, the same again) and of
``tv_denoise8``'s (pde8, C = 1 and 3 over shared weights) at 3x480x640,
iters = 4 with 5% NaN in Cu and Du (TRACE for pde4 and pde8): every plan
the kernel takes among a few scopes and band counts (for each scope and
slots a thread the fewest bands, and the most bands a cluster and the grid
take), each held against the global kernel bit for bit (disp, pde4 and
pde8 also against the plain version), and timed beside the global kernel
(``flow_llin4_sor.cu``, ``interior_sor.cu``) and, for llin4, the tile
kernel with k = iters
(``tiled_sor.cu``, one launch). Times: device ms a call, ``REPS`` calls queued behind a
``torch.cuda._sleep`` between two CUDA events (so the host's per-call cost
is not counted), taken in turns (global, every plan, every plan again in
reverse, global); and the profiler's device time a call of the default
plan (``kernels/resident_cuda.py::plan_resident``) and of the global
kernel; the default plan also at iters 0 and 8 (a call's fixed cost and
its cost a sweep). A plan the card refuses (a cluster it cannot schedule) is
recorded as refused. Prints ``nvcc -Xptxas -v`` for the resident sources
(registers, spills), the card's name and power limit and, last, one JSON
object of every result; exits non-zero without a card or if any plan
disagrees with the global kernel.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

REPS = 40
SLEEP_CYCLES = 40_000_000  # ~20 ms at the H100's clock: longer than the host's enqueue
ITERS, OMEGA = 4, 1.9
SHAPE = (480, 640)
# (family, batches, the levels: flow_nd's, flow_hs's and flow_ad's pyramid
# stops at 20 px, the stereo models' at 10; tv_denoise4's and tv_denoise8's
# are partial, down to 0.5 and 0.75 of the image)
CASES = (("llin4", (1,), 20), ("disp", (1, 2), 10), ("pde4", (1, 3), ("partial", 0.5)),
         ("elin4", (1,), 20), ("llin8", (1,), 20), ("pde8", (1, 3), ("partial", 0.75)))


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


def profiled_ms(fn, calls: int = 20) -> float:
    """The profiler's device time a call (kernels and copies)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / calls


def bit_equal(got, want) -> bool:
    return all(torch.equal(g.view(torch.int32), w.view(torch.int32)) for g, w in zip(got, want))


def fields(rng, family: str, batch: int, h: int, w: int, dev):
    """Unit-scale solver fields as chip_smoke.py makes them, 5% NaN in Cu
    and Du; disp (H, W) per system, ``batch`` systems."""
    names = (("u", "v", "du", "dv", "m", "cu", "cv", "duc", "dvc", "ww", "wn", "we", "ws")
             if family == "llin4" else ("u", "du", "cu", "duc", "ww", "wn", "we", "ws"))
    sets = []
    for _ in range(batch):
        out = []
        for n in names:
            if n in ("duc", "dvc"):
                x = rng.random((h, w)) + 1.0
            elif n == "m":
                x = rng.random((h, w)) * 0.01
            elif n.startswith("w"):
                x = rng.random((h, w)) + 0.1
            else:
                x = rng.random((h, w)) * 0.2
            if n in ("cu", "duc"):
                x = np.where(rng.random((h, w)) < 0.05, np.nan, x)
            out.append(torch.from_numpy(x.astype(np.float32)).to(dev))
        sets.append(out)
    return sets


def candidates(resident_cuda, family: str, batch: int, h: int, w: int, sms: int):
    """The default plan first, then the others of ``plans_resident`` (for
    each scope and slots a thread, the fewest bands), and the most bands a
    cluster and the grid take, once each."""
    plans = [resident_cuda.plan_resident(h, w, family, batch, sms)]
    plans += resident_cuda.plans_resident(h, w, family, batch, sms)
    grid_bands = sms // batch if family == "disp" else sms  # pde channels share a block
    plans += [resident_cuda.plan_with_bands(h, w, family, batch, n, sms)
              for n in (resident_cuda.MAX_CLUSTER, grid_bands)]
    out = []
    for p in plans:
        if p is not None and p not in out:
            out.append(p)
    return out


def build_all(build, verbose, sources, report: Path | None) -> None:
    """Build the sources, those of ``verbose`` with ``-Xptxas -v``: their
    registers, stack and spills are printed (each kernel on one line) and,
    in full, written to ``report``."""
    import contextlib
    import io
    import re

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        for name in verbose:
            build.build(name, verbose=True, force=True)
    text = buf.getvalue()
    if report:
        report.parent.mkdir(parents=True, exist_ok=True)
        report.write_text(text)
    for name, body in re.findall(r"Compiling entry function '(\w+)'.*?\n(.*?)(?=ptxas info\s+: "
                                 r"Compiling|\Z)", text, re.S):
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes "
                          r"spill loads", body)
        print(f"ptxas {name}: {regs.group(1) if regs else '?'} registers, "
              + (f"{spill.group(1)} B stack, {spill.group(2)} B spill stores, "
                 f"{spill.group(3)} B spill loads" if spill else "no stack line"), flush=True)
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build.build, sources))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON here")
    ap.add_argument("--ptxas", type=Path, default=None,
                    help="write the resident source's -Xptxas -v report here")
    ap.add_argument("--sass", type=Path, default=None,
                    help="write the resident libraries' SASS (cuobjdump -sass) here")
    ap.add_argument("--families", nargs="+", default=[c[0] for c in CASES],
                    choices=[c[0] for c in CASES])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA card: the resident kernel runs only on the card")
    from pde_tpu_torch.core.pyramid import pyramid_scales
    from pde_tpu_torch.kernels import (build, interior_cuda, resident_cuda, sor_cuda, sweeps,
                                       tiled, tiled_cuda)
    from pde_tpu_torch.solvers import sor as plain_sor

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    verbose = (resident_cuda.SOURCE, resident_cuda.SOURCE8)
    build_all(build, verbose, (sor_cuda.SOURCE, interior_cuda.SOURCE, tiled_cuda.SOURCE),
              args.ptxas)
    if args.sass:
        cuobjdump = Path(build.find_nvcc()).with_name("cuobjdump")
        text = ""
        for name in verbose:
            sass = subprocess.run([str(cuobjdump), "-sass", str(build.library_path(name))],
                                  capture_output=True, text=True)
            text += sass.stdout + sass.stderr
        args.sass.write_text(text)
    # chip_smoke.py's field makers and tv_denoise's pyramid rule
    spec = importlib.util.spec_from_file_location("smoke_helpers", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dev = torch.device("cuda", 0)
    sms = resident_cuda.sm_count(0)
    rng = np.random.default_rng(args.seed)
    dms = partial(device_ms, reps=args.reps)
    results, wrong = [], []
    llin_prep, llin_sw = sweeps.flow_llin4_sweep(OMEGA)

    for family, batches, stop in CASES:
        if family not in args.families:
            continue
        levels = (smoke.partial_pyramid_shapes(SHAPE, stop[1], 0.75) if isinstance(stop, tuple)
                  else pyramid_scales(*SHAPE, 0.75, stop))
        for batch in batches:
            for h, w in levels:
                tile = plain = None
                if family == "llin8":
                    f = smoke.llin8_fields(rng, h, w, True, dev)
                    glob = partial(sor_cuda.flow_llin8_sor, *f, ITERS, OMEGA)
                    run = lambda plan, it=ITERS, f=f: resident_cuda.flow_llin8_sor(
                        *f, it, OMEGA, plan=plan)
                elif family in ("pde4", "pde8"):
                    f = getattr(smoke, f"{family}_fields")(rng, batch, h, w, True, dev)
                    glob = partial(getattr(interior_cuda, f"{family}_sor"), *f, ITERS, OMEGA)
                    run = lambda plan, it=ITERS, f=f, k=getattr(resident_cuda, f"{family}_sor"): (
                        k(*f, it, OMEGA, plan=plan),)
                    plain = getattr(plain_sor, f"sor_{family}")(*f, ITERS, OMEGA)
                elif family == "elin4":
                    f = smoke.elin_fields(rng, h, w, True, dev)
                    glob = partial(sor_cuda.flow_elin4_sor, *f, ITERS, OMEGA)
                    run = lambda plan, it=ITERS, f=f: resident_cuda.flow_elin4_sor(
                        *f, it, OMEGA, plan=plan)
                elif family == "llin4":
                    sets = fields(rng, family, batch, h, w, dev)
                    f = sets[0]
                    glob = partial(sor_cuda.flow_llin4_sor, *f, ITERS, OMEGA)
                    run = lambda plan, it=ITERS, f=f: resident_cuda.flow_llin4_sor(
                        *f, it, OMEGA, plan=plan)
                    tf = tuple(f[2:4]) + tuple(f[:2]) + tuple(f[4:])
                    tile = partial(tiled.tiled_relax, tf, llin_sw, 2, ITERS, k_max=ITERS,
                                   prepare_fn=llin_prep)
                else:
                    sets = fields(rng, family, batch, h, w, dev)
                    stacked = [torch.stack(c) for c in zip(*sets)] if batch == 2 else sets[0]
                    glob = partial(interior_cuda.disp_llin4_sor, *stacked, ITERS, OMEGA)
                    if batch == 2:
                        run = lambda plan, it=ITERS, s=sets: resident_cuda.disp_llin4_pair(
                            s[0], s[1], it, OMEGA, plan=plan)
                    else:
                        run = lambda plan, it=ITERS, s=stacked: (resident_cuda.disp_llin4_sor(
                            *s, it, OMEGA, plan=plan),)
                    plain = plain_sor.sor_disp_llin4(*stacked, ITERS, OMEGA)
                want = glob()
                want = (want if isinstance(want, tuple)
                        else tuple(want) if family == "disp" and batch == 2 else (want,))
                plans, rows = candidates(resident_cuda, family, batch, h, w, sms), []
                for plan in plans:
                    try:
                        got = run(plan)
                        torch.cuda.synchronize()
                    except RuntimeError as e:
                        rows.append({"plan": vars(plan), "refused": str(e)})
                        continue
                    same = bit_equal(got, want)
                    if plain is not None:
                        same = same and bit_equal(
                            got, tuple(plain) if family == "disp" and batch == 2 else (plain,))
                    if not same:
                        wrong.append((family, batch, h, w, plan))
                    rows.append({"plan": vars(plan), "bit_equal": same,
                                 "fn": partial(run, plan)})
                ok = [r for r in rows if "fn" in r]
                g1 = dms(glob)
                t1 = [dms(r["fn"]) for r in ok]
                t2 = [dms(r["fn"]) for r in ok[::-1]][::-1]
                g2 = dms(glob)
                tile_ms = dms(tile) if tile else None
                for r, a, b in zip(ok, t1, t2):
                    r["device_ms"] = [a, b]
                default = next((r for r in ok if r["plan"] == vars(plans[0])), None)
                prof = {"global": profiled_ms(glob)}
                if default:
                    prof["default"] = profiled_ms(default["fn"])
                    # a call's fixed cost and its cost a sweep: iters 0, 4, 8
                    default["iters_ms"] = {it: dms(partial(run, plans[0], it))
                                           for it in (0, ITERS, 2 * ITERS)}
                for r in ok:
                    del r["fn"]
                best = min(ok, key=lambda r: sum(r["device_ms"])) if ok else None
                results.append({"family": family, "batch": batch, "shape": [h, w],
                                "global_ms": [g1, g2], "tile_ms": tile_ms, "profiler_ms": prof,
                                "plans": rows})
                dflt = (f"{default['plan']['scope']} x{default['plan']['blocks']} "
                        f"{sum(default['device_ms']) / 2:.5f} ms" if default else "refused")
                print(f"{family} B={batch} {h}x{w}: global {g1:.5f} / {g2:.5f} ms"
                      + (f", tile {tile_ms:.5f} ms" if tile_ms else "")
                      + f"; default {dflt}; best "
                      + (f"{best['plan']['scope']} x{best['plan']['blocks']} "
                         f"{sum(best['device_ms']) / 2:.5f} ms" if best else "none")
                      + f"; profiler {prof}; {len(ok)} plans ran, "
                      + f"{sum(1 for r in rows if 'refused' in r)} refused, "
                      + f"all bit-equal: {all(r['bit_equal'] for r in ok)}", flush=True)
    report = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "iters": ITERS,
              "results": results}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report))
    print(smi, flush=True)
    print(json.dumps(report), flush=True)
    if wrong:
        sys.exit(f"plans that disagree with the global kernel: {wrong}")


if __name__ == "__main__":
    main()
