#!/usr/bin/env python3
"""Device time of the tile kernel (``pde_tpu_torch/csrc/tiled_sor.cu``) over
its plans, on one CUDA card.

    python3 scripts/tiled_plan_sweep.py [--out FILE] [--check-only]
        [--families F ...] [--shapes NAME ...] [--default-only] [--no-check]
        [--root DIR]

First a check: the kernel of each family (``kernels/tiled.LAYOUTS``),
serial and double-buffered, at every slot count,
against the global kernel (``csrc/flow_llin4_sor.cu``,
``csrc/interior_sor.cu``) bit for bit, with and without NaN data, at small
and full shapes, several chunks, disp at a batch of 1 and 2, pde4 and pde8
at 1, 2 and 3 channels with TRACE and B per channel and shared; and through
the sharded solvers (the windowed variant) on virtual 2x2 and 1x4 meshes
of the card. Then, unless ``--check-only``, for each shape of ``SHAPES``
(1024x1024, 768x768, 1024x1024 with 2 systems or channels, and 1024x1024,
768x768, 576x576 and 481x641 with 3 channels for pde4 and pde8, TRACE and B a plane a channel, and the
top-left shard and halo of a 2x2 and a 1x4 mesh over 480x640, a window's
chunk, for the sharded families; ``--shapes`` picks some), each family,
every plan of ``kernels/tiled.py`` (k = 4, a tile of ``TILES``, 1 to 4
pairs of pixels a thread; only the default plan with ``--default-only``)
that the kernel takes: the device time of one 4-sweep
call (``REPS`` calls queued behind a ``torch.cuda._sleep``, between two
CUDA events, so the host's per-call cost is not counted), the blocks it
launches, and the default plan (``plan_tiles``) marked; and the global
kernel's time for the same 4 sweeps. The compiler's report (registers,
spills) is printed first. ``--root DIR`` times the package of another
checkout (an earlier commit unpacked with ``git archive``), so that two
versions can be timed in turns on one card. Exits non-zero without a CUDA
card; prints the card's name and power limit and, last, one JSON object of
every time.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

# (name, box (i0, i1, j0, j1) of the image's top-left shard or None for the
# whole image, image (gh, gw), systems or channels); a shard's array is the
# box and the family's halo below and to the right, clipped to the image
SHAPES = (("1024x1024", None, (1024, 1024), 1),
          ("768x768", None, (768, 768), 1),
          ("2x1024x1024", None, (1024, 1024), 2),
          ("3x1024x1024", None, (1024, 1024), 3),
          ("3x768x768", None, (768, 768), 3),
          ("3x576x576", None, (576, 576), 3),
          ("3x481x641", None, (481, 641), 3),
          ("2x2 shard", (0, 240, 0, 320), (480, 640), 1),
          ("1x4 shard", (0, 480, 0, 160), (480, 640), 1))
TILES = ((8, 16), (8, 32), (16, 16), (16, 24), (16, 32), (16, 48), (24, 32), (24, 48),
         (32, 32), (32, 48), (32, 64), (40, 32), (48, 48), (64, 48))
CHECK_SHAPES = ((1, 1), (1, 9), (9, 1), (3, 3), (37, 53), (480, 640), (481, 641), (768, 768),
                (1024, 1024))
REPS = 40
SLEEP_CYCLES = 40_000_000  # ~20 ms at the H100's clock: longer than the host's enqueue
NAN_NAMES = ("cu", "cv", "duc", "dvc", "trace")


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


def make_fields(rng, family, h, w, dev, nan: bool, batch: int = 1, shared: bool = True):
    """Unit-scale fields in the tile kernel's order (``FIELD_NAMES``), 5%
    NaN in Cu, Cv, Du, Dv and TRACE when ``nan``. With a ``batch``, the
    relaxed field (and every field of disp, or TRACE and B of pde unless
    ``shared``) has one plane a system; the other fields are shared."""
    from pde_tpu_torch.kernels import tiled_cuda

    names = tiled_cuda.FIELD_NAMES[family]
    out = []
    for i, n in enumerate(names):
        per_system = batch > 1 and (i == 0 or family == "disp_llin4"
                                    or (n in ("trace", "b") and not shared))
        shape = (batch, h, w) if per_system else (h, w)
        x = rng.random(shape)
        x = {"duc": x + 1.0, "dvc": x + 1.0, "trace": x + 1.0, "m": x * 0.01}.get(
            n, x + 0.1 if n.startswith("w") else x * 0.2)
        if nan and n in NAN_NAMES:
            x = np.where(rng.random(shape) < 0.05, np.nan, x)
        out.append(torch.from_numpy(x.astype(np.float32)).to(dev))
    return out


def global_solve(family, tf, iters):
    """The global kernel's solve of the same fields."""
    from pde_tpu_torch.kernels import interior_cuda, sor_cuda

    if family == "flow_llin4":
        du, dv, u, v, *rest = tf
        return sor_cuda.flow_llin4_sor(u, v, du, dv, *rest, iters, 1.9)
    if family == "flow_elin4":
        return sor_cuda.flow_elin4_sor(*tf, iters, 1.9)
    if family == "flow_llin8":
        du, dv, u, v, *rest = tf
        return sor_cuda.flow_llin8_sor(u, v, du, dv, *rest, iters, 1.9)
    if family == "disp_llin4":
        du, u, *rest = tf
        return (interior_cuda.disp_llin4_sor(u, du, *rest, iters, 1.9),)
    return (getattr(interior_cuda, f"{family}_sor")(*tf, iters, 1.9),)


def bits_equal(a, b) -> bool:
    torch.cuda.synchronize()
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))


def _max_diff(a, b) -> float:
    return max(float((x - y).abs().nan_to_num().max()) for x, y in zip(a, b))


def check(rng, dev, families) -> int:
    """The kernel against the global kernel, bit for bit, and against the
    plain tile schedule on the card (disp and pde: bit for bit too); the
    cases run."""
    from pde_tpu_torch.kernels import dispatch, sweeps, tiled
    from pde_tpu_torch.kernels.tiled_cuda import FLOW4
    from pde_tpu_torch.parallel import mesh as pmesh, tiled as ptiled

    cases = 0
    for h, w in CHECK_SHAPES:
        for family in families:
            layout = tiled.LAYOUTS[family]
            if layout.fill and min(h, w) < 3:
                continue  # W4: the global kernels take these shapes
            prep, sw = getattr(sweeps, f"{family}_sweep")(1.9)
            batches = [(1, True)] + ([(layout.max_batch, True)] if layout.max_batch > 1 else [])
            if family in ("pde4", "pde8") and (h, w) in ((37, 53), (481, 641)):
                batches += [(2, True), (2, False), (3, False)]
            for batch, shared in batches:
                for nan in (True, False):
                    for iters in (4, 5):
                        tf = make_fields(rng, family, h, w, dev, nan, batch, shared)
                        want = global_solve(family, tf, iters)
                        slot_counts = (1, 2, 3, 4) if (h, w) == (37, 53) else (None,)
                        for db in (False, True):
                            for slots in slot_counts:
                                kw = dict(double_buffer=db)
                                if slots is not None:
                                    kw["plan_override"] = (4, (8, 16), slots)
                                got = tiled.tiled_relax(tf, sw, layout.n_mut, iters,
                                                        prepare_fn=prep, **kw)
                                label = (f"{family} {h}x{w} batch={batch} shared={shared} "
                                         f"nan={nan} iters={iters} db={db} slots={slots}")
                                if not bits_equal(got, want):
                                    raise SystemExit(f"{label}: not the global kernel's bits "
                                                     f"(max |d| {_max_diff(got, want)})")
                                if family not in FLOW4 and not db and slots is None:
                                    # one tile the image's size: the schedule is exact
                                    with dispatch.plain_solvers():
                                        plain = tiled.tiled_relax(tf, sw, layout.n_mut, iters,
                                                                  prepare_fn=prep,
                                                                  plan_override=(4, (h, w)))
                                    d = _max_diff(got, plain)
                                    if layout.fill and not bits_equal(got, plain):
                                        raise SystemExit(f"{label}: not the plain schedule's "
                                                         f"bits (max |d| {d})")
                                    if d > 1e-5:
                                        raise SystemExit(f"{label}: {d} from the plain schedule")
                                cases += 1
        print(f"check {h}x{w}: {', '.join(families)} == global kernel bit for bit", flush=True)
    sharded = [f for f in families if f in ("flow_llin4", "flow_elin4", "flow_llin8",
                                            "disp_llin4", "pde4")]
    for ty, tx in ((2, 2), (1, 4)):
        mesh = pmesh.make_mesh(ty, tx, devices=[dev] * (ty * tx))
        for family in sharded:
            layout = tiled.LAYOUTS[family]
            tf = make_fields(rng, family, 480, 640, dev, True)
            factory = getattr(sweeps, f"{family}_sweep")
            for iters in (1, 2, 4, 9):
                want = global_solve(family, tf, iters)
                for db in (False, True):
                    got = ptiled.tiled_relax_sharded(mesh, factory, tf, layout.n_mut, iters, 1.9,
                                                     double_buffer=db)
                    if not bits_equal(got, want):
                        raise SystemExit(f"windowed {family} on a {ty}x{tx} mesh iters={iters} "
                                         f"db={db}: not the global kernel's bits "
                                         f"(max |d| {_max_diff(got, want)})")
                    cases += 1
        print(f"check {ty}x{tx} mesh over 480x640: windowed == global kernel bit for bit",
              flush=True)
    return cases


def make_plan(tiled, *args, batch: int):
    """``tiled.make_plan`` for ``batch`` systems (an earlier checkout's
    plan, whose slot held one system's planes, takes no batch)."""
    if "batch" in inspect.signature(tiled.make_plan).parameters:
        return tiled.make_plan(*args, batch=batch)
    return tiled.make_plan(*args)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, help="write the JSON object here too")
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--no-check", action="store_true", help="time without the check first")
    ap.add_argument("--families", nargs="+")
    ap.add_argument("--shapes", nargs="+", choices=[s[0] for s in SHAPES])
    ap.add_argument("--default-only", action="store_true",
                    help="time each shape's default plan only")
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent.parent,
                    help="the checkout whose pde_tpu_torch to time (default: this one)")
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    from pde_tpu_torch.kernels import tiled

    args.families = args.families or list(tiled.LAYOUTS)
    if not torch.cuda.is_available():
        sys.exit("no CUDA card: the tile kernel runs only on the card")
    from pde_tpu_torch.kernels import build, interior_cuda, sor_cuda, tiled_cuda

    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    build.build(tiled_cuda.SOURCE, verbose=True, force=True)
    for source in (sor_cuda.SOURCE, interior_cuda.SOURCE):
        build.build(source)
    rng = np.random.default_rng(args.seed)
    cases = 0 if args.no_check else check(rng, dev, args.families)
    print(f"check: {cases} cases bit for bit", flush=True)
    results = []
    if not args.check_only:
        for name, box, image, batch in SHAPES:
            if args.shapes and name not in args.shapes:
                continue
            bh, bw = image if box is None else (box[1] - box[0], box[3] - box[2])
            window = None if box is None else tiled.Window(0, 0, *image, box)
            for family in args.families:
                layout = tiled.LAYOUTS[family]
                if (batch > 1 and layout.max_batch < batch) or (
                        window is not None and family not in tiled_cuda.WINDOWED):
                    continue
                halo = 0 if box is None else tiled._halo_for(family, 4)
                # TRACE and B a plane a channel, as tv_denoise4/8 hand them over
                tf = make_fields(rng, family, min(bh + halo, image[0]), min(bw + halo, image[1]),
                                 dev, False, batch, shared=False)
                for db in (False, True):
                    default = tiled.plan_tiles(bh, bw, family, 4, 4, double_buffer=db,
                                               exact_k=box is not None, sm_count=sms,
                                               batch=batch)
                    if default is None:
                        continue
                    candidates = ([((default.tile_h, default.tile_w), default.slots)]
                                  if args.default_only else
                                  [(t, s) for t in TILES for s in (1, 2, 3, 4)])
                    for (th, tw), s in candidates:
                        plan = make_plan(tiled, bh, bw, family, 4, th, tw, s, db, batch=batch)
                        if plan is None:
                            continue
                        tiles = plan.n_tiles_h * plan.n_tiles_w
                        blocks = (layout.blocks(tiles, batch) if hasattr(layout, "blocks")
                                  else tiles * batch)
                        if window is None:
                            def fn():
                                return tiled_cuda.tiled_sor(family, tf, 4, 1.9, 4, th, tw, db, s)
                        else:
                            def fn():
                                return tiled_cuda.tiled_sor_window(family, tf, 4, 1.9, window,
                                                                   th, tw, db, s)
                        ms = device_ms(fn)
                        row = {"shape": name, "family": family, "double_buffer": db, "k": 4,
                               "tile": [th, tw], "slots": s, "threads": plan.threads,
                               "blocks": blocks,
                               "smem_bytes": plan.smem_bytes, "device_ms": ms,
                               "default": (plan.tile_h, plan.tile_w, plan.slots)
                               == (default.tile_h, default.tile_w, default.slots)}
                        results.append(row)
                        print(f"{name} {family} db={db} tile {th}x{tw} slots={s} threads "
                              f"{plan.threads} blocks {row['blocks']}: {ms:.4f} ms"
                              f"{' (default plan)' if row['default'] else ''}", flush=True)
                if window is None:
                    ms = device_ms(lambda: global_solve(family, tf, 4))
                    results.append({"shape": name, "family": family, "global": True,
                                    "device_ms": ms})
                    print(f"{name} {family} global kernel: {ms:.4f} ms", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    report = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi.stdout.strip(),
              "root": str(args.root), "check_cases": cases, "plans": results}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report))
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
