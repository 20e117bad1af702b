#!/usr/bin/env python3
"""Device time of the tile kernel (``pde_tpu_torch/csrc/tiled_sor.cu``) over
its plans, on one CUDA card.

    python3 scripts/tiled_plan_sweep.py [--out FILE] [--check-only]
        [--parent-source OLD.cu]

First a check: the kernel, serial and double-buffered, at every slot
count, against the global kernel (``csrc/flow_llin4_sor.cu``) bit for bit,
NaN data, llin4 and elin4, at small and full shapes, several chunks, and
through the sharded solvers (the windowed variant) on virtual 2x2 and 1x4
meshes of the card. Then, unless ``--check-only``, for each shape of
``SHAPES`` (1024x1024, 768x768, and the top-left shard and halo of a 2x2
and a 1x4 mesh over 480x640, a window's chunk), each family, serial and
double-buffered, every plan of ``kernels/tiled.py`` (k = 4, a tile of
``TILES``, 1 to 4 pairs of pixels a thread) that the kernel takes: the
device time of one 4-sweep call (``REPS`` calls queued behind a
``torch.cuda._sleep``, between two CUDA events, so the host's per-call cost
is not counted), the blocks it launches (the pairs a thread set the
registers a thread, so the slots are also the blocks-an-SM knob), and the
default plan (``plan_tiles``) marked. ``--parent-source`` builds an earlier
``tiled_sor.cu`` (every field in shared memory, no ``slots`` argument) and
times its default plans in the same run. The compiler's report (registers,
spills) is printed first. Exits non-zero without a CUDA card; prints the
card's name and power limit and, last, one JSON object of every time.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# (name, array (h, w), box (i0, i1, j0, j1) or None for the whole array, image (gh, gw))
SHAPES = (("1024x1024", (1024, 1024), None, (1024, 1024)),
          ("768x768", (768, 768), None, (768, 768)),
          ("2x2 shard", (248, 328), (0, 240, 0, 320), (480, 640)),
          ("1x4 shard", (480, 168), (0, 480, 0, 160), (480, 640)))
TILES = ((8, 16), (8, 32), (16, 16), (16, 24), (16, 32), (16, 48), (24, 32), (24, 48),
         (32, 32), (32, 48), (32, 64), (40, 32), (48, 48), (64, 48))
CHECK_SHAPES = ((1, 1), (1, 9), (9, 1), (37, 53), (480, 640), (481, 641), (768, 768),
                (1024, 1024))
REPS = 40
SLEEP_CYCLES = 40_000_000  # ~20 ms at the H100's clock: longer than the host's enqueue
FIELDS = {"flow_llin4": 13, "flow_elin4": 11}


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


def make_fields(rng, family, h, w, dev, nan: bool):
    """Unit-scale fields in the tile kernel's order, 5% NaN in Cu, Cv, Du
    and Dv when ``nan``."""
    names = ("du", "dv", "u", "v") if family == "flow_llin4" else ("u", "v")
    names += ("m", "cu", "cv", "duc", "dvc", "ww", "wn", "we", "ws")
    out = []
    for n in names:
        x = rng.random((h, w))
        x = {"duc": x + 1.0, "dvc": x + 1.0, "m": x * 0.01}.get(
            n, x + 0.1 if n.startswith("w") else x * 0.2)
        if nan and n in ("cu", "cv", "duc", "dvc"):
            x = np.where(rng.random((h, w)) < 0.05, np.nan, x)
        out.append(torch.from_numpy(x.astype(np.float32)).to(dev))
    return out


def global_solve(family, tf, iters):
    from pde_tpu_torch.kernels import sor_cuda

    if family == "flow_llin4":
        du, dv, u, v, *rest = tf
        return sor_cuda.flow_llin4_sor(u, v, du, dv, *rest, iters, 1.9)
    return sor_cuda.flow_elin4_sor(*tf, iters, 1.9)


def bits_equal(a, b) -> bool:
    torch.cuda.synchronize()
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))


def check(rng, dev) -> int:
    """The kernel against the global kernel, bit for bit; the cases run."""
    from pde_tpu_torch.kernels import sweeps, tiled
    from pde_tpu_torch.parallel import mesh as pmesh, tiled as ptiled

    cases = 0
    for h, w in CHECK_SHAPES:
        for family in FIELDS:
            for iters in (4, 5):
                tf = make_fields(rng, family, h, w, dev, True)
                want = global_solve(family, tf, iters)
                prep, sw = getattr(sweeps, f"{family}_sweep")(1.9)
                slot_counts = (1, 2, 3, 4) if (h, w) == (37, 53) else (None,)
                for db in (False, True):
                    for slots in slot_counts:
                        kw = dict(double_buffer=db)
                        if slots is not None:
                            kw["plan_override"] = (4, (8, 16), slots)
                        got = tiled.tiled_relax(tf, sw, 2, iters, prepare_fn=prep, **kw)
                        if not bits_equal(got, want):
                            d = max(float((a - b).abs().nan_to_num().max())
                                    for a, b in zip(got, want))
                            raise SystemExit(f"{family} {h}x{w} iters={iters} db={db} "
                                             f"slots={slots}: not the global kernel's bits "
                                             f"(max |d| {d})")
                        cases += 1
        print(f"check {h}x{w}: llin4 and elin4, serial and double-buffered == global kernel "
              f"bit for bit", flush=True)
    for ty, tx in ((2, 2), (1, 4)):
        mesh = pmesh.make_mesh(ty, tx, devices=[dev] * (ty * tx))
        for family in FIELDS:
            tf = make_fields(rng, family, 480, 640, dev, True)
            factory = getattr(sweeps, f"{family}_sweep")
            for iters in (4, 9):
                want = global_solve(family, tf, iters)
                for db in (False, True):
                    got = ptiled.tiled_relax_sharded(mesh, factory, tf, 2, iters, 1.9,
                                                     double_buffer=db)
                    if not bits_equal(got, want):
                        raise SystemExit(f"windowed {family} on a {ty}x{tx} mesh iters={iters} "
                                         f"db={db}: not the global kernel's bits")
                    cases += 1
        print(f"check {ty}x{tx} mesh over 480x640: windowed == global kernel bit for bit",
              flush=True)
    return cases


def old_plan(h, w, n_fields, double_buffer):
    """The earlier kernel's default plan (64-column tiles as tall as one
    slot of every field and a flag byte allows, k = 4)."""
    budget = 232_448 // (2 if double_buffer else 1)
    tile_w = min(64, -(-w // 8) * 8)
    best = None
    for th in range(8, min(128, -(-h // 8) * 8) + 1, 8):
        px = (th + 16) * (tile_w + 16)
        if (n_fields * 4 * px + px + 15) // 16 * 16 <= budget:
            best = th
    return 4, best, tile_w


def parent_runner(source: Path):
    """Build an earlier tiled_sor.cu and return a call of its entry points
    (the interface without ``slots``)."""
    from pde_tpu_torch.kernels import build

    out = Path(tempfile.mkdtemp()) / "libtiled_parent.so"
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(source)],
                   check=True)
    lib = ctypes.CDLL(str(out))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for family, n in FIELDS.items():
        getattr(lib, f"tiled_{family}").argtypes = [p] * (n + 4) + [i] * 7 + [f, f, p]
        getattr(lib, f"tiled_{family}_win").argtypes = [p] * (n + 2) + [i] * 14 + [f, f, p]

    def run(family, tf, box, image, plan, db):
        h, w = tf[0].shape
        k, th, tw = plan
        stream = torch.cuda.current_stream().cuda_stream
        if box is None:
            out = [torch.empty_like(x) for x in tf[:2]]
            err = getattr(lib, f"tiled_{family}")(*(x.data_ptr() for x in tf),
                                                  *(x.data_ptr() for x in out), None, None,
                                                  h, w, 4, k, th, tw, int(db), 1.9, -0.9, stream)
        else:
            i0, i1, j0, j1 = box
            out = [tf[0].new_empty((i1 - i0, j1 - j0)) for _ in range(2)]
            err = getattr(lib, f"tiled_{family}_win")(
                *(x.data_ptr() for x in tf), *(x.data_ptr() for x in out), h, w, 0, 0,
                *image, i0, j0, i1 - i0, j1 - j0, 4, th, tw, int(db), 1.9, -0.9, stream)
        if err:
            raise RuntimeError(f"parent tiled_{family}: cudaError {err}")
        return out

    return run


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, help="write the JSON object here too")
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--parent-source", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA card: the tile kernel runs only on the card")
    from pde_tpu_torch.kernels import build, tiled, tiled_cuda

    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    build.build(tiled_cuda.SOURCE, verbose=True, force=True)
    rng = np.random.default_rng(args.seed)
    cases = check(rng, dev)
    print(f"check: {cases} cases bit for bit", flush=True)
    results = []
    if not args.check_only:
        parent = parent_runner(args.parent_source) if args.parent_source else None
        for name, (h, w), box, image in SHAPES:
            bh, bw = (h, w) if box is None else (box[1] - box[0], box[3] - box[2])
            window = None if box is None else tiled.Window(0, 0, *image, box)
            for family, n_fields in FIELDS.items():
                tf = make_fields(rng, family, h, w, dev, False)
                for db in (False, True):
                    default = tiled.plan_tiles(bh, bw, n_fields, 4, 4, double_buffer=db,
                                               exact_k=box is not None, sm_count=sms)
                    plans = [(4, t, s) for t in TILES for s in (1, 2, 3, 4)]
                    for k, (th, tw), s in plans:
                        plan = tiled.make_plan(bh, bw, n_fields, k, th, tw, s, db)
                        if plan is None:
                            continue
                        if window is None:
                            def fn():
                                return tiled_cuda.tiled_flow_sor(family, tf, 4, 1.9, k, th, tw,
                                                                 db, s)
                        else:
                            def fn():
                                return tiled_cuda.tiled_flow_sor_window(family, tf, 4, 1.9,
                                                                        window, th, tw, db, s)
                        ms = device_ms(fn)
                        row = {"shape": name, "family": family, "double_buffer": db, "k": k,
                               "tile": [th, tw], "slots": s, "threads": plan.threads,
                               "blocks": plan.n_tiles_h * plan.n_tiles_w,
                               "smem_bytes": plan.smem_bytes, "device_ms": ms,
                               "default": (plan.k, plan.tile_h, plan.tile_w, plan.slots)
                               == (default.k, default.tile_h, default.tile_w, default.slots)}
                        results.append(row)
                        print(f"{name} {family} db={db} tile {th}x{tw} slots={s} threads "
                              f"{plan.threads} blocks {row['blocks']}: {ms:.4f} ms"
                              f"{' (default plan)' if row['default'] else ''}", flush=True)
                    if parent is not None:
                        op = old_plan(bh, bw, n_fields, db)
                        ms = device_ms(lambda: parent(family, tf, box, image, op, db))
                        results.append({"shape": name, "family": family, "double_buffer": db,
                                        "parent": True, "k": op[0], "tile": list(op[1:]),
                                        "device_ms": ms})
                        print(f"{name} {family} db={db} parent tile {op[1]}x{op[2]}: "
                              f"{ms:.4f} ms", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    report = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi.stdout.strip(),
              "check_cases": cases, "plans": results}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report))
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
