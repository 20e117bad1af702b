"""The benchmark of ``pde_tpu_torch`` on NVIDIA H100 cards.

    python3 bench_gpu/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` (``harness/session.py``) on the card
and prints its result as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and ``checks`` (each
number compared with the reference, beside its limit), and with
``--trace 1`` a ``breakdown`` of the traced requests. The numbers compared
are also the last lines of standard error.

It exits non-zero and prints no result where torch sees fewer CUDA cards
than the cell asks for, where the program is not in the checkout, or where
JAX or the JAX package ``pde_tpu`` was loaded in this process. Kernels are
built into the checkout (``pde_tpu_torch/_build``), so only a checkout's
first run compiles.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    # keep libraries from loading JAX on their own
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    # torch's run-time kernel caches at a fixed place in the checkout, so
    # that only a checkout's first run compiles (the port's own CUDA
    # libraries are built into pde_tpu_torch/_build)
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(ROOT / "bench_gpu" / "_cache" / "torch")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "bench_gpu" / "_cache" / "triton")
    sys.path.insert(0, str(ROOT))
    from bench_gpu.harness import card, cells, session

    cell = cells.resolve(cells.load_benchmark(ROOT), args.workload, ROOT)
    try:
        card.require(cell.chips)
    except card.NoCard as exc:
        print(f"bench_gpu: {exc}", file=sys.stderr)
        return 2
    out = session.run(cell, args.seed, args.seconds, bool(args.trace), start=START)
    loaded = card.forbidden_modules()
    if loaded:
        print(f"bench_gpu: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    device = card.describe(cell.chips, out.pop("memory_peak_bytes"))
    if args.trace:
        device["busy_s"] = out.pop("busy_s")
        device["window_s"] = out.pop("window_s")
    print(f"card: {device['power_limit']}, peak {device['memory_peak_bytes']} B", file=sys.stderr)
    out.pop("gaps")
    checks = out.pop("checks")
    result = {**out, "device": device, "checks": checks}
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
