"""The readings the comparison's limits are set from, on the card.

    python3 bench_gpu/calibrate.py --workload <cell> --seeds 1 2 ... \\
        --control-seeds 7 8 9 --seconds 3 --out limits.jsonl

For each of ``--seeds``, one run of the cell as ``run.py`` makes it, with a
window of ``--seconds``: the gaps of the fields the window returned
against the reference (the sound runs' readings). For each of
``--control-seeds``, the control: the reference computed with its resize
products in TF32, one step below the configurations' float32 with TF32
off, put in the program's place and judged the same way. One line of JSON
a seed, to standard output and to ``--out``. The limits in the
configuration lie between the largest sound reading and the smallest
control reading.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", type=Path)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from bench_gpu.harness import card, cells, judge, scene, session

    cell = cells.resolve(cells.load_benchmark(ROOT), args.workload, ROOT)
    card.require(cell.chips)
    with contextlib.ExitStack() as stack:
        out = stack.enter_context(open(args.out, "a")) if args.out else None

        def emit(record):
            line = json.dumps(record)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()

        start = START
        for seed in args.seeds:
            res = session.run(cell, seed, args.seconds, False, start=start)
            emit({"workload": cell.name, "kind": "program", "seed": seed, "correct": res["correct"],
                  "attempted": res["attempted"], "gaps": res["gaps"],
                  "metrics": {k: v["value"] for k, v in res["metrics"].items()}})
            start = None
        dev = torch.device("cuda", 0)
        names = list(judge.STATISTICS)
        for seed in args.control_seeds:
            traffic = cell.traffic
            ring = scene.make_ring(cell.config["scene"], cell.config["frame"], int(traffic["ring"]),
                                   seed, dev, int(traffic.get("frames", 2)))
            judged = scene.seed_rng(seed, 2).choice(len(ring), int(traffic["judged_clips"]),
                                                    replace=False)
            kept = [(int(k), session.reference_fields(cell.config, ring[int(k)], dev, "tf32"))
                    for k in judged]
            readings = session.judge_fields(cell.config, ring, kept, dev)
            emit({"workload": cell.name, "kind": "control_tf32", "seed": seed,
                  "gaps": judge.worst(readings, names)})
        emit({"workload": cell.name, "kind": "card", "card": card.power_limit()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
