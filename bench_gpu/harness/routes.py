"""The SOR calls of a captured frame by route, from the program's counters.

The program counts each SOR call on the card where it decides the call's
kernel (``pde_tpu_torch/kernels/dispatch.py``):
``sor.<route>.<family>.<H>x<W>``, ``route`` one of ``resident``, ``tiled``
and ``global``. A captured signature's record holds what its capture
counted (``counters``), so the counts are those of one replayed frame
(``harness/stages.main_graph``). A program that keeps no such counter (an
earlier checkout) gives no counts, and every reader here None.

- **The tile kernel's launches**: ``tiled_sweep_kernel`` and
  ``tiled_family_kernel`` (``csrc/tiled_sor.cu``), matched by name as
  ``harness/trace.py`` matches the port's kernels. A tiled call of the
  configurations' 4 sweeps is one launch (the route plans k = 4 sweeps a
  launch). A traced frame is read only where it holds exactly one launch
  a counted call: the profiler now and then loses a frame's records.
- **Least time of the tiled calls**: each call's planes read once and
  written once (``peaks.sor_bytes_per_px``) over the card's HBM bandwidth.
- **The tiled levels**: the pyramid levels (``reference/plain.pyramid_scales``
  of the run's frame, level 0 the finest, as the program's ``level`` spans
  number them) whose shape has a tiled count.
"""

from __future__ import annotations

import re

from bench_gpu.harness import stages
from bench_gpu.harness.peaks import HBM_BYTES_PER_S, sor_bytes_per_px
from bench_gpu.harness.trace import _PORT_KERNEL
from bench_gpu.reference.plain import pyramid_scales

TILE_KERNELS = frozenset({"tiled_sweep_kernel", "tiled_family_kernel"})
_COUNTER = re.compile(r"sor\.(resident|tiled|global)\.(\w+)\.(\d+)x(\d+)")


def route_counts(counters: dict, route: str) -> dict:
    """{(family, H, W): calls} of the counters of ``route``."""
    out = {}
    for name, n in counters.items():
        m = _COUNTER.fullmatch(name)
        if m and m.group(1) == route:
            out[(m.group(2), int(m.group(3)), int(m.group(4)))] = n
    return out


def tiled_counts(run) -> dict | None:
    """{(family, H, W): calls} of the tile kernel in the frame the run's
    main signature captured, or None where the program counted none."""
    graph = stages.main_graph(run) if run.trace is not None else None
    counts = route_counts((graph or {}).get("counters") or {}, "tiled")
    return counts or None


def least_ms(counts: dict) -> float:
    """The least device ms of the calls ``counts``: their planes read and
    written once over the card's HBM bandwidth."""
    total = sum(n * h * w * sor_bytes_per_px(family) for (family, h, w), n in counts.items())
    return total / HBM_BYTES_PER_S * 1e3


def is_tile_kernel(name: str) -> bool:
    m = _PORT_KERNEL.search(name)
    return bool(m) and m.group(1) in TILE_KERNELS


def _tile_ms(run, counts: dict) -> float | None:
    """Device ms a traced frame in the tile kernel, over the frames that
    hold exactly one launch a call of ``counts``, or None."""
    launches = sum(counts.values())
    read = []
    for ops in run.trace.frame_ops():
        mine = [op for op in ops if is_tile_kernel(op.name)]
        if len(mine) == launches:
            read.append(sum(op.end - op.start for op in mine))
    return sum(read) / 1e6 / len(read) if read else None


def kernel_ms(run) -> float | None:
    """Device ms a traced frame in the tile kernel (``_tile_ms`` of the
    calls the capture counted), or None."""
    counts = tiled_counts(run)
    return None if counts is None else _tile_ms(run, counts)


def roofline_pct(run) -> float | None:
    """The tiled calls' least time over ``kernel_ms``, %."""
    counts = tiled_counts(run)
    ms = None if counts is None else _tile_ms(run, counts)
    return 100.0 * least_ms(counts) / ms if ms else None


def tiled_levels(run) -> set | None:
    """The indices of the pyramid levels whose shape has a tiled count."""
    counts = tiled_counts(run)
    if counts is None:
        return None
    config = run.cell.config
    _, h, w = run.frame
    levels = pyramid_scales(h, w, config["params"]["scl_factor"], int(config["pyramid_stop"]),
                            config["params"].get("scales", 10**9))
    shapes = {(lh, lw) for _, lh, lw in counts}
    return {k for k, (lh, lw) in enumerate(levels) if (lh, lw) in shapes} or None


def levels_ms(run) -> float | None:
    """Device ms a traced frame in every node labelled with a tiled level,
    all stages (``stages.split``), or None."""
    levels = tiled_levels(run)
    by = stages.split(run) if levels is not None else None
    if by is None:
        return None
    return sum(ms for (_, level), ms in by.items() if level in levels)
