"""What the harness's tests share: the cells, a small frame, and a cell
whose ring a few CPU requests serve."""

import dataclasses

from bench_gpu.harness import cells

ROOT = cells.ROOT
SMALL = (3, 40, 56)
CELLS = ("flow_nd.sintel", "disparity_nd.kitti")


def small_cell(name: str, **traffic) -> cells.Cell:
    """The cell with a ring of two clips, both judged, so that a window of
    a few CPU requests serves them; ``traffic`` overrides more keys."""
    cell = cells.resolve(cells.load_benchmark(), name)
    return dataclasses.replace(cell, traffic={**cell.traffic, "ring": 2, "judged_clips": 2,
                                              "warmup_requests": 1, **traffic})
