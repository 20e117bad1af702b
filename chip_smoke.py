#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pde_tpu_torch``) on one NVIDIA GPU and check it.

Run from the repository root, on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py [--seed N]

Phases; any failure exits non-zero, and nothing falls back to the CPU:

1. Require CUDA; print the card's name and power limit (``nvidia-smi``).
2. Build every CUDA source of the port from ``pde_tpu_torch/csrc``, one
   ``nvcc`` per source, all started together (timed); TF32 is switched
   off for matmuls and cuDNN.
3. Each kernel against its plain PyTorch version on the card, at the
   solvers' shapes, with and without NaN data (the 8-neighbour sweeps with
   diagonal weights of both signs; the tridiagonal solve at line lengths 1
   to 1024 along both axes, whole, by zebra parity and as the fused zebra
   pass in its scalar, coupled and 8-neighbour forms, with batched and
   shared coefficients, bit for bit; lines of 30,000 and 65,536 elements
   along both axes, which take the global-rows variant, and a batch of
   70,000 systems, bit for bit against the plain version run on CPU
   copies); both timed with CUDA events in turns,
   beside the least time the card could take (the bound; for the line
   solves also the chain's floor) and the kernel's device time under
   ``torch.profiler``. The tile kernel (``csrc/tiled_sor.cu``),
   serial and double-buffered, llin4 and elin4, at the solvers' shapes and
   768x768, with and without NaN data, against the plain tile schedule and
   bit for bit against the global kernels (so its two variants are each
   other's bits); its slot's bytes and threads against the plan's. Its
   windowed variant (one chunk of k sweeps over a shard and
   the 2k halo exchanged from its neighbours), llin4 and elin4, serial and
   double-buffered, k = 1, 2, 4, 4 and 9 sweeps, with and without NaN data,
   through the sharded solver at the shards of a 2x2 and a 1x4 mesh over
   480x640: against the plain windowed schedule on CPU copies, and bit for
   bit against the global kernel; one shard's chunk timed. The tile kernel's
   other families, serial and double-buffered: disp llin4 (B = 1 and 2),
   pde4 and pde8 (C = 1, 2 and 3 in one block, TRACE and B per channel or
   shared) and llin8, at the solvers' shapes without a resident plan and 1024x1024,
   with and without NaN data, against the plain tile schedule, bit for bit
   against the global kernel (disp and pde also against the plain global
   solver), the double-buffered form bit for bit against the serial one;
   their windowed variant (llin8, disp, pde4), serial and double-buffered,
   through the sharded solvers at the shards of the same meshes, k = 1, 2,
   4 and 9, bit for bit against the global kernel, and pde4's over 1 to 3
   channels bit for bit against the serial tile kernel; a 4-sweep call of each
   timed beside the global kernel's, the double-buffered form at
   1024x1024 and on the shard beside the serial one, in turns. The resident kernel (``csrc/resident_sor.cu``, one launch a
   solver call), llin4, disp llin4 (B = 1 and 2), pde4 (C = 1 and 3, TRACE
   and B per channel or shared) and elin4, against the global kernels bit
   for bit and the plain version (disp and pde4 bit for bit too), at the
   solvers' shapes and at every level of ``flow_nd``'s, the stereo models',
   ``tv_denoise4``'s and ``flow_hs``'s pyramids, with and without NaN data.
   The resident 8-neighbour
   kernel (``csrc/resident8_sor.cu``), llin8 against the global kernel bit
   for bit and the plain version, pde8 (C = 1 and 3) against both bit for
   bit, at the solvers' shapes and at every level of ``flow_ad``'s and
   ``tv_denoise8``'s pyramids, with and without NaN data.
4. ``flow_nd`` with default parameters on a 3-channel 480x640 pair whose
   second frame is the first shifted by a known sub-pixel amount. The flow
   must be finite and recover the shift, the kernels must have been
   launched exactly as often as the pyramid implies (one resident launch a
   solver call at every level with a resident plan), and the plain path on
   the card must agree. A small pair is also held against the port's CPU
   path, which the CPU tests hold against the JAX package.
5. ``flow_nd_sequence`` on a 3-frame 240x320 clip against per-pair
   ``flow_nd``.
6. ``disparity_nd``, default parameters, on a 3x480x640 stereo pair with a
   known horizontal shift: as phase 4, with the interior-update kernel.
7. ``disparity_sym``, default parameters, on the same kind of pair: both
   fields recover the shift with opposite signs, each solve of the pair is
   one kernel call with a batch of 2, its planes never stacked.
8. ``tv_denoise4``, default parameters, on a noisy piecewise-flat
   3x480x640 image: exact launches (one resident pde4 launch a solver
   call), kernel path against plain path, and the noise in a flat patch
   must fall.
9. ``flow_hs`` with default parameters (the line-implicit PCG, every line
   solve the tridiagonal kernel) on the 3x480x640 pair of phase 4: exact
   launches, finite flow; a small pair against the CPU path, and the
   kernel path against the plain path at a reduced size.
10. ``flow_hs`` with ``solver=1`` (the resident elin4 kernel): exact
    launches (one a level), kernel path against plain path, and a 1-px
    shift recovered at 400 sweeps on a 48x56 pair.
11. ``diffusion4``, default parameters, on a noisy 3x480x640 image: exact
    launches, kernel path against plain path, the noise must fall.
12. ``flow_ad`` (anisotropic tensor flow, the resident llin8 kernel) with
    default parameters on the pair of phase 4: as phase 4, one resident
    launch a solver call.
13. ``tv_denoise8`` (the resident pde8 kernel), default parameters, on the
    noisy image of phase 8: as phase 8, one resident launch a solver call.
14. ``solver=2`` in ``flow_nd``, ``disparity_nd``, ``disparity_sym``,
    ``tv_denoise4``, ``flow_ad`` and ``tv_denoise8`` at 3x480x640: exact
    launches (two factors per field and solver call, one fused zebra pass
    per field and preconditioner step), the shift recovered or the noise
    reduced, a profiled warm frame, the kernel path against the plain path
    at a reduced size.
15. The tile engine, ``bench.py``'s headline at 1024x1024: the sustained
    llin4 (and elin4) sweep rate of the global kernel and of the serial and
    double-buffered tile kernels by chained differencing, with each one's
    bytes per pixel-iteration and the bandwidth that implies; exact
    launches; a 1024-sweep result of each tile kernel against the global
    one.
16. ``flow_nd``, ``disparity_nd``, ``flow_ad``, ``tv_denoise8``,
    ``tv_denoise4`` and ``flow_hs`` with ``solver=1`` at 3x1024x1024, whose
    finest level has no resident plan (``tv_denoise8``'s second neither, nor
    ``tv_denoise4``'s, nor ``flow_nd``'s and ``flow_hs``'s 768x768): exact
    launches, counted apart from the dispatch's routing: the tile kernel
    of every family (``ceil(iters / 4)`` a call; ``flow_nd`` 32,
    ``flow_hs`` 10, ``disparity_nd`` 24, ``flow_ad`` 32, ``tv_denoise8``
    42, ``tv_denoise4`` 66, pinned), the resident kernel at every other
    level; finite fields. These are the serial tile kernels' main-path
    launches in the kernels line, and the global SOR kernels' (0).
17. ``flow_fmg`` (FAS full multigrid), default parameters, V-cycle, with
    ``solver=2`` (the PCG) and ``solver=1`` (the resident elin4 kernel) on a
    3x480x640 pair shifted by 1 px: exact launches (196 resident elin4
    launches a ``solver=1`` frame), the shift recovered with ``flow_nd``'s
    sign, a profiled warm frame of each, the kernel path against the plain
    path (``solver=1`` at full size, ``solver=2`` at 3x32x40); the W-cycle
    once at 3x240x320 with exact launches.
18. ``gac_a`` and ``gac_b``, default parameters (100 AOS steps), on
    ``tests/golden/gac_ctour.npz``'s 320x400 initial contour around a
    synthetic bright disc: 200 ``tridiag_thomas`` launches a call, the
    contour shrinks and keeps the disc's centre inside, a profiled warm
    frame, the kernel path against the plain path at 64x80; and ``gac_a``
    on a 16x30,000 strip, whose rows take the global-rows variant, against
    the CPU path.
19. ``disp_segmentation`` and ``disp_segmentation_sparse`` at default
    parameters on ``tests/fixtures/disparity_maps.npz``'s 356x451 maps
    (``dd`` dense, ``ds`` 65% NaN): the dense call cold and warm, the
    sparse call once, each with exactly the ``tridiag_thomas`` launches its
    pyramids and the phases that found segments imply (two an AOS step),
    frame times, segment count, coverage and peak memory. Both line solves
    of the largest (H, W) seeding step and the largest (S, H, W)
    competition step of each call, on the coefficients that step built,
    bit for bit against the plain solve on the same card tensors; the dense
    call's finest seeding solve is timed and reported as ``tridiag_seg``,
    whose launches are the dense call's. The dense result
    held to ``tests/test_segmentation.py``'s bar (>= 2 segments, coverage >
    0.35, a surface offset within the map's range +- 3, finite phi), the
    sparse one to >= 1 segment and finite SParam and phi. On the 60x80 crop
    of the half-resolution map with that test's reduced loop counts, dense,
    sparse and a warm start run with and without ``plain_solvers()`` from
    one seed: the same SEG maps and phi. One reduced full-size call of each
    (2 seeds, the crop's loop counts) is profiled, and its host syncs
    counted by the port's line that makes them.

20. The mesh (``pde_tpu_torch/parallel``), on a virtual 2x2 mesh of this
    card (one device four times, as ``pde_tpu``'s virtual CPU mesh):
    ``flow_nd`` 3x480x640 at default parameters, bit for bit against phase
    4's flow, with exact launches of the windowed variant (one a shard and
    chunk of every solve at the levels of >= 64 px that divide over the
    mesh) and of the resident kernel elsewhere; ``flow_fmg`` 3x480x640,
    V-cycle, both solvers, bit for bit against phase 17's (``solver=1``
    sharded at its fine levels, ``solver=2`` whole); the sharded llin8, disp
    and pde4 solvers (one windowed launch a shard and chunk, exact counts)
    bit for bit against the unsharded solve (disp and pde4 against the plain
    global solvers too, llin8 within SOR_TOL of it); the
    double-buffered windowed variant through the sharded llin4 and elin4
    solvers; and the tiled PCG on a 2x4 mesh with its ``tridiag_thomas``
    launches counted (bit for bit against its plain path at 64x96). The
    port's kernels' device ms of each profiled mesh frame beside the
    unsharded frame's. With two cards or more, a 1x2 mesh over two cards
    against one card.
21. The fused frames (``models/_graph.py``): first one call of each CUDA
    entry point captured into a CUDA graph and replayed, bit for bit
    against the eager call (the resident kernel in every scope its plans
    pick at 3x480x640's levels, the global kernels, the tile kernel serial
    and double-buffered at 1024x1024, the line solves whole, global-rows,
    factored and as the zebra pass); then every ``*_fused`` entry point
    and ``flow_nd_sequence`` at default parameters on the earlier phases'
    inputs (``flow_nd_fused`` also at 3x1024x1024, ``flow_fmg_fused`` with
    both solvers): the first call launches twice the pinned eager counts
    (the warm-up and the capture), a replay none, the replayed result
    equals the eager frame bit for bit; the replayed and eager warm frames
    timed in turns, one replay profiled, the first call's time beyond a
    replay (the warm-up and the capture) and the memory it leaves reserved
    (the graph's pool). Each graph is released after its check.
22. The reweighting kernels (``csrc/reweight.cu``) at the benchmark
    cells' finest levels (flow 436x1024: the robust terms of the
    grad/gradmag terms, the weights of (U + dU, V + dV); stereo 375x1242:
    the disparity's robust terms, the zero-bordered max weights of U + dU),
    with NaN where a warp leaves the image: bit for bit against the plain
    version on the card; each timed with CUDA events in turns with the
    plain chain and by ``torch.profiler``, beside its byte bound; then
    the cells' replayed frames (3x436x1024 flow, 3x375x1242 stereo),
    whose capture must count 384 and 720 reweighting kernels and no plain
    reweighting, whose first call must launch 192 robust_flow and 192
    weights4 (flow), 360 robust_disp and 360 weights4 (stereo) kernels in
    the warm-up and as many in the capture, and whose replays launch none,
    with their node counts and busy time. The report's ``kernels`` list
    takes the three kernels with phase 22's readings.
    ``--reweight-only`` runs phases 1, 2 and 22 alone.

Every phase from 4 on sets every kernel's launch count to 0 just before it
drives its entry point and reads all counts just after, and profiles one
more warm frame for the card's busy time. The last lines are
the card's name and power limit, a JSON object of the kernels (launches,
errors, times, bounds) and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import importlib
import itertools
import json
import re
import subprocess
import sys
import time
import traceback
import warnings
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

SOR_TOL = 1e-5       # max-abs, kernel vs plain, unit-scale fields (FMA contraction moves ulps)
# Resident elin4 after flow_hs's 20 sweeps at omega 1.9 is held to this many
# times the draw's own rounding spread (max |plain float32 - plain float64|
# on the card), or SOR_TOL where that is larger. scripts/elin4_seed_sweep.py
# measured on the H100, over 24 seeds and 960 draws at flow_hs's and
# flow_fmg's levels: the kernel stands as far from the float64 solve as the
# plain float32 version does (median ratio 1.00, nearer in 59% of the
# draws), so it computes the plain arithmetic and rounds otherwise (FMA
# contraction); the spread reaches 7.2e-5 after 20 sweeps, the kernel's
# distance from plain float32 2.3e-5 (over SOR_TOL in 3 draws), and at most
# 2.08 spreads wherever the spread exceeds 1e-6. Two float32 roundings of one
# function may each stand about a spread from it, on either side.
ELIN4_SPREADS = 3.0
EXACT_TOL = 1e-6     # max-abs, kernel vs plain: every float op rounded alone in the plain order (0 expected)
FLOW_TOL = 1e-3      # px, mean |Δflow| between two paths of the whole model
SHIFT_TOL = 0.3      # px, median interior flow vs the known shift
DISP_SHIFT_TOL = 0.5  # px, median interior disparity vs the known shift
TV_REL_TOL = 1e-4    # max |Δu| over the image's value range, kernel vs plain path
GAC_TOL = 1e-5       # max |Δφ|, kernel vs plain path (the line solve is bit for bit: 0 expected)
MAIN_SHAPE = (3, 480, 640)
MAIN_SHIFT = (0.4, 1.3)  # (dy, dx) in px: the second frame moves right and down
DISP_SHIFT = (0.0, 2.6)  # the stereo pair's second frame moves right
SEQ_SHAPE = (3, 240, 320)
LARGE_SHAPE = (3, 1024, 1024)  # its finest level has no resident plan
SMALL_SHAPE = (3, 36, 44)  # card vs the CPU path
# the main path's finest level and odd neighbours, a coarse level, and
# degenerate shapes where every pixel is an edge pixel
SOR_SHAPES = [(1, 1), (1, 9), (9, 1), (37, 53), (480, 640), (481, 641), (1024, 1024)]
# the interior-update kernels take H, W >= 2: 2xN and 3x3 have no or one
# interior pixel, so their border fill is all there is
INTERIOR_SHAPES = [(2, 5), (3, 3), (37, 53), (480, 640), (481, 641), (1024, 1024)]
TIME_SHAPES = [(481, 641), (1024, 1024)]  # the first one is reported as the kernel's ms
# the kernels timed at the main path's finest level too (the 8-neighbour ones
# and those of rows 3 and 6a), where the pde8 and pde4 calls of the
# denoisers (C = 3) have a resident plan and 481x641 has none
AT_MAIN = ("flow_llin8_sor", "pde8_sor", "resident_flow_llin8", "resident_pde8", "pde4_sor",
           "flow_elin4_sor", "resident_pde4", "resident_flow_elin4")
TILED_KS = (1, 2, 4)  # the tile kernel's k_max in phase 3
# phase 16's launches of the tile kernel, a frame at LARGE_SHAPE: flow_nd's
# 1024x1024 and 768x768 levels (no resident plan), 16 calls x 1 chunk each;
# flow_hs solver=1's, 1 call x 5 chunks (20 sweeps) each
# and the other families' (disparity_nd: its 1024x1024 level, 24 calls x 1
# chunk; flow_ad: 1024x1024 and 768x768, 16 calls x 1 chunk each;
# tv_denoise8: both levels, 21 calls x 1 chunk each; tv_denoise4: 1024x1024,
# 768x768 and 576x576, 11 calls x 2 chunks (5 sweeps) each)
PHASE16_TILED = {"flow_nd": {"tiled_flow_llin4": 32},
                 "flow_hs solver=1": {"tiled_flow_elin4": 10},
                 "disparity_nd": {"tiled_disp_llin4": 24},
                 "flow_ad": {"tiled_flow_llin8": 32},
                 "tv_denoise8": {"tiled_pde8": 42},
                 "tv_denoise4": {"tiled_pde4": 66}}
# the tile kernel's shapes in phase 3: SOR_SHAPES and 768x768, a level without a resident plan
TILE_SHAPES = sorted(set(SOR_SHAPES) | {(768, 768)})
# tridiagonal systems, solved along both axes: line lengths 1, 2, 3, 7, 33,
# 480, 481, 640, 641 and 1024 in each direction
TRIDIAG_SHAPES = [(1, 7), (7, 1), (2, 3), (3, 2), (7, 33), (33, 7), (480, 640), (481, 641),
                  (640, 480), (1024, 1024)]
# lines longer than a block's shared memory holds at G = 1 (the global-rows
# variant of the line solves, lengths 30,000 and 65,536 along each axis), and
# a batch of 70,000 systems of short lines (over the 65,535 of a grid's y)
LONG_LINES = [((2, 30_000), -1), ((30_000, 2), -2), ((1, 65_536), -1), ((65_536, 2), -2)]
BIG_BATCH = (70_000, 3, 5)
LONG_TIME = ((2, 30_000), -1)  # the variant's reported time: whole solves of 2 rows
# the plain scan costs ~5 launches per line step on the card, so the kernel
# path of a line-implicit model is held against its plain path at this size
PLAIN_SHAPE = (3, 32, 40)

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32 outside the
# tensor cores; the bound of a call is the larger of its two times
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# float operations per relaxed pixel and sweep (the kernels' arithmetic)
FLOPS_PER_PX = {"flow_llin4_sor": 40, "flow_elin4_sor": 30, "disp_llin4_sor": 23,
                "resident_flow_llin4": 40, "resident_disp_llin4": 23,
                "resident_flow_elin4": 30, "resident_pde4": 16,
                "resident_flow_llin8": 64, "resident_pde8": 28,
                "pde4_sor": 16, "flow_llin8_sor": 64, "pde8_sor": 28,
                "tiled_flow_llin4": 40, "tiled_flow_llin4_db": 40,
                "tiled_flow_elin4": 30, "tiled_flow_elin4_db": 30,
                "tiled_flow_llin4_win": 40, "tiled_flow_llin4_win_db": 40,
                "tiled_flow_elin4_win": 30, "tiled_flow_elin4_win_db": 30,
                **{f"tiled_{family}{variant}": n
                   for family, n in (("flow_llin8", 64), ("disp_llin4", 23), ("pde4", 16),
                                     ("pde8", 28))
                   for variant in ("", "_db", "_win", "_win_db")}}
# the kernels whose every float operation is rounded alone in the plain
# version's order, held to EXACT_TOL; the others contract to FMA (SOR_TOL)
EXACT = ("tridiag", "tridiag_long", "tridiag_seg", "tridiag_zebra_pass", "pde8_sor", "resident_disp_llin4",
         "resident_pde8", "resident_pde4",
         *(f"tiled_{family}{variant}" for family in ("disp_llin4", "pde4", "pde8")
           for variant in ("", "_db", "_win", "_win_db")))
# float operations per line element of one whole tridiagonal solve
TRIDIAG_FLOPS_PER_PX = 8
# dependent rounded operations a line element adds to a solve's chain (3
# forward, 2 back) and the cycles each takes (the float pipe's latency):
# a launch takes at least L times their product at the card's SM clock
CHAIN_OPS_PER_ELEMENT = 5
CYCLES_PER_OP = 4
# bytes per pixel that each TPU kernel row of PERF.md's table must move at
# least (float32 inputs read once, outputs written once), as that row's
# main-path caller hands them over
ROW_BYTES_PER_PX = {
    "1-2 llin4 (13 in, 2 out)": (13 + 2) * 4,
    "3 elin4 (11 in, 2 out)": (11 + 2) * 4,
    "4 llin8 (17 in, 2 out)": (17 + 2) * 4,
    "5 disp llin4 B=1 (8 in, 1 out)": (8 + 1) * 4,
    "6a pde4 C=3, shared weights (13 in, 3 out)": (3 * 3 + 4 + 3) * 4,
    "6b pde8 C=3, shared weights (17 in, 3 out)": (3 * 3 + 8 + 3) * 4,
    "8 tridiagonal solve (4 in, 1 out)": (4 + 1) * 4,
    # per pixel of the plane: a, cp, denom, rhs, the two weights, m and z_o
    # read on the parity lines (half the plane), z read on the other half
    # and written on the parity lines
    "8z fused zebra pass, coupled (flow_hs)": (8 + 1 + 1) * 4 / 2,
}
# device-memory bytes per pixel and sweep of the global flow kernels: two
# colour launches, each touching every 32-byte sector of the coefficient
# planes and the flags (10 planes llin4, 9 elin4, the colours interleave),
# of the fields read at the neighbours (dU, dV, U, V; elin4 U, V) and of
# the two written
GLOBAL_BYTES_PER_PX_SWEEP = {"flow_llin4_sor": 2 * ((10 * 4 + 1) + 4 * 4 + 2 * 4),
                             "flow_elin4_sor": 2 * ((9 * 4 + 1) + 2 * 4 + 2 * 4)}
# the __global__ functions of pde_tpu_torch/csrc/*.cu
OWN_KERNELS = {"prepare_kernel", "sweep_kernel", "prepare8_kernel", "sweep8_kernel",
               "disp_color_kernel", "pde4_color_kernel", "pde8_color_kernel", "border_kernel",
               "border_small_kernel", "lines_kernel", "tiled_sweep_kernel", "tiled_family_kernel",
               "resident_llin4_kernel", "resident_disp_kernel", "resident_llin8_kernel",
               "resident_pde8_kernel", "resident_flow4_kernel", "resident_pde4_kernel",
               "reweight_flow_kernel", "reweight_disp_kernel", "weights4_kernel"}
# the tile kernel's entries: (family, double-buffered)
TILED = {"tiled_flow_llin4": ("flow_llin4", False), "tiled_flow_llin4_db": ("flow_llin4", True),
         "tiled_flow_elin4": ("flow_elin4", False), "tiled_flow_elin4_db": ("flow_elin4", True)}
# its windowed variant's
TILED_WIN = {"tiled_flow_llin4_win": ("flow_llin4", False),
             "tiled_flow_llin4_win_db": ("flow_llin4", True),
             "tiled_flow_elin4_win": ("flow_elin4", False),
             "tiled_flow_elin4_win_db": ("flow_elin4", True)}
# the tile kernel's other families, with the global kernel's key that
# served their shapes before; and the windowed variant of those the sharded
# solvers run
TILED_NEW = {"tiled_flow_llin8": ("flow_llin8", "flow_llin8_sor"),
             "tiled_disp_llin4": ("disp_llin4", "disp_llin4_sor"),
             "tiled_pde4": ("pde4", "pde4_sor"),
             "tiled_pde8": ("pde8", "pde8_sor")}
TILED_WIN_NEW = {"tiled_flow_llin8_win": "flow_llin8", "tiled_disp_llin4_win": "disp_llin4",
                 "tiled_pde4_win": "pde4"}
# their double-buffered forms (the port of _stripe_kernel_db), which no
# model frame launches
TILED_NEW_DB = tuple(f"{name}_db" for name in (*TILED_NEW, *TILED_WIN_NEW))
# phase 3's cases of the other families: (family, systems or channels,
# TRACE and B shared by the channels, (h, w)): the solvers' shapes without a
# resident plan, and 1024x1024
NEW_TILE_CASES = (("flow_llin8", 1, False, (37, 53)), ("flow_llin8", 1, False, (480, 640)),
                  ("flow_llin8", 1, False, (1024, 1024)),
                  ("disp_llin4", 1, False, (480, 640)), ("disp_llin4", 2, False, (37, 53)),
                  ("disp_llin4", 1, False, (1024, 1024)), ("disp_llin4", 2, False, (1024, 1024)),
                  ("pde4", 1, False, (3, 3)), ("pde4", 3, True, (481, 641)),
                  ("pde4", 3, False, (481, 641)), ("pde4", 3, False, (1024, 1024)),
                  ("pde8", 1, False, (37, 53)), ("pde8", 3, True, (481, 641)),
                  ("pde8", 3, False, (481, 641)), ("pde8", 3, False, (1024, 1024)))
# and two channels in a block (drawn from a generator of their own, so that
# the other checks keep their inputs)
CHANNEL_CASES = (("pde4", 2, True, (37, 53)), ("pde4", 2, False, (481, 641)),
                 ("pde8", 2, False, (37, 53)), ("pde8", 2, True, (481, 641)))
# pde4's windowed variant over 1 to 3 channels (TRACE and B shared or per
# channel): boxes of 481x641 (R0, R1, C0, C1), an odd origin inside and the
# image's corner, one chunk of 4 sweeps
CHANNEL_WINDOWS = ((37, 229, 101, 420), (0, 160, 481, 641))
NEW_WIN_KS = (1, 2, 4, 9)  # the windowed variant's k through the sharded solvers (9 sweeps)
FMG_SHIFT = (0.0, 1.0)  # early linearisation recovers only small shifts
FMG_ULP_FACTOR = 3.0  # kernel vs plain at full size, in units of the one-ulp sensitivity
FMG_W_SHAPE = (3, 240, 320)  # the W-cycle's frame (936 solves at six levels)
GAC_SMALL = (64, 80)  # the GAC kernel path against its plain path
GAC_STRIP = (16, 30_000)  # rows longer than the staged line solve holds
# tests/test_segmentation.py's 60x80 crop of the half-resolution map and its
# reduced loop counts (the kernel path against the plain path)
SEG_CROP_WINDOW = np.s_[50:110, 60:140]
SEG_REDUCED = dict(seeds=3, seed_iterations=8, rc_iterations=8, rc_iterations2=6,
                   ransac_first=300, ransac_rest=50)
SEG_TOL = 1e-4  # max |dphi|, kernel path vs plain path (bit for bit expected: 0)
MESH_SHAPE = (2, 2)  # phase 20's virtual mesh of the card
WIN_MESHES = ((2, 2), (1, 4))  # the shard geometries of the windowed variant in phase 3
PCG_MESH = (2, 4)  # the tiled PCG's mesh in phase 20
PCG_ITERS = 20
PCG_SMALL = (64, 96)  # the tiled PCG against its plain path (the plain line solve scans)
HEADLINE_SHAPE = (1024, 1024)  # bench.py's headline: the llin4 sweep rate
HEADLINE_ITERS = (128, 1024)   # chained differencing between these sweep counts
W8 = ("ww", "wnw", "wn", "wne", "we", "wse", "ws", "wsw")


_T0 = time.time()


def phase(name: str) -> None:
    print(f"== {name} (at {time.time() - _T0:.1f} s)", flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def sm_clock_mhz() -> float:
    """The card's highest SM clock in MHz (``nvidia-smi``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` calls (CUDA events)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(kern, plain, reps: int = 50, plain_reps: int | None = None):
    """(kernel ms, plain ms, the four readings) timed plain, kernel, kernel,
    plain on one card."""
    plain_reps = plain_reps or reps
    p1, k1, k2, p2 = (cuda_ms(fn, r) for fn, r in ((plain, plain_reps), (kern, reps),
                                                   (kern, reps), (plain, plain_reps)))
    return (k1 + k2) / 2, (p1 + p2) / 2, (p1, k1, k2, p2)


def device_events(fn, calls: int = 1, tries: int = 3):
    """The device's kernels and copies in ``calls`` calls of ``fn`` under
    ``torch.profiler`` (``key_averages()`` with device self time), the
    largest first. A window in which the profiler recorded no device
    activity at all is taken again, up to ``tries`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        # the device's activity alone: a frame of the line-implicit paths has
        # ~10^5 device operations, and host events would multiply the
        # profiler's own work
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        if events:
            break
    return sorted(events, key=lambda e: -e.self_device_time_total)


def own_kernel(key: str):
    """The name of the port's own __global__ function an event's key names,
    or None."""
    m = re.search(r"\(anonymous namespace\)::(\w+)", key)
    return m.group(1) if m and m.group(1) in OWN_KERNELS else None


def device_profile(fn, calls: int = 1, tries: int = 3):
    """What ``calls`` calls of ``fn`` keep the card busy with, from
    ``torch.profiler`` (``device_events``): (device ms per call, device
    operations per call, device ms per call in the port's own kernels,
    [(name, device ms per call)] of the five largest). Device time is the
    self time of every kernel and copy, so gaps between them do not
    count."""
    events = device_events(fn, calls, tries)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / calls
    n_ops = sum(e.count for e in events) / calls
    own_ms = sum(e.self_device_time_total for e in events if own_kernel(e.key)) / 1e3 / calls
    top = [(e.key, e.self_device_time_total / 1e3 / calls) for e in events[:5]]
    return busy_ms, n_ops, own_ms, top


def print_profile(what: str, wall_s: float, prof) -> None:
    busy_ms, n_ops, own_ms, top = prof
    print(f"  {what} under torch.profiler: device busy {busy_ms:.3f} ms of a "
          f"{wall_s * 1e3:.1f} ms warm frame ({100 * busy_ms / (wall_s * 1e3):.1f}%), "
          f"{n_ops:.0f} device operations; the port's CUDA kernels {own_ms:.3f} ms",
          flush=True)
    for name, ms in top:
        print(f"    {ms:9.3f} ms  {name[:90]}", flush=True)


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def card_device() -> torch.device:
    return torch.device("cuda", 0)


def unit_field(rng, name: str, shape) -> np.ndarray:
    """Unit-scale solver coefficients, as the CPU tests make them; the
    diagonal weights of the 8-neighbour stencil take both signs."""
    if name in ("duc", "dvc", "trace"):
        return rng.random(shape) + 1.0
    if name == "m":
        return rng.random(shape) * 0.01
    if name in ("wnw", "wne", "wse", "wsw"):
        return rng.random(shape) * 0.3 - 0.15
    if name.startswith("w"):
        return rng.random(shape) + 0.1
    return rng.random(shape) * 0.2


def to_dev(fields, nan_names, rng, dev):
    out = []
    for n, x in fields.items():
        if n in nan_names:
            x = np.where(rng.random(x.shape) < 0.05, np.nan, x)
        out.append(torch.from_numpy(x.astype(np.float32)).to(dev))
    return out


def sor_fields(rng, h, w, nan: bool, dev):
    """llin4 solver fields; 5% NaN in Cu and Du when ``nan``."""
    names = ("u", "v", "du", "dv", "m", "cu", "cv", "duc", "dvc", "ww", "wn", "we", "ws")
    return to_dev({n: unit_field(rng, n, (h, w)) for n in names},
                  ("cu", "duc") if nan else (), rng, dev)


def elin_fields(rng, h, w, nan: bool, dev):
    """elin4 solver fields; 5% NaN in Cu and Du when ``nan``."""
    names = ("u", "v", "m", "cu", "cv", "duc", "dvc", "ww", "wn", "we", "ws")
    return to_dev({n: unit_field(rng, n, (h, w)) for n in names},
                  ("cu", "duc") if nan else (), rng, dev)


def llin8_fields(rng, h, w, nan: bool, dev):
    """llin8 solver fields; 5% NaN in Cu and Du when ``nan``."""
    names = ("u", "v", "du", "dv", "m", "cu", "cv", "duc", "dvc") + W8
    return to_dev({n: unit_field(rng, n, (h, w)) for n in names},
                  ("cu", "duc") if nan else (), rng, dev)


def pde8_fields(rng, c, h, w, nan: bool, dev, shared: bool = False):
    """pde8 fields as tv_denoise8 hands them over: X, TRACE, B of (H, W)
    for c == 1 else (c, H, W) (TRACE and B one (H, W) plane with
    ``shared``), one shared (H, W) plane per weight, TRACE above the
    weights' absolute sum; 5% NaN in TRACE when ``nan``."""
    shape = (h, w) if c == 1 else (c, h, w)
    f = {"x": unit_field(rng, "x", shape)}
    f.update({n: unit_field(rng, n, (h, w) if shared else shape) for n in ("trace", "b")})
    f.update({n: unit_field(rng, n, (h, w)) for n in W8})
    f["trace"] = f["trace"] + sum(np.abs(f[n]) for n in W8)
    return to_dev(f, ("trace",) if nan else (), rng, dev)


def tridiag_fields(rng, shape, dev, shared=False):
    """A diagonally dominant tridiagonal system (a, b, c, d) of ``shape``,
    as the CPU tests make them; with ``shared``, a and c are one (H, W)
    plane for the leading dims (pcg_pde4's weights)."""
    a = rng.random(shape) * 0.4 - 0.5
    c = rng.random(shape) * 0.4 - 0.5
    b = np.abs(a) + np.abs(c) + rng.random(shape) + 0.5
    d = rng.random(shape) * 2.0 - 1.0
    if shared:
        a, c = a[0], c[0]
    return [torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)
            for x in (a, b, c, d)]


def zebra_fields(rng, shape, dev, shared=False):
    """The fields of a zebra pass on ``shape``: z, rhs, z_o and m, the two
    line weights and four diagonal ones (both signs); with ``shared``, the
    weights and m are one (H, W) plane for the leading dims."""
    plane = shape[-2:] if shared else shape
    f = [rng.random(shape) - 0.5, rng.random(shape) - 0.5, rng.random(shape) - 0.5,
         rng.random(plane) * 0.01, rng.random(plane) + 0.1, rng.random(plane) + 0.1]
    f += [rng.random(plane) * 0.3 - 0.15 for _ in range(4)]
    return [torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev) for x in f]


def disp_fields(rng, b, h, w, nan: bool, dev):
    """disp llin4 fields, (H, W) for b == 1 else (b, H, W); 5% NaN in Cu
    and Du when ``nan``."""
    shape = (h, w) if b == 1 else (b, h, w)
    names = ("u", "du", "cu", "duc", "ww", "wn", "we", "ws")
    return to_dev({n: unit_field(rng, n, shape) for n in names},
                  ("cu", "duc") if nan else (), rng, dev)


def pde4_fields(rng, c, h, w, nan: bool, dev, shared: bool = False):
    """pde4 fields as tv_denoise4 hands them over: X, TRACE, B of (H, W)
    for c == 1 else (c, H, W) (TRACE and B one (H, W) plane with
    ``shared``), one shared (H, W) plane per weight, TRACE above the
    weights' sum; 5% NaN in TRACE when ``nan``."""
    shape = (h, w) if c == 1 else (c, h, w)
    f = {"x": unit_field(rng, "x", shape)}
    f.update({n: unit_field(rng, n, (h, w) if shared else shape) for n in ("trace", "b")})
    f.update({n: unit_field(rng, n, (h, w)) for n in ("ww", "wn", "we", "ws")})
    f["trace"] = f["trace"] + f["ww"] + f["wn"] + f["we"] + f["ws"]
    return to_dev(f, ("trace",) if nan else (), rng, dev)


def shifted_frames(rng, shape, shifts):
    """A seeded smooth colour texture and copies of it translated by each
    (dy, dx) in ``shifts`` (cubic-spline resampling), in 0..255."""
    import scipy.ndimage as ndi

    c, h, w = shape
    pad = 24
    base = ndi.gaussian_filter(rng.random((c, h + 2 * pad, w + 2 * pad)), (0, 2.5, 2.5))
    base = (base - base.min()) / (base.max() - base.min()) * 255.0
    frames = [ndi.shift(base, (0, dy, dx), order=3, mode="nearest") for dy, dx in shifts]
    return [f[:, pad:-pad, pad:-pad].astype(np.float32) for f in frames]


def noisy_blocks(rng, shape):
    """A piecewise-flat image (flat background and two blocks per channel,
    in 0..1) plus N(0, 0.1) noise."""
    c, h, w = shape
    clean = np.zeros(shape, np.float32)
    for k in range(c):
        clean[k] = 0.2 + 0.2 * k
        clean[k, h // 4:3 * h // 4, w // 4:w // 2] = 0.8 - 0.1 * k
        clean[k, h // 8:h // 3, 5 * w // 8:7 * w // 8] = 0.5
    return clean + 0.1 * rng.standard_normal(shape).astype(np.float32)


def partial_pyramid_shapes(shape, scl: float, scl_factor: float) -> list:
    """The (H, W) of each level of tv_denoise's partial pyramid
    (models/tv_denoise.py's stop rule) for an image of ``shape``, finest
    first."""
    h, w = shape[-2:]
    levels = [(h, w)]
    while True:
        h, w = int(np.ceil(h * scl_factor)), int(np.ceil(w * scl_factor))
        levels.append((h, w))
        if h <= np.ceil(shape[-2] * scl) or w <= np.ceil(shape[-1] * scl):
            return levels


def partial_pyramid_levels(shape, scl: float, scl_factor: float) -> int:
    return len(partial_pyramid_shapes(shape, scl, scl_factor))


def fmg_levels(shape, scales=10**9):
    """(H, W) of each level of flow_fmg's pyramid (factor-2 decimation, stop
    once a side is <= 10), finest first."""
    h, w = shape[-2:]
    levels = [(h, w)]
    while len(levels) < scales:
        h, w = -(-h // 2), -(-w // 2)
        levels.append((h, w))
        if h <= 10 or w <= 10:
            return levels
    return levels


def fmg_smooth_calls(n, cycle_index):
    """Smoothing calls at each of n levels over flow_fmg's loop: one
    top-level FAS cycle a level, coarsest first, each recursing."""
    calls = [0] * n

    def cycle(lvl):
        if lvl == n - 1:
            calls[lvl] += 1
            return
        for _ in range(cycle_index):
            calls[lvl] += 1
            cycle(lvl + 1)
        calls[lvl] += 1

    for top in range(n - 1, -1, -1):
        cycle(top)
    return calls


def fmg_weights4(n, cycle_index, first_loop):
    """weights4 launches of a flow_fmg call over n levels
    (``models/flow_fmg.py``): ``first_loop`` a smoothing, one more a
    smoothing's residual pass and one a coarse level's operator, in every
    FAS cycle as ``fmg_smooth_calls`` walks them."""
    def cycle(lvl):
        if lvl == n - 1:
            return first_loop
        return cycle_index * (first_loop + 2 + cycle(lvl + 1)) + first_loop

    return sum(cycle(top) for top in range(n))


def reweight_launches(levels: int, calls: int, robust: str | None, weights: int = 1) -> dict:
    """Launches of the reweighting kernels (``csrc/reweight.cu``, as
    ``reweight_cuda.LAUNCHES`` counts them) of ``calls`` reweightings at each
    of ``levels`` levels: one ``robust`` launch ("robust_flow" or
    "robust_disp"; None where the model forms its own terms) and ``weights``
    weights4 launches a reweighting."""
    want = {"weights4": levels * calls * weights} if weights else {}
    if robust is not None:
        want[robust] = levels * calls
    return want


def bit_equal(got, want) -> bool:
    """The same bits in every element of each pair (NaN payloads included)."""
    return all(torch.equal(g.view(torch.int32), w.view(torch.int32)) for g, w in zip(got, want))


def tile_order(family: str, fields):
    """The solver fields (``sor_fields``, ``llin8_fields``, ``disp_fields``
    ...) in the tile engine's order, the relaxed fields first (llin4 and
    llin8: dU, dV, U, V, ...; disp: dU, U, ...)."""
    if family in ("flow_llin4", "flow_llin8"):
        return fields[2:4] + fields[:2] + fields[4:]
    if family == "disp_llin4":
        return fields[1:2] + fields[:1] + fields[2:]
    return fields


def mean_flow_diff(a, b) -> float:
    return float(torch.hypot(a[0] - b[0], a[1] - b[1]).mean())


def timed(fn):
    """(fn's result, host seconds until the card is done)."""
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


# phase 22: the benchmark cells' frames and finest levels, the terms they
# run (grad and gradmag: 6 and 3 channels of a 3-channel image), their
# robust kernel and the frame's reweightings (flow 12 levels x 4 warps x 4,
# stereo 15 x 4 x 6), each one robust and one weights4 launch
REWEIGHT_CELLS = {"flow_nd.sintel": ((3, 436, 1024), "robust_flow", 192),
                  "disparity_nd.kitti": ((3, 375, 1242), "robust_disp", 360)}
# float32 planes each reweighting kernel reads and writes a pixel at those
# terms (each read once, each written once): flow's robust terms dt, dx, dy
# x 6, dxt, dyt, dxx, dyy, dxy x 3, dU, dV in, 5 out; the disparity's dt, dx
# x 6, dxt, dyt, dxx, dxy x 3, dU in, 2 out; the weights U, dU, V, dV (flow),
# U, dU (stereo) in, 4 out
REWEIGHT_PLANES = {"robust_flow": 35 + 5, "robust_disp": 25 + 2, "weights4_flow": 4 + 4,
                   "weights4_disp": 2 + 4}


def reweight_phase(seed: int) -> dict:
    """Phase 22 (module docstring); returns its readings by case and cell."""
    from pde_tpu_torch.kernels import dispatch, reweight_cuda
    from pde_tpu_torch.kernels.plain_mode import plain_solvers
    from pde_tpu_torch.models import _graph
    from pde_tpu_torch.models.disparity import DisparityParams, disparity_nd_fused
    from pde_tpu_torch.models.flow_nd import FlowNDParams, flow_nd_fused
    from pde_tpu_torch.utils import observe

    phase("22 reweighting kernels: robust terms and diffusion weights at the cells' finest levels")
    rng = np.random.default_rng(seed + 22)
    dev = card_device()

    def planes(keys, c, hw):
        out = {}
        for k in keys:
            x = rng.standard_normal((c, *hw)).astype(np.float32)
            x[0, : hw[0] // 6, : hw[1] // 8] = np.nan  # where a warp leaves the image
            out[k] = torch.from_numpy(x).to(dev)
        return out

    def field(hw, scale):
        return torch.from_numpy((rng.standard_normal(hw) * scale).astype(np.float32)).to(dev)

    fh, fw = REWEIGHT_CELLS["flow_nd.sintel"][0][1:]
    dh, dw = REWEIGHT_CELLS["disparity_nd.kitti"][0][1:]
    fp, dp = FlowNDParams(), DisparityParams()
    t1 = planes(("dt", "dx", "dy"), 6, (fh, fw))
    t2 = planes(("dxt", "dyt", "dxx", "dyy", "dxy"), 3, (fh, fw))
    u, v, du, dv = (field((fh, fw), s) for s in (2.0, 2.0, 0.3, 0.3))
    d1 = planes(("dt", "dx"), 6, (dh, dw))
    d2 = planes(("dxt", "dyt", "dxx", "dxy"), 3, (dh, dw))
    ud, dud = field((dh, dw), 4.0), field((dh, dw), 0.3)
    cases = {
        "robust_flow": ((fh, fw), lambda: dispatch.robust_flow(t1, t2, u, v, du, dv, None, None,
                                                               1.0, fp, True)),
        "robust_disp": ((dh, dw), lambda: dispatch.robust_disp(d1, d2, ud, dud, None, 1.75, dp,
                                                               True)),
        "weights4_flow": ((fh, fw), lambda: dispatch.diffusion_weights_4(
            (u, v), 1e-5, "sum", increments=(du, dv))),
        "weights4_disp": ((dh, dw), lambda: dispatch.diffusion_weights_4(
            ud, 1e-5, "max", True, increments=dud)),
    }
    rows = {}
    for name, ((h, w), run) in cases.items():
        got = run()

        def plain(run=run):
            with plain_solvers():
                return run()

        want = plain()
        diff = max(float(torch.nan_to_num((a - b).abs(), 0.0).max()) for a, b in zip(got, want))
        if not bit_equal(got, want):
            fail(f"{name} {h}x{w}: the kernel is not the plain version's bits (max |d| {diff})")
        k_ms, p_ms, turns = in_turns(run, plain, reps=50, plain_reps=10)
        busy_ms, n_ops, own_ms, _ = device_profile(run, calls=10)
        p_busy, p_ops, _, _ = device_profile(plain, calls=3)
        bytes_px = 4 * REWEIGHT_PLANES[name]
        bound_ms = bytes_px * h * w / HBM_BYTES_PER_S * 1e3
        rows[name] = {"shape": [h, w], "max_abs_err": diff, "events_ms": k_ms,
                      "device_ms": own_ms,
                      "plain_events_ms": p_ms, "plain_device_ms": p_busy,
                      "plain_device_ops": p_ops, "bytes_per_px": bytes_px, "bound_ms": bound_ms,
                      "turns": turns}
        # the profiler of a long run now and then records none of a window's launches
        share = (f"{100 * bound_ms / own_ms:.1f}% of it" if own_ms > 0 else
                 "the profiler recorded none of its launches")
        print(f"  {name} {h}x{w}: == plain bit for bit; kernel {k_ms:.4f} ms by events, "
              f"{own_ms:.4f} ms device ({n_ops:.0f} op); plain {p_ms:.4f} ms, {p_busy:.4f} ms "
              f"device in {p_ops:.0f} ops; bound {bound_ms:.4f} ms ({bytes_px} B/px), {share}",
              flush=True)

    for cell, (shape, robust, calls) in REWEIGHT_CELLS.items():
        fused = flow_nd_fused if cell.startswith("flow") else disparity_nd_fused
        a = (rng.random(shape) * 255).astype(np.float32)
        b = np.roll(a, (1, 2), axis=(-2, -1))
        _graph.release_graphs()
        observe.reset()
        for k in reweight_cuda.LAUNCHES:
            reweight_cuda.LAUNCHES[k] = 0
        _, cold_s = timed(lambda: fused(a, b))
        (rec,) = observe.record()["graphs"]
        if rec["counters"] != {"reweight.kernel": 2 * calls}:
            fail(f"{cell}: the capture counted {rec['counters']}, expected "
                 f"{{'reweight.kernel': {2 * calls}}}")
        # the first call runs the frame eagerly (the warm-up), then captures it
        launched = {k: n for k, n in reweight_cuda.LAUNCHES.items() if n}
        if launched != {robust: 2 * calls, "weights4": 2 * calls}:
            fail(f"{cell}: the first call launched {launched}, expected {calls} {robust} and "
                 f"{calls} weights4 launches in the warm-up and as many in the capture")
        warm = [timed(lambda: fused(a, b))[1] for _ in range(5)]
        if any(reweight_cuda.LAUNCHES[k] != n for k, n in launched.items()):
            fail(f"{cell}: a replay launched {reweight_cuda.LAUNCHES}")
        busy_ms, n_ops, own_ms, _ = device_profile(lambda: fused(a, b), calls=3)
        rows[cell] = {"nodes": rec["nodes"], "counters": rec["counters"], "launches": launched,
                      "cold_s": cold_s, "warm_s": warm, "busy_ms": busy_ms, "device_ops": n_ops,
                      "own_ms": own_ms}
        print(f"  {cell} {shape}: capture counted {rec['counters']}; launches {launched} "
              f"(warm-up and capture), none a replay; {rec['nodes']} graph "
              f"nodes; first call {cold_s:.3f} s, warm {min(warm) * 1e3:.2f} ms "
              f"({', '.join(f'{x * 1e3:.2f}' for x in warm)}); device busy {busy_ms:.3f} ms in "
              f"{n_ops:.0f} operations, the port's kernels {own_ms:.3f} ms", flush=True)
        _graph.release_graphs()
    print("reweight " + json.dumps(rows), flush=True)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reweight-only", action="store_true",
                    help="run phases 1, 2 and 22 alone")
    args = ap.parse_args()
    t_start = time.time()

    phase("1 device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    if not (HERE / "pde_tpu_torch" / "__init__.py").is_file():
        fail(f"pde_tpu_torch not found beside {Path(__file__).name}: run it from the repository")
    sys.path.insert(0, str(HERE))
    from pde_tpu_torch.core.pyramid import pyramid_scales
    from pde_tpu_torch.kernels import (build, dispatch, interior_cuda, resident_cuda,
                                       reweight_cuda, sor_cuda, sweeps, tdma_cuda, tiled,
                                       tiled_cuda)
    from pde_tpu_torch.models.disparity import DisparityParams, disparity_nd, disparity_nd_fused
    from pde_tpu_torch.models.disparity_sym import (DisparitySymParams, disparity_sym,
                                                    disparity_sym_fused)
    from pde_tpu_torch.models.diffusion import Diffusion4Params, diffusion4
    from pde_tpu_torch.models.flow_ad import FlowADParams, flow_ad, flow_ad_fused
    from pde_tpu_torch.models.flow_fmg import FlowFMGParams, flow_fmg, flow_fmg_fused
    from pde_tpu_torch.models.gac import GACParams, gac_a, gac_a_fused, gac_b, gac_b_fused
    from pde_tpu_torch.models import segmentation as seg_mod
    from pde_tpu_torch.models.flow_hs import FlowHSParams, flow_hs
    from pde_tpu_torch.models.flow_nd import (FlowNDParams, flow_nd, flow_nd_fused,
                                              flow_nd_sequence)
    from pde_tpu_torch.models._graph import release_graphs
    from pde_tpu_torch.models.tv_denoise import (TVDenoise4Params, TVDenoise8Params,
                                                 tv_denoise4, tv_denoise4_fused, tv_denoise8,
                                                 tv_denoise8_fused)
    from pde_tpu_torch.parallel import mesh as pmesh, tiled as ptiled
    from pde_tpu_torch.solvers import aos as aos_mod
    from pde_tpu_torch.solvers import sor as plain_sor
    from pde_tpu_torch.solvers import tdma as plain_tdma

    dev = card_device()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
          f"count {torch.cuda.device_count()}", flush=True)

    def reset_counts():
        for launches in (sor_cuda.LAUNCHES, interior_cuda.LAUNCHES, tdma_cuda.LAUNCHES,
                         tiled_cuda.LAUNCHES, resident_cuda.LAUNCHES, reweight_cuda.LAUNCHES):
            for k in launches:
                launches[k] = 0

    def counts():
        return {"flow_llin4_sor": sor_cuda.LAUNCHES["flow_llin4"],
                "flow_elin4_sor": sor_cuda.LAUNCHES["flow_elin4"],
                "flow_llin8_sor": sor_cuda.LAUNCHES["flow_llin8"],
                "disp_llin4_sor": interior_cuda.LAUNCHES["disp_llin4"],
                "pde4_sor": interior_cuda.LAUNCHES["pde4"],
                "pde8_sor": interior_cuda.LAUNCHES["pde8"],
                **{f"tridiag_{k}": n for k, n in tdma_cuda.LAUNCHES.items()},
                **tiled_cuda.LAUNCHES, **resident_cuda.LAUNCHES, **reweight_cuda.LAUNCHES}

    def check_counts(what: str, expected: dict) -> None:
        got = counts()
        want = {k: expected.get(k, 0) for k in got}
        if got != want:
            fail(f"{what}: kernel launches {got}, expected {want}")
        launched = {k: n for k, n in got.items() if n} or "none"
        print(f"  kernel launches {launched}, as expected; every other kernel 0", flush=True)

    phase("2 build")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    t0 = time.time()
    sources = (sor_cuda.SOURCE, interior_cuda.SOURCE, tdma_cuda.SOURCE, tiled_cuda.SOURCE,
               resident_cuda.SOURCE, resident_cuda.SOURCE8, reweight_cuda.SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(partial(build.build, verbose=True), sources))
    sor_cuda._lib()
    interior_cuda._lib()
    tdma_cuda._lib()
    tiled_lib = tiled_cuda._lib()
    resident_lib = resident_cuda._lib()
    resident8_lib = resident_cuda._lib8()
    reweight_cuda._lib()
    sms = resident_cuda.sm_count(0)
    print(f"built {', '.join(str(p.relative_to(HERE)) for p in libs)} "
          f"in {time.time() - t0:.1f} s", flush=True)
    if args.reweight_only:
        reweight_phase(args.seed)
        print(f"total {time.time() - t_start:.1f} s", flush=True)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}),
              flush=True)
        return

    phase("3 kernels vs plain")
    rng = np.random.default_rng(args.seed)
    # the long-line, big-batch and flow_fmg-level checks draw from a
    # generator of their own, so that every other check keeps its inputs
    rng11 = np.random.default_rng(args.seed + 11)
    # and the tile kernel's channel cases theirs
    rng18 = np.random.default_rng(args.seed + 18)
    max_err = {}

    def hold(name, got, want, label, tol=None):
        torch.cuda.synchronize()
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        # a 1x1 system with a NaN Du has a zero divisor: the plain version
        # gives a non-finite value there, and the kernel must give it too
        for g, w_ in zip(got, want):
            if not torch.equal(torch.isfinite(g), torch.isfinite(w_)):
                fail(f"{name}: non-finite solver output at other pixels than the plain "
                     f"version's at {label}")
        err = max(float(torch.where(torch.isfinite(w_), g - w_, 0.0).abs().max())
                  for g, w_ in zip(got, want))
        if tol is None:
            tol = EXACT_TOL if name in EXACT else SOR_TOL
        if err > tol:
            fail(f"{name} disagrees with plain at {label}: {err} > {tol}")
        max_err[name] = max(max_err.get(name, 0.0), err)
        return err

    for h, w in SOR_SHAPES:
        for iters in (4, 5):
            for nan in (False, True):
                fields = sor_fields(rng, h, w, nan, dev)
                err = hold("flow_llin4_sor", sor_cuda.flow_llin4_sor(*fields, iters, 1.9),
                           plain_sor.sor_flow_llin4(*fields, iters, 1.9),
                           f"{h}x{w} iters={iters} nan={nan}")
                print(f"  flow_llin4_sor {h}x{w} iters={iters} nan={nan}: "
                      f"max_abs_err={err:.3g}", flush=True)
    for h, w in INTERIOR_SHAPES:
        for iters in (4, 5):
            for nan in (False, True):
                errs = []
                for b in (1, 2):
                    fields = disp_fields(rng, b, h, w, nan, dev)
                    errs.append(hold("disp_llin4_sor",
                                     interior_cuda.disp_llin4_sor(*fields, iters, 1.9),
                                     plain_sor.sor_disp_llin4(*fields, iters, 1.9),
                                     f"B={b} {h}x{w} iters={iters} nan={nan}"))
                for c in (1, 3):
                    fields = pde4_fields(rng, c, h, w, nan, dev)
                    errs.append(hold("pde4_sor", interior_cuda.pde4_sor(*fields, iters, 1.75),
                                     plain_sor.sor_pde4(*fields, iters, 1.75),
                                     f"C={c} {h}x{w} iters={iters} nan={nan}"))
                print(f"  {h}x{w} iters={iters} nan={nan}: max_abs_err disp B=1,2 "
                      f"{errs[0]:.3g}, {errs[1]:.3g}; pde4 C=1,3 {errs[2]:.3g}, "
                      f"{errs[3]:.3g}", flush=True)

    for h, w in SOR_SHAPES:
        for iters in (4, 5):
            for nan in (False, True):
                fields = llin8_fields(rng, h, w, nan, dev)
                err = hold("flow_llin8_sor", sor_cuda.flow_llin8_sor(*fields, iters, 1.9),
                           plain_sor.sor_flow_llin8(*fields, iters, 1.9),
                           f"{h}x{w} iters={iters} nan={nan}")
                print(f"  flow_llin8_sor {h}x{w} iters={iters} nan={nan}: "
                      f"max_abs_err={err:.3g}", flush=True)
    for h, w in INTERIOR_SHAPES:
        for iters in (4, 5):
            for nan in (False, True):
                errs = []
                for c in (1, 3):
                    fields = pde8_fields(rng, c, h, w, nan, dev)
                    errs.append(hold("pde8_sor", interior_cuda.pde8_sor(*fields, iters, 1.75),
                                     plain_sor.sor_pde8(*fields, iters, 1.75),
                                     f"C={c} {h}x{w} iters={iters} nan={nan}"))
                print(f"  pde8_sor {h}x{w} iters={iters} nan={nan}: max_abs_err C=1,3 "
                      f"{errs[0]:.3g}, {errs[1]:.3g}", flush=True)

    for h, w in SOR_SHAPES:
        for iters in (4, 5):
            for nan in (False, True):
                fields = elin_fields(rng, h, w, nan, dev)
                err = hold("flow_elin4_sor", sor_cuda.flow_elin4_sor(*fields, iters, 1.9),
                           plain_sor.sor_flow_elin4(*fields, iters, 1.9),
                           f"{h}x{w} iters={iters} nan={nan}")
                print(f"  flow_elin4_sor {h}x{w} iters={iters} nan={nan}: "
                      f"max_abs_err={err:.3g}", flush=True)

    # the resident kernel: the plans and the kernel agree on a block's shared
    # memory; each family against the global kernel bit for bit and against
    # the plain version (disp and pde4 bit for bit), at the solvers' shapes
    # (iters 4 and 5) and at every level of flow_nd's (llin4), the stereo
    # models' (disp, B = 1 and 2), tv_denoise4's (pde4, C = 1 and 3; iters 5)
    # and flow_hs's (elin4; iters 20) pyramids at MAIN_SHAPE (iters 4)
    flow_levels = pyramid_scales(*MAIN_SHAPE[1:], FlowNDParams().scl_factor, 20)
    stereo_levels = pyramid_scales(*MAIN_SHAPE[1:], DisparityParams().scl_factor, 10)
    tp4_, hp_ = TVDenoise4Params(), FlowHSParams()
    tv4_levels_hw = partial_pyramid_shapes(MAIN_SHAPE, tp4_.scl, tp4_.scl_factor)
    hs_levels_hw = pyramid_scales(*MAIN_SHAPE[1:], hp_.scl_factor, 20, hp_.scales)
    sor_levels = {"llin4": flow_levels, "disp": stereo_levels, "pde4": tv4_levels_hw,
                  "elin4": hs_levels_hw}
    for fam_i, family in enumerate(resident_cuda.SOR_FAMILIES):
        for h, w in sor_levels[family]:
            for b in range(1, resident_cuda.MAX_BATCH[family] + 1):
                pl = resident_cuda.plan_resident(h, w, family, b, sms)
                if pl is None:
                    fail(f"no resident {family} plan for a level of {h}x{w}, B={b}")
                got = resident_lib.resident_sor_smem_bytes(fam_i, b, pl.rows, w)
                if got != pl.smem_bytes:
                    fail(f"resident plan {pl} at {h}x{w}: the kernel counts {got} bytes")
    resident_cases = 0
    for h, w in SOR_SHAPES + flow_levels:
        if resident_cuda.plan_resident(h, w, "llin4", 1, sms) is None:
            print(f"  resident_flow_llin4 {h}x{w}: no plan (the global kernel takes it)",
                  flush=True)
            continue
        errs = []
        for iters in ((4, 5) if (h, w) in SOR_SHAPES else (4,)):
            for nan in (False, True):
                fields = sor_fields(rng, h, w, nan, dev)
                got = resident_cuda.flow_llin4_sor(*fields, iters, 1.9)
                label = f"{h}x{w} iters={iters} nan={nan}"
                errs.append(hold("resident_flow_llin4", got,
                                 plain_sor.sor_flow_llin4(*fields, iters, 1.9), label))
                if not bit_equal(got, sor_cuda.flow_llin4_sor(*fields, iters, 1.9)):
                    fail(f"resident_flow_llin4 at {label}: not the global kernel's bits")
                resident_cases += 1
        scope = resident_cuda.plan_resident(h, w, "llin4", 1, sms).scope
        print(f"  resident_flow_llin4 {h}x{w} ({scope}): == flow_llin4_sor bit for bit; "
              f"max_abs_err vs plain {max(errs):.3g}", flush=True)
    for h, w in INTERIOR_SHAPES + stereo_levels:
        for b in (1, 2):
            pl = resident_cuda.plan_resident(h, w, "disp", b, sms)
            if pl is None:
                print(f"  resident_disp_llin4 {h}x{w} B={b}: no plan (the global kernel takes "
                      f"it)", flush=True)
                continue
            for iters in ((4, 5) if (h, w) in INTERIOR_SHAPES else (4,)):
                for nan in (False, True):
                    fields = disp_fields(rng, b, h, w, nan, dev)
                    label = f"B={b} {h}x{w} iters={iters} nan={nan}"
                    if b == 1:
                        got = resident_cuda.disp_llin4_sor(*fields, iters, 1.9)
                    else:  # the symmetric pair's form: two sets of planes
                        got = torch.stack(resident_cuda.disp_llin4_pair(
                            [f[0] for f in fields], [f[1] for f in fields], iters, 1.9))
                    want = plain_sor.sor_disp_llin4(*fields, iters, 1.9)
                    hold("resident_disp_llin4", got, want, label)
                    glob = interior_cuda.disp_llin4_sor(*fields, iters, 1.9)
                    if not (bit_equal((got,), (want,)) and bit_equal((got,), (glob,))):
                        fail(f"resident_disp_llin4 at {label}: not the plain version's and the "
                             f"global kernel's bits")
                    resident_cases += 1
            print(f"  resident_disp_llin4 {h}x{w} B={b} ({pl.scope}): == disp_llin4_sor and "
                  f"plain bit for bit", flush=True)
    # pde4 as tv_denoise4 calls it: C channels over shared (H, W) weights,
    # TRACE and B per channel or one shared plane
    for h, w in INTERIOR_SHAPES + tv4_levels_hw:
        for c in (1, 3):
            pl = resident_cuda.plan_resident(h, w, "pde4", c, sms)
            if pl is None:
                print(f"  resident_pde4 {h}x{w} C={c}: no plan (the global kernel takes it)",
                      flush=True)
                continue
            at_level = (h, w) not in INTERIOR_SHAPES
            for iters in ((tp4_.inner_iter,) if at_level else (4, 5)):
                for shared in ((False,) if c == 1 else (False, True)):
                    for nan in (False, True):
                        fields = pde4_fields(rng, c, h, w, nan, dev, shared)
                        label = f"C={c} {h}x{w} iters={iters} shared={shared} nan={nan}"
                        got = resident_cuda.pde4_sor(*fields, iters, tp4_.omega)
                        want = plain_sor.sor_pde4(*fields, iters, tp4_.omega)
                        hold("resident_pde4", got, want, label)
                        glob = interior_cuda.pde4_sor(*fields, iters, tp4_.omega)
                        if not (bit_equal((got,), (want,)) and bit_equal((got,), (glob,))):
                            fail(f"resident_pde4 at {label}: not the plain version's and the "
                                 f"global kernel's bits")
                        resident_cases += 1
            print(f"  resident_pde4 {h}x{w} C={c} ({pl.scope} {pl.blocks}/{pl.slots}): == "
                  f"pde4_sor and plain bit for bit", flush=True)
    # elin4 as flow_hs calls it (every level 20 sweeps) and as flow_fmg does
    # (every level 4)
    elin_cases = [(h, w, (4, 5) if (h, w) in SOR_SHAPES else (hp_.iter,), rng)
                  for h, w in SOR_SHAPES + hs_levels_hw] + \
        [(h, w, (FlowFMGParams().iter,), rng11) for h, w in fmg_levels(MAIN_SHAPE)]
    for h, w, iters_all, gen in elin_cases:
        pl = resident_cuda.plan_resident(h, w, "elin4", 1, sms)
        if pl is None:
            print(f"  resident_flow_elin4 {h}x{w}: no plan (the global kernel takes it)",
                  flush=True)
            continue
        errs, spreads = [], []
        for iters in iters_all:
            for nan in (False, True):
                fields = elin_fields(gen, h, w, nan, dev)
                label = f"{h}x{w} iters={iters} nan={nan}"
                got = resident_cuda.flow_elin4_sor(*fields, iters, 1.9)
                want = plain_sor.sor_flow_elin4(*fields, iters, 1.9)
                # the draw's rounding spread: the plain arithmetic in float64
                w64 = plain_sor.sor_flow_elin4(*(x.double() for x in fields), iters, 1.9)
                spreads.append(max(
                    float(torch.where(torch.isfinite(b), a.double() - b, 0.0).abs().max())
                    for a, b in zip(want, w64)))
                errs.append(hold("resident_flow_elin4", got, want, label,
                                 tol=max(SOR_TOL, ELIN4_SPREADS * spreads[-1])))
                if not bit_equal(got, sor_cuda.flow_elin4_sor(*fields, iters, 1.9)):
                    fail(f"resident_flow_elin4 at {label}: not the global kernel's bits")
                resident_cases += 1
        print(f"  resident_flow_elin4 {h}x{w} ({pl.scope} {pl.blocks}/{pl.slots}): == "
              f"flow_elin4_sor bit for bit; max_abs_err vs plain {max(errs):.3g} (plain "
              f"float32 vs float64 {max(spreads):.3g})", flush=True)
    print(f"  resident kernel: {resident_cases} cases, each bit for bit against the global "
          f"kernel", flush=True)

    # the resident 8-neighbour kernel: the plans and the kernel agree on a
    # block's shared memory and the grid's edge scratch; llin8 against the
    # global kernel bit for bit and the plain version to SOR_TOL, pde8 against
    # both bit for bit (C = 1 and 3, shared weights), at the solvers' shapes
    # (iters 4 and 5) and at every level of flow_ad's (llin8) and
    # tv_denoise8's (pde8) pyramids at MAIN_SHAPE (iters 4)
    ad_levels_hw = pyramid_scales(*MAIN_SHAPE[1:], FlowADParams().scl_factor, 20)
    tp8_ = TVDenoise8Params()
    tv8_levels_hw = partial_pyramid_shapes(MAIN_SHAPE, tp8_.scl, tp8_.scl_factor)
    for fam_i, (family, levels, batches) in enumerate((("llin8", ad_levels_hw, (1,)),
                                                        ("pde8", tv8_levels_hw, (1, 3)))):
        for h, w in levels:
            for b in batches:
                pl = resident_cuda.plan_resident(h, w, family, b, sms)
                if pl is None:
                    fail(f"no resident {family} plan for a level of {h}x{w}, B={b}")
                got = resident8_lib.resident8_smem_bytes(fam_i, b, pl.rows, w)
                edge = resident8_lib.resident8_edge_floats(fam_i, b, pl.blocks, w)
                if got != pl.smem_bytes or edge != resident_cuda.edge_floats(family, b, pl.blocks,
                                                                              w):
                    fail(f"resident plan {pl} at {h}x{w}: the kernel counts {got} bytes, "
                         f"{edge} edge floats")
    resident8_cases = 0
    for h, w in SOR_SHAPES + ad_levels_hw:
        pl = resident_cuda.plan_resident(h, w, "llin8", 1, sms)
        if pl is None:
            print(f"  resident_flow_llin8 {h}x{w}: no plan (the global kernel takes it)",
                  flush=True)
            continue
        errs = []
        for iters in ((4, 5) if (h, w) in SOR_SHAPES else (4,)):
            for nan in (False, True):
                fields = llin8_fields(rng, h, w, nan, dev)
                got = resident_cuda.flow_llin8_sor(*fields, iters, 1.9)
                label = f"{h}x{w} iters={iters} nan={nan}"
                errs.append(hold("resident_flow_llin8", got,
                                 plain_sor.sor_flow_llin8(*fields, iters, 1.9), label))
                if not bit_equal(got, sor_cuda.flow_llin8_sor(*fields, iters, 1.9)):
                    fail(f"resident_flow_llin8 at {label}: not the global kernel's bits")
                resident8_cases += 1
        print(f"  resident_flow_llin8 {h}x{w} ({pl.scope} {pl.blocks}/{pl.slots}): == "
              f"flow_llin8_sor bit for bit; max_abs_err vs plain {max(errs):.3g}", flush=True)
    for h, w in INTERIOR_SHAPES + tv8_levels_hw:
        for c in (1, 3):
            pl = resident_cuda.plan_resident(h, w, "pde8", c, sms)
            if pl is None:
                print(f"  resident_pde8 {h}x{w} C={c}: no plan (the global kernel takes it)",
                      flush=True)
                continue
            for iters in ((4, 5) if (h, w) in INTERIOR_SHAPES else (4,)):
                for nan in (False, True):
                    fields = pde8_fields(rng, c, h, w, nan, dev)
                    label = f"C={c} {h}x{w} iters={iters} nan={nan}"
                    got = resident_cuda.pde8_sor(*fields, iters, 1.75)
                    want = plain_sor.sor_pde8(*fields, iters, 1.75)
                    hold("resident_pde8", got, want, label)
                    glob = interior_cuda.pde8_sor(*fields, iters, 1.75)
                    if not (bit_equal((got,), (want,)) and bit_equal((got,), (glob,))):
                        fail(f"resident_pde8 at {label}: not the plain version's and the global "
                             f"kernel's bits")
                    resident8_cases += 1
            print(f"  resident_pde8 {h}x{w} C={c} ({pl.scope} {pl.blocks}/{pl.slots}): == "
                  f"pde8_sor and plain bit for bit", flush=True)
    print(f"  resident 8-neighbour kernel: {resident8_cases} cases, each bit for bit against "
          f"the global kernel", flush=True)

    # the tile kernel: the plan and the kernel agree on a slot's bytes (a
    # set of planes a channel where a block holds them all) and a block's
    # threads, for every family's plans at each batch it takes and for odd
    # tiles a plan_override may ask for
    for family, layout in tiled.LAYOUTS.items():
        for db, batch in itertools.product((False, True), range(1, layout.max_batch + 1)):
            plan = tiled.plan_tiles(*TIME_SHAPES[-1], family, 4, 4, double_buffer=db, batch=batch)
            slot = tiled_lib.tiled_sor_slot_bytes(layout.index, plan.k, plan.tile_h, plan.tile_w,
                                                  batch)
            if (2 if db else 1) * slot != plan.smem_bytes:
                fail(f"tile plan {plan} and the kernel's slot of {slot} bytes disagree")
            print(f"  tile plan {family} double_buffer={db} batch={batch}: {plan}", flush=True)
        for tile, batch in itertools.product(((3, 7, 9), (1, 1, 1), (2, 16, 5), (4, 16, 48)),
                                             range(1, layout.max_batch + 1)):
            kernel_bytes = tiled_lib.tiled_sor_slot_bytes(layout.index, *tile, batch)
            if kernel_bytes != tiled.slot_bytes(family, *tile, batch):
                fail(f"slot bytes of {family} {tile} batch={batch}: kernel {kernel_bytes}, "
                     f"plan {tiled.slot_bytes(family, *tile, batch)}")
        for plan_args in ((4, 32, 32, 2), (3, 7, 9, 1), (4, 24, 48, 4), (1, 1, 1, 3),
                          (4, 16, 48, 3)):
            if tiled_lib.tiled_sor_threads(layout.index, *plan_args) != tiled.block_threads(
                    family, *plan_args):
                fail(f"threads of {family} {plan_args}: kernel "
                     f"{tiled_lib.tiled_sor_threads(layout.index, *plan_args)}, "
                     f"plan {tiled.block_threads(family, *plan_args)}")

    def tiled_run(name, fields, iters, k_max, plain=False):
        family, db = TILED[name]
        prep, sw = getattr(sweeps, f"{family}_sweep")(1.9)
        if not plain:
            return tiled.tiled_relax(fields, sw, 2, iters, k_max=k_max, prepare_fn=prep,
                                     double_buffer=db)
        with dispatch.plain_solvers():
            return tiled.tiled_relax(fields, sw, 2, iters, k_max=k_max, prepare_fn=prep)

    tiled_vs_global = {}
    for h, w in TILE_SHAPES:
        for iters in (4, 5):
            for k in TILED_KS:
                for nan in (False, True):
                    line = []
                    for family, make, glob in (("flow_llin4", sor_fields, sor_cuda.flow_llin4_sor),
                                               ("flow_elin4", elin_fields,
                                                sor_cuda.flow_elin4_sor)):
                        fields = make(rng, h, w, nan, dev)
                        tf = tile_order(family, fields)
                        # the plain schedule is exact whatever its tiles
                        # (tests/test_torch_tiled.py): here one tile, k sweeps a chunk
                        prep, sw = getattr(sweeps, f"{family}_sweep")(1.9)
                        with dispatch.plain_solvers():
                            want = tiled.tiled_relax(tf, sw, 2, iters, prepare_fn=prep,
                                                     plan_override=(k, (h, w)))
                        label = f"{h}x{w} iters={iters} k_max={k} nan={nan}"
                        serial, db = (tiled_run(f"tiled_{family}{sfx}", tf, iters, k)
                                      for sfx in ("", "_db"))
                        errs = [hold(f"tiled_{family}", serial, want, label),
                                hold(f"tiled_{family}_db", db, want, label)]
                        if not bit_equal(serial, db):
                            fail(f"tiled_{family}: serial and double-buffered differ at {label}")
                        g = glob(*fields, iters, 1.9)
                        torch.cuda.synchronize()
                        d_glob = max(float(torch.where(torch.isfinite(b), a - b, 0.0).abs().max())
                                     for a, b in zip(serial, g))
                        tiled_vs_global[family] = max(tiled_vs_global.get(family, 0.0), d_glob)
                        if not bit_equal(serial, g):
                            fail(f"tiled_{family} at {label}: not the global kernel's bits "
                                 f"(max |d| {d_glob})")
                        line.append(f"{family} {errs[0]:.3g} (serial == double-buffered == "
                                    f"global kernel bit for bit)")
                    print(f"  tiled {label}: max_abs_err " + ", ".join(line), flush=True)
    print(f"  tile kernels vs the global kernels, max-abs over every case: {tiled_vs_global} "
          f"(bit for bit)", flush=True)

    # the windowed variant: every shard's chunk of a sharded solve over
    # MAIN_SHAPE's plane on a virtual mesh of this card, serial and
    # double-buffered, against the plain windowed schedule (the same sharded
    # solve over a CPU mesh, on CPU copies) and bit for bit against the
    # global kernel
    win_cases = 0
    mh, mw = MAIN_SHAPE[1:]
    for ty, tx in WIN_MESHES:
        card_mesh = pmesh.make_mesh(ty, tx, devices=[dev] * (ty * tx))
        cpu_mesh = pmesh.make_mesh(ty, tx, devices=["cpu"] * (ty * tx))
        for family, make, glob in (("flow_llin4", sor_fields, sor_cuda.flow_llin4_sor),
                                   ("flow_elin4", elin_fields, sor_cuda.flow_elin4_sor)):
            factory = getattr(sweeps, f"{family}_sweep")
            for k in TILED_KS:
                for iters in (4, 9):
                    for nan in (False, True):
                        fields = make(rng, mh, mw, nan, dev)
                        tf = tile_order(family, fields)
                        want = ptiled.tiled_relax_sharded(cpu_mesh, factory, [x.cpu() for x in tf],
                                                          2, iters, 1.9, k=k)
                        want = tuple(x.to(dev) for x in want)
                        serial, db = (ptiled.tiled_relax_sharded(card_mesh, factory, tf, 2, iters,
                                                                 1.9, k=k, double_buffer=d)
                                      for d in (False, True))
                        label = f"{ty}x{tx} mesh over {mh}x{mw} iters={iters} k={k} nan={nan}"
                        errs = [hold(f"tiled_{family}_win", serial, want, label),
                                hold(f"tiled_{family}_win_db", db, want, label)]
                        if not bit_equal(serial, db):
                            fail(f"tiled_{family}_win: serial and double-buffered differ at {label}")
                        if not bit_equal(serial, glob(*fields, iters, 1.9)):
                            fail(f"tiled_{family}_win at {label}: not the global kernel's bits")
                        win_cases += 1
                        print(f"  windowed {family} {label}: max_abs_err {errs[0]:.3g} against the "
                              f"plain windowed schedule on the CPU; == double-buffered == global "
                              f"kernel bit for bit", flush=True)
    print(f"  windowed variant: {win_cases} sharded solves, each bit for bit against the global "
          f"kernel", flush=True)

    # the tile kernel's other families, serial, at the default plan (k_max =
    # 4): against the plain tile schedule on the card (one tile the image's
    # size: the schedule is exact whatever its tiles), bit for bit against
    # the global kernel that served the shape before, and disp and pde bit
    # for bit against the plain global solver too
    def new_fields(family, batch, h, w, nan, shared=False, gen=None):
        """The solver's fields of ``family`` (its global kernel's order),
        drawn from ``gen`` (by default ``rng``)."""
        gen = rng if gen is None else gen
        if family == "flow_llin8":
            return llin8_fields(gen, h, w, nan, dev)
        if family == "disp_llin4":
            return disp_fields(gen, batch, h, w, nan, dev)
        return (pde4_fields if family == "pde4" else pde8_fields)(gen, batch, h, w, nan, dev,
                                                                  shared)

    new_global = {"flow_llin8": (sor_cuda.flow_llin8_sor, plain_sor.sor_flow_llin8, 1.9),
                  "disp_llin4": (interior_cuda.disp_llin4_sor, plain_sor.sor_disp_llin4, 1.9),
                  "pde4": (interior_cuda.pde4_sor, plain_sor.sor_pde4, 1.75),
                  "pde8": (interior_cuda.pde8_sor, plain_sor.sor_pde8, 1.75)}

    def new_tiled(family, tf, iters, omega, plain=False, **kw):
        """The tile engine's solve of ``family`` on the fields ``tf`` (its
        order): the kernel, or with ``plain`` the plain schedule on the card
        over one tile the image's size."""
        prep, sw = getattr(sweeps, f"{family}_sweep")(omega)
        n_mut = tiled.LAYOUTS[family].n_mut
        if not plain:
            return tiled.tiled_relax(tf, sw, n_mut, iters, prepare_fn=prep, **kw)
        with dispatch.plain_solvers():
            return tiled.tiled_relax(tf, sw, n_mut, iters, prepare_fn=prep,
                                     plan_override=(4, tuple(tf[0].shape[-2:])))

    def as_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    new_cases = 0
    for (family, batch, shared, (h, w)), gen in ([(c, rng) for c in NEW_TILE_CASES]
                                                 + [(c, rng18) for c in CHANNEL_CASES]):
        glob, plain_glob, omega = new_global[family]
        name = f"tiled_{family}"
        for iters in (4, 5):
            for nan in (False, True):
                fields = new_fields(family, batch, h, w, nan, shared, gen)
                tf = tile_order(family, fields)
                label = (f"{'B' if family == 'disp_llin4' else 'C'}={batch}"
                         f"{' shared TRACE, B' if shared else ''} {h}x{w} iters={iters} nan={nan}")
                got = new_tiled(family, tf, iters, omega)
                want = new_tiled(family, tf, iters, omega, plain=True)
                hold(name, got, want, label)
                db = new_tiled(family, tf, iters, omega, double_buffer=True)
                hold(f"{name}_db", db, want, label)
                if not bit_equal(db, got):
                    fail(f"{name}_db at {label}: not the serial form's bits")
                g = as_tuple(glob(*fields, iters, omega))
                if not bit_equal(got, g):
                    fail(f"{name} at {label}: not the global kernel's bits")
                if tiled.LAYOUTS[family].fill and not bit_equal(
                        got, as_tuple(plain_glob(*fields, iters, omega))):
                    fail(f"{name} at {label}: not the plain global solver's bits")
                new_cases += 1
        print(f"  {name} {label.split(' iters')[0]}: serial == double-buffered == "
              f"{glob.__name__} bit for bit"
              f"{' and the plain global solver' if tiled.LAYOUTS[family].fill else ''}, "
              f"max_abs_err {max_err[name]:.3g} against the plain tile schedule", flush=True)
    print(f"  the tile kernel's other families: {new_cases} cases, each serial and "
          f"double-buffered bit for bit against the global kernel", flush=True)

    # their windowed variant, through the sharded llin8, disp and pde4
    # solvers at the shards of WIN_MESHES over MAIN_SHAPE's plane: 9 sweeps
    # in chunks of k, bit for bit against the global kernel (and disp and pde4
    # against the plain global solver, the max-abs error's reference)
    new_win = {"flow_llin8": ptiled.tiled_sor_flow_llin8, "disp_llin4": ptiled.tiled_sor_disp_llin4,
               "pde4": ptiled.tiled_sor_pde4}
    new_win_cases = 0
    for ty, tx in WIN_MESHES:
        card_mesh = pmesh.make_mesh(ty, tx, devices=[dev] * (ty * tx))
        for family, sharded in new_win.items():
            glob, plain_glob, omega = new_global[family]
            layout = tiled.LAYOUTS[family]
            for k in NEW_WIN_KS:
                for nan in (False, True):
                    fields = new_fields(family, 1, mh, mw, nan)
                    tf = tile_order(family, fields)
                    got, db = (ptiled.tiled_relax_sharded(card_mesh,
                                                          getattr(sweeps, f"{family}_sweep"), tf,
                                                          layout.n_mut, 9, omega, k=k,
                                                          double_buffer=d)
                               for d in (False, True))
                    label = f"{ty}x{tx} mesh over {mh}x{mw} iters=9 k={k} nan={nan}"
                    want = as_tuple(plain_glob(*fields, 9, omega))
                    hold(f"tiled_{family}_win", got, want, label)
                    hold(f"tiled_{family}_win_db", db, want, label)
                    if not bit_equal(db, got):
                        fail(f"tiled_{family}_win_db at {label}: not the serial variant's bits")
                    if not bit_equal(got, as_tuple(glob(*fields, 9, omega))):
                        fail(f"tiled_{family}_win at {label}: not the global kernel's bits")
                    new_win_cases += 1
            got = as_tuple(sharded(card_mesh, *fields, 9, omega))
            if not bit_equal(got, as_tuple(glob(*fields, 9, omega))):
                fail(f"{sharded.__name__} on a {ty}x{tx} mesh: not the global kernel's bits")
            print(f"  windowed {family} on a {ty}x{tx} mesh, k = {NEW_WIN_KS}: serial == "
                  f"double-buffered == {glob.__name__} bit for bit, max_abs_err "
                  f"{max_err[f'tiled_{family}_win']:.3g} against the plain global solver",
                  flush=True)
    print(f"  windowed other families: {new_win_cases} sharded solves, each bit for bit against "
          f"the global kernel", flush=True)

    # pde4's windowed variant over a batch of channels (a block holds them
    # all), serial and double-buffered: against the plain global solver,
    # and bit for bit against the serial tile kernel's chunk over the whole
    # image
    prep4, sw4 = sweeps.pde4_sweep(1.75)
    halo4 = tiled._halo_for("pde4", 4)
    win_channel_cases = 0
    for c, shared in ((1, False), (2, True), (2, False), (3, True), (3, False)):
        fields = new_fields("pde4", c, 481, 641, True, shared, rng18)
        serial = new_tiled("pde4", fields, 4, 1.75)
        want = as_tuple(plain_sor.sor_pde4(*fields, 4, 1.75))
        for R0, R1, C0, C1 in CHANNEL_WINDOWS:
            r0, r1 = max(0, R0 - halo4), min(481, R1 + halo4)
            c0, c1 = max(0, C0 - halo4), min(641, C1 + halo4)
            sub = [x[..., r0:r1, c0:c1].contiguous() for x in fields]
            win = tiled.Window(r0, c0, 481, 641, (R0 - r0, R1 - r0, C0 - c0, C1 - c0))
            label = (f"C={c}{' shared TRACE, B' if shared else ''} box {(R0, R1, C0, C1)} of "
                     f"481x641 iters=4")
            for db in (False, True):
                name = "tiled_pde4_win" + ("_db" if db else "")
                got = tiled.tiled_relax(sub, sw4, 1, 4, prepare_fn=prep4, window=win,
                                        double_buffer=db)
                hold(name, got, tuple(x[..., R0:R1, C0:C1] for x in want), label)
                if not bit_equal(got, tuple(x[..., R0:R1, C0:C1] for x in serial)):
                    fail(f"{name} at {label}: not the serial tile kernel's bits")
                win_channel_cases += 1
    print(f"  windowed pde4 over 1 to 3 channels: {win_channel_cases} chunks, serial and "
          f"double-buffered each bit for bit against the serial tile kernel, max_abs_err "
          f"{max_err['tiled_pde4_win']:.3g} against the plain global solver", flush=True)

    def hold_tridiag(a, b, c, d, label):
        """Whole solves, zebra parity solves and fused zebra passes along
        both axes, kernel against plain on the same inputs."""
        errs, zebra_errs = [], []
        for axis in (-2, -1):
            vertical = axis == -2
            with dispatch.plain_solvers():
                want = dispatch.thomas_solve(a, b, c, d, axis)
                facs = dispatch.line_factors(a, b, c, vertical)
                want_par = [dispatch.line_solve(facs, d, par, vertical) for par in (0, 1)]
            errs.append(hold("tridiag", tdma_cuda.thomas_solve(a, b, c, d, axis), want,
                             f"{label} axis={axis} whole"))
            fac = tdma_cuda.tridiag_factor(a, b, c, axis)
            errs.append(hold("tridiag", tdma_cuda.tridiag_solve(fac, d), want,
                             f"{label} axis={axis} factor/replay"))
            for par in (0, 1):
                got = tdma_cuda.tridiag_solve(fac, d, par)
                if got.shape != want_par[par].shape:
                    fail(f"tridiag parity {par} at {label} axis={axis}: shape "
                         f"{tuple(got.shape)}, plain {tuple(want_par[par].shape)}")
                if got.numel():
                    errs.append(hold("tridiag", got, want_par[par],
                                     f"{label} axis={axis} parity={par}"))
                # the fused pass: scalar, coupled, 8 neighbours and both, one
                # form for each (axis, parity), so that each shape has all four
                z, rhs, z_o, m, w_lo, w_hi, *w_d = zebra_fields(rng, tuple(d.shape), dev,
                                                                 shared=a.ndim < d.ndim)
                forms = (("scalar", {}), ("coupled", dict(z_o=z_o, m=m)),
                         ("8 neighbours", dict(w_diag=tuple(w_d))),
                         ("coupled, 8 neighbours", dict(z_o=z_o, m=m, w_diag=tuple(w_d))))
                for form, extra in (forms[2 * (axis == -1) + par],):
                    with dispatch.plain_solvers():
                        want_z = dispatch.zebra_pass(facs, z, rhs, w_lo, w_hi, par, vertical,
                                                     **extra)
                    got_z = tdma_cuda.zebra_pass(fac, z.clone(), rhs, w_lo, w_hi, par, **extra)
                    zebra_errs.append(hold("tridiag_zebra_pass", got_z, want_z,
                                           f"{label} axis={axis} parity={par} {form}"))
                    if not bit_equal((got_z,), (want_z,)):
                        fail(f"tridiag_zebra_pass at {label} axis={axis} parity={par} {form}: "
                             f"not the plain version's bits")
        print(f"  tridiag {label}: max_abs_err {max(errs):.3g} over {len(errs)} solves "
              f"(whole, factor/replay, parity 0 and 1, both axes); fused zebra pass "
              f"{max(zebra_errs):.3g} over {len(zebra_errs)} (scalar, coupled, 8 neighbours, "
              f"both, one an axis and parity; bit for bit)", flush=True)

    # the line plan and the kernel agree on a block's shared memory, staged
    # and global-rows variants
    tdma_lib = tdma_cuda._lib()
    for mode_i, mode in enumerate(tdma_cuda.MODES):
        for coupled, diag in ((False, False), (True, False), (True, True)):
            for length in (1, 480, 641, 1024, 30_000, 65_536):
                pl = tdma_cuda.plan_lines(1, length, 7, True, None if mode != "zebra" else 0, mode,
                                          coupled, diag)
                if pl.global_rows != (length >= 30_000):
                    fail(f"line plan {pl} for L={length}: the wrong variant")
                got = tdma_lib.tridiag_smem_bytes(mode_i, int(coupled), int(diag), length, pl.g,
                                                  pl.r, pl.stages, int(pl.global_rows))
                if got != pl.smem_bytes:
                    fail(f"line plan {pl} ({mode}, coupled={coupled}, diag={diag}, L={length}): "
                         f"the kernel counts {got} bytes")
    print(f"  line plans: {tdma_cuda.plan_lines(1, 481, 641, True, 0, 'zebra', True)} "
          f"(481x641 fused pass, coupled) and the kernel agree on shared memory", flush=True)
    for shape in TRIDIAG_SHAPES:
        hold_tridiag(*tridiag_fields(rng, shape, dev), f"{shape[0]}x{shape[1]}")
    # pcg_pde4's coefficients: (H, W) off-diagonals shared by a (3, H, W)
    # diagonal; the symmetric pair's: a batch of 2 with its own planes
    hold_tridiag(*tridiag_fields(rng, (3,) + MAIN_SHAPE[1:], dev, shared=True),
                 f"{MAIN_SHAPE} shared a, c")
    hold_tridiag(*tridiag_fields(rng, (2, 481, 641), dev), "(2, 481, 641)")
    # diffusion4's: every coefficient one shared plane, d (3, H, W)
    a, b, c, d = tridiag_fields(rng, (3,) + MAIN_SHAPE[1:], dev)
    hold_tridiag(a[0], b[0], c[0], d, f"{MAIN_SHAPE} shared a, b, c")

    def hold_tridiag_cpu(name, a, b, c, d, axis, label):
        """Whole solve, factor/replay, parity 0 and 1 solves and the fused
        zebra pass (scalar and coupled on parity 0, scalar on parity 1)
        along ``axis``, the kernel against the plain version run on CPU
        copies (on the card the plain scan costs ~5 launches a line step),
        bit for bit."""
        vertical = axis == -2
        ac, bc, cc, dc = (x.cpu() for x in (a, b, c, d))
        want = plain_tdma.thomas_solve(ac, bc, cc, dc, axis)
        facs = plain_tdma.line_factors(ac, bc, cc, vertical)
        fac = tdma_cuda.tridiag_factor(a, b, c, axis)
        cases = [("whole", lambda: tdma_cuda.thomas_solve(a, b, c, d, axis), want),
                 ("factor/replay", lambda: tdma_cuda.tridiag_solve(fac, d), want)]
        z, rhs, z_o, m, w_lo, w_hi, *_ = zebra_fields(rng11, tuple(d.shape), dev,
                                                       shared=a.ndim < d.ndim)
        zc, rc, zoc, mc, loc, hic = (x.cpu() for x in (z, rhs, z_o, m, w_lo, w_hi))
        for par in (0, 1):
            if not len(range(par, d.shape[-1] if vertical else d.shape[-2], 2)):
                continue
            cases.append((f"parity {par}", partial(tdma_cuda.tridiag_solve, fac, d, par),
                          plain_tdma.line_solve(facs, dc, par, vertical)))
            for form in ("scalar", "coupled")[:2 - par]:
                extra = dict(z_o=z_o, m=m) if form == "coupled" else {}
                extra_c = dict(z_o=zoc, m=mc) if form == "coupled" else {}
                cases.append((f"zebra pass {form} parity {par}",
                              lambda par=par, extra=extra: tdma_cuda.zebra_pass(
                                  fac, z.clone(), rhs, w_lo, w_hi, par, **extra),
                              plain_tdma.zebra_pass(facs, zc, rc, loc, hic, par, vertical,
                                                    **extra_c)))
        errs = []
        for what, run, want in cases:
            got = run()
            if got.shape != want.shape:
                fail(f"{name} {what} at {label}: shape {tuple(got.shape)}, plain "
                     f"{tuple(want.shape)}")
            want = want.to(dev)
            errs.append(hold(name, got, want, f"{label} {what}"))
            if not bit_equal((got,), (want,)):
                fail(f"{name} {what} at {label}: not the plain version's bits")
        print(f"  {name} {label}: max_abs_err {max(errs):.3g} over {len(errs)} solves and "
              f"passes ({', '.join(w for w, _, _ in cases)}; bit for bit)", flush=True)

    long_before = {k: n for k, n in tdma_cuda.LAUNCHES.items() if k.endswith("_long")}
    for shape, axis in LONG_LINES:
        hold_tridiag_cpu("tridiag_long", *tridiag_fields(rng11, shape, dev), axis,
                         f"{shape[0]}x{shape[1]} axis={axis} (L = {shape[axis]})")
    long_ran = {k: n - long_before[k] for k, n in tdma_cuda.LAUNCHES.items() if k in long_before}
    if not all(long_ran.values()):
        fail(f"the long lines did not all take the global-rows variant: {long_ran}")
    print(f"  global-rows launches {long_ran}", flush=True)
    staged_before = dict(tdma_cuda.LAUNCHES)
    for axis in (-2, -1):
        hold_tridiag_cpu("tridiag", *tridiag_fields(rng11, BIG_BATCH, dev), axis,
                         f"batch {BIG_BATCH} axis={axis}")
    if any(tdma_cuda.LAUNCHES[k] != n for k, n in staged_before.items() if k.endswith("_long")):
        fail(f"a batch of short lines took the global-rows variant")

    times, bounds = {}, {}
    for h, w in TIME_SHAPES + [MAIN_SHAPE[1:]]:
        px = h * w
        cases = {
            # (kernel, plain, bytes each input read once and each output
            # written once, relaxed pixels per sweep)
            "flow_llin4_sor": (sor_cuda.flow_llin4_sor, plain_sor.sor_flow_llin4,
                               sor_fields(rng, h, w, True, dev), 1.9, (13 + 2) * 4 * px, px),
            # disparity_nd's call: B = 1
            "disp_llin4_sor": (interior_cuda.disp_llin4_sor, plain_sor.sor_disp_llin4,
                               disp_fields(rng, 1, h, w, True, dev), 1.9, (8 + 1) * 4 * px,
                               (h - 2) * (w - 2)),
            # tv_denoise4's call: C = 3 channels, shared weights
            "pde4_sor": (interior_cuda.pde4_sor, plain_sor.sor_pde4,
                         pde4_fields(rng, 3, h, w, True, dev), 1.75, (4 * 3 + 4) * 4 * px,
                         3 * (h - 2) * (w - 2)),
            # flow_hs's call with solver=1: every pixel relaxed
            "flow_elin4_sor": (sor_cuda.flow_elin4_sor, plain_sor.sor_flow_elin4,
                               elin_fields(rng, h, w, True, dev), 1.9, (11 + 2) * 4 * px, px),
            # the resident kernel at tv_denoise4's and flow_hs's calls
            "resident_pde4": (resident_cuda.pde4_sor, plain_sor.sor_pde4,
                              pde4_fields(rng, 3, h, w, True, dev), 1.75, (4 * 3 + 4) * 4 * px,
                              3 * (h - 2) * (w - 2)),
            "resident_flow_elin4": (resident_cuda.flow_elin4_sor, plain_sor.sor_flow_elin4,
                                    elin_fields(rng, h, w, True, dev), 1.9, (11 + 2) * 4 * px,
                                    px),
            # the resident kernel at flow_nd's and disparity_nd's calls
            "resident_flow_llin4": (resident_cuda.flow_llin4_sor, plain_sor.sor_flow_llin4,
                                    sor_fields(rng, h, w, True, dev), 1.9, (13 + 2) * 4 * px,
                                    px),
            "resident_disp_llin4": (resident_cuda.disp_llin4_sor, plain_sor.sor_disp_llin4,
                                    disp_fields(rng, 1, h, w, True, dev), 1.9, (8 + 1) * 4 * px,
                                    (h - 2) * (w - 2)),
            # flow_ad's call: every pixel relaxed
            "flow_llin8_sor": (sor_cuda.flow_llin8_sor, plain_sor.sor_flow_llin8,
                               llin8_fields(rng, h, w, True, dev), 1.9, (17 + 2) * 4 * px, px),
            # tv_denoise8's call: C = 3 channels, shared weights
            "pde8_sor": (interior_cuda.pde8_sor, plain_sor.sor_pde8,
                         pde8_fields(rng, 3, h, w, True, dev), 1.75, (4 * 3 + 8) * 4 * px,
                         3 * (h - 2) * (w - 2)),
            # the resident kernel at flow_ad's and tv_denoise8's calls
            "resident_flow_llin8": (resident_cuda.flow_llin8_sor, plain_sor.sor_flow_llin8,
                                    llin8_fields(rng, h, w, True, dev), 1.9, (17 + 2) * 4 * px,
                                    px),
            "resident_pde8": (resident_cuda.pde8_sor, plain_sor.sor_pde8,
                              pde8_fields(rng, 3, h, w, True, dev), 1.75, (4 * 3 + 8) * 4 * px,
                              3 * (h - 2) * (w - 2)),
        }
        for name, (kern, plain, fields, omega, nbytes, relaxed) in cases.items():
            if (h, w) not in TIME_SHAPES and name not in AT_MAIN:
                continue
            family, batch = {"resident_flow_llin4": ("llin4", 1), "resident_disp_llin4": ("disp", 1),
                             "resident_flow_elin4": ("elin4", 1), "resident_pde4": ("pde4", 3),
                             "resident_flow_llin8": ("llin8", 1),
                             "resident_pde8": ("pde8", 3)}.get(name, (None, 1))
            if family and resident_cuda.plan_resident(h, w, family, batch, sms) is None:
                print(f"  time {name} {h}x{w}: no plan (the global kernel takes it)", flush=True)
                continue
            k_ms, p_ms, turns = in_turns(partial(kern, *fields, 4, omega),
                                         partial(plain, *fields, 4, omega))
            b_ms, b_by = bound(nbytes, 4 * relaxed * FLOPS_PER_PX[name])
            dev_ms, dev_ops, _, _ = device_profile(partial(kern, *fields, 4, omega), 20)
            times[(name, h, w)] = (k_ms, p_ms)
            bounds[(name, h, w)] = (b_ms, b_by)
            print(f"  time {name} {h}x{w} iters=4 per call: kernel {turns[1]:.4f} / "
                  f"{turns[2]:.4f} ms (device busy {dev_ms:.4f} ms in {dev_ops:.0f} "
                  f"operations), plain {turns[0]:.4f} / {turns[3]:.4f} ms, "
                  f"bound {b_ms:.4f} ms ({b_by})", flush=True)

    # the tile kernels, iters = 4; their plain version is the tile schedule
    # at the kernel's own plan, timed once before and once after at the
    # reported shape, once elsewhere (its thousand-odd tiles' torch ops take
    # ~10 s a call at 1024x1024)
    for h, w in TIME_SHAPES:
        px = h * w
        for family, make in (("flow_llin4", sor_fields), ("flow_elin4", elin_fields)):
            tf = tile_order(family, make(rng, h, w, True, dev))
            plain = partial(tiled_run, f"tiled_{family}", tf, 4, 4, plain=True)
            p1 = timed(plain)[1] * 1e3
            kern_ms = {}
            for name in (f"tiled_{family}", f"tiled_{family}_db"):
                kern = partial(tiled_run, name, tf, 4, 4)
                kern_ms[name] = (cuda_ms(kern, 50), cuda_ms(kern, 50),
                                 device_profile(kern, 20)[:2])
            p2 = timed(plain)[1] * 1e3 if (h, w) == TIME_SHAPES[0] else p1
            for name, (k1, k2, (dev_ms, dev_ops)) in kern_ms.items():
                b_ms, b_by = bound(len(tf) * 4 * px + 2 * 4 * px, 4 * px * FLOPS_PER_PX[name])
                times[(name, h, w)] = ((k1 + k2) / 2, (p1 + p2) / 2)
                bounds[(name, h, w)] = (b_ms, b_by)
                print(f"  time {name} {h}x{w} iters=4 per call: kernel {k1:.4f} / {k2:.4f} ms "
                      f"(device busy {dev_ms:.4f} ms in {dev_ops:.0f} operations), plain tile "
                      f"schedule {p1:.1f} / {p2:.1f} ms, bound {b_ms:.4f} ms ({b_by})",
                      flush=True)

    # the windowed variant, one chunk of 4 sweeps over the top-left shard of a
    # MESH_SHAPE mesh over MAIN_SHAPE's plane (the shard and its 8-px halo);
    # its plain version is the windowed schedule at the kernel's plan on the
    # card, timed once before and once after
    sh_h, sh_w = MAIN_SHAPE[1] // MESH_SHAPE[0], MAIN_SHAPE[2] // MESH_SHAPE[1]
    win = tiled.Window(0, 0, *MAIN_SHAPE[1:], (0, sh_h, 0, sh_w))
    for family, make in (("flow_llin4", sor_fields), ("flow_elin4", elin_fields)):
        tf = [x[:sh_h + 8, :sh_w + 8].contiguous()
              for x in tile_order(family, make(rng, *MAIN_SHAPE[1:], True, dev))]
        prep, sw = getattr(sweeps, f"{family}_sweep")(1.9)

        def win_plain():
            with dispatch.plain_solvers():
                return tiled.tiled_relax(tf, sw, 2, 4, prepare_fn=prep, window=win)

        p1 = timed(win_plain)[1] * 1e3
        kern_ms = {}
        for name in (f"tiled_{family}_win", f"tiled_{family}_win_db"):
            kern = partial(tiled.tiled_relax, tf, sw, 2, 4, prepare_fn=prep, window=win,
                           double_buffer=TILED_WIN[name][1])
            kern_ms[name] = (cuda_ms(kern, 50), cuda_ms(kern, 50), device_profile(kern, 20)[:2])
        p2 = timed(win_plain)[1] * 1e3
        for name, (k1, k2, (dev_ms, dev_ops)) in kern_ms.items():
            b_ms, b_by = bound(len(tf) * 4 * tf[0].numel() + 2 * 4 * sh_h * sh_w,
                               4 * sh_h * sh_w * FLOPS_PER_PX[name])
            times[(name, "win")] = ((k1 + k2) / 2, (p1 + p2) / 2)
            bounds[(name, "win")] = (b_ms, b_by)
            print(f"  time {name}, a {sh_h}x{sh_w} shard of {MAIN_SHAPE[1]}x"
                  f"{MAIN_SHAPE[2]} and its halo, iters=4 per call: kernel {k1:.4f} / {k2:.4f} ms "
                  f"(device busy {dev_ms:.4f} ms in {dev_ops:.0f} operations), plain windowed "
                  f"schedule {p1:.1f} / {p2:.1f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)

    # the tile kernel's other families, iters = 4, at their models' calls
    # (flow_ad's llin8, disparity_nd's disp of B = 1, tv_denoise4's and
    # tv_denoise8's C = 3 over shared weights), beside the global kernel that
    # served these shapes before; the plain version is the tile schedule over
    # one tile the image's size (the same function, exact whatever its
    # tiles), timed once before and once after
    new_batch = {"flow_llin8": 1, "disp_llin4": 1, "pde4": 3, "pde8": 3}
    for h, w in TIME_SHAPES:
        px = h * w
        for name, (family, glob_key) in TILED_NEW.items():
            glob, _, omega = new_global[family]
            batch = new_batch[family]
            fields = new_fields(family, batch, h, w, True)
            tf = tile_order(family, fields)
            plain = partial(new_tiled, family, tf, 4, omega, plain=True)
            kern = partial(new_tiled, family, tf, 4, omega)
            # the double-buffered form at 1024x1024, in turns with the serial
            db_kern = partial(new_tiled, family, tf, 4, omega, double_buffer=True)
            with_db = (h, w) == TIME_SHAPES[-1]
            p1 = timed(plain)[1] * 1e3
            if with_db:
                k1, d1, d2, k2 = (cuda_ms(f, 50) for f in (kern, db_kern, db_kern, kern))
            else:
                k1, k2 = cuda_ms(kern, 50), cuda_ms(kern, 50)
            dev_ms, dev_ops = device_profile(kern, 20)[:2]
            g_ms = cuda_ms(partial(glob, *fields, 4, omega), 50)
            p2 = timed(plain)[1] * 1e3
            nbytes = sum(x.numel() for x in fields) * 4 + tiled.LAYOUTS[family].n_mut * 4 * px * batch
            relaxed = batch * (px if family == "flow_llin8" else (h - 2) * (w - 2))
            b_ms, b_by = bound(nbytes, 4 * relaxed * FLOPS_PER_PX[name])
            times[(name, h, w)] = ((k1 + k2) / 2, (p1 + p2) / 2)
            bounds[(name, h, w)] = (b_ms, b_by)
            print(f"  time {name} {'C' if batch > 1 else 'B'}={batch} {h}x{w} iters=4 per call: "
                  f"kernel {k1:.4f} / {k2:.4f} ms (device busy {dev_ms:.4f} ms in {dev_ops:.0f} "
                  f"operations), {glob_key} {g_ms:.4f} ms, plain tile schedule {p1:.1f} / "
                  f"{p2:.1f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
            if with_db:
                db_ms, db_ops = device_profile(db_kern, 20)[:2]
                times[(f"{name}_db", h, w)] = ((d1 + d2) / 2, (p1 + p2) / 2)
                bounds[(f"{name}_db", h, w)] = (b_ms, b_by)
                print(f"  time {name}_db {h}x{w} iters=4 per call: kernel {d1:.4f} / {d2:.4f} ms "
                      f"(device busy {db_ms:.4f} ms in {db_ops:.0f} operations) between the "
                      f"serial's {k1:.4f} / {k2:.4f} ms, {(d1 + d2) / (k1 + k2):.3f}x", flush=True)
    # and their windowed variant over the same shard as llin4's and elin4's,
    # with the family's halo (2k + 1 for disp and pde4)
    for name, family in TILED_WIN_NEW.items():
        _, _, omega = new_global[family]
        halo = tiled._halo_for(family, 4)
        tf = [x[:sh_h + halo, :sh_w + halo].contiguous()
              for x in tile_order(family, new_fields(family, 1, *MAIN_SHAPE[1:], True))]
        prep, sw = getattr(sweeps, f"{family}_sweep")(omega)
        n_mut = tiled.LAYOUTS[family].n_mut

        def win_plain():
            with dispatch.plain_solvers():
                return tiled.tiled_relax(tf, sw, n_mut, 4, prepare_fn=prep, window=win,
                                         plan_override=(4, (sh_h, sh_w)))

        kern = partial(tiled.tiled_relax, tf, sw, n_mut, 4, prepare_fn=prep, window=win)
        db_kern = partial(kern, double_buffer=True)
        p1 = timed(win_plain)[1] * 1e3
        k1, d1, d2, k2 = (cuda_ms(f, 50) for f in (kern, db_kern, db_kern, kern))
        dev_ms, dev_ops = device_profile(kern, 20)[:2]
        db_ms, db_ops = device_profile(db_kern, 20)[:2]
        p2 = timed(win_plain)[1] * 1e3
        relaxed = sh_h * sh_w
        b_ms, b_by = bound(len(tf) * 4 * tf[0].numel() + n_mut * 4 * relaxed,
                           4 * relaxed * FLOPS_PER_PX[name])
        times[(name, "win")] = ((k1 + k2) / 2, (p1 + p2) / 2)
        bounds[(name, "win")] = (b_ms, b_by)
        times[(f"{name}_db", "win")] = ((d1 + d2) / 2, (p1 + p2) / 2)
        bounds[(f"{name}_db", "win")] = (b_ms, b_by)
        print(f"  time {name}, a {sh_h}x{sh_w} shard of {MAIN_SHAPE[1]}x{MAIN_SHAPE[2]} and its "
              f"halo, iters=4 per call: kernel {k1:.4f} / {k2:.4f} ms (device busy {dev_ms:.4f} "
              f"ms in {dev_ops:.0f} operations), plain windowed schedule {p1:.1f} / {p2:.1f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}); double-buffered {d1:.4f} / {d2:.4f} ms (device "
              f"busy {db_ms:.4f} ms in {db_ops:.0f} operations), {(d1 + d2) / (k1 + k2):.3f}x",
              flush=True)

    # one whole tridiagonal solve (diffusion4's call) along each axis, one
    # zebra parity solve with a factor, and one fused zebra pass (flow_hs's
    # coupled call, and the scalar one); each beside its byte bound and the
    # chain's floor (a line's 5 L dependent rounded operations)
    clock_hz = sm_clock_mhz() * 1e6
    for h, w in TIME_SHAPES:
        a, b, c, d = tridiag_fields(rng, (h, w), dev)
        z, rhs, z_o, m, w_lo, w_hi, *_ = zebra_fields(rng, (h, w), dev)
        b_ms, b_by = bound((4 + 1) * 4 * h * w, TRIDIAG_FLOPS_PER_PX * h * w)
        for axis in (-2, -1):
            vertical = axis == -2
            length = h if vertical else w
            floor_ms = length * CHAIN_OPS_PER_ELEMENT * CYCLES_PER_OP / clock_hz * 1e3
            fac = tdma_cuda.tridiag_factor(a, b, c, axis)
            pfacs = plain_tdma.line_factors(a, b, c, vertical)
            zk = z.clone()
            cases = {
                "whole": (partial(tdma_cuda.thomas_solve, a, b, c, d, axis),
                          partial(plain_tdma.thomas_solve, a, b, c, d, axis), b_ms),
                "parity 0": (partial(tdma_cuda.tridiag_solve, fac, d, 0),
                             partial(plain_tdma.line_solve, pfacs, d, 0, vertical),
                             # half the lines: a, denom, cp and d of them read, x written
                             bound((4 + 1) * 4 * h * w / 2, 0)[0]),
                # the kernel writes into its own buffer zk, the plain version
                # returns a new field; the timing does not depend on z's values
                "zebra pass coupled": (
                    partial(tdma_cuda.zebra_pass, fac, zk, rhs, w_lo, w_hi, 0, z_o, m),
                    partial(plain_tdma.zebra_pass, pfacs, z, rhs, w_lo, w_hi, 0, vertical, z_o,
                            m),
                    bound(ROW_BYTES_PER_PX["8z fused zebra pass, coupled (flow_hs)"] * h * w,
                          0)[0]),
                "zebra pass scalar": (
                    partial(tdma_cuda.zebra_pass, fac, zk, rhs, w_lo, w_hi, 0),
                    partial(plain_tdma.zebra_pass, pfacs, z, rhs, w_lo, w_hi, 0, vertical),
                    bound((6 + 1 + 1) * 4 * h * w / 2, 0)[0]),
            }
            for what, (kern, plain, case_bound) in cases.items():
                k_ms, p_ms, turns = in_turns(kern, plain, reps=20, plain_reps=2)
                dev_ms, dev_ops, _, _ = device_profile(kern, 10)
                if what == "whole":
                    times[("tridiag", axis, h, w)] = (k_ms, p_ms)
                    bounds[("tridiag", axis, h, w)] = (b_ms, b_by)
                if what == "zebra pass coupled":
                    times[("tridiag_zebra_pass", axis, h, w)] = (k_ms, p_ms)
                    bounds[("tridiag_zebra_pass", axis, h, w)] = (case_bound, "bytes")
                print(f"  time tridiag {what} axis={axis} {h}x{w} per call: kernel "
                      f"{turns[1]:.4f} / {turns[2]:.4f} ms (device busy {dev_ms:.4f} ms in "
                      f"{dev_ops:.0f} operations), plain {turns[0]:.4f} / {turns[3]:.4f} ms, "
                      f"bound {case_bound:.4f} ms, chain floor {floor_ms:.4f} ms "
                      f"(L = {length}, {CHAIN_OPS_PER_ELEMENT} x {CYCLES_PER_OP} cycles at "
                      f"{clock_hz / 1e6:.0f} MHz)", flush=True)

    # the global-rows variant at every long-line shape: whole solve, parity
    # solve and the coupled fused pass, each beside its byte bound and the
    # chain's floor; the plain version (on the card) timed at LONG_TIME only,
    # once before and once after
    for (h, w), axis in LONG_LINES:
        vertical = axis == -2
        length = h if vertical else w
        a, b, c, d = tridiag_fields(rng11, (h, w), dev)
        z, rhs, z_o, m, w_lo, w_hi, *_ = zebra_fields(rng11, (h, w), dev)
        fac = tdma_cuda.tridiag_factor(a, b, c, axis)
        floor_ms = length * CHAIN_OPS_PER_ELEMENT * CYCLES_PER_OP / clock_hz * 1e3
        b_ms, b_by = bound((4 + 1) * 4 * h * w, TRIDIAG_FLOPS_PER_PX * h * w)
        for what, kern, case_bound in (
                ("whole", partial(tdma_cuda.thomas_solve, a, b, c, d, axis), b_ms),
                ("parity 0", partial(tdma_cuda.tridiag_solve, fac, d, 0),
                 bound((4 + 1) * 4 * h * w / 2, 0)[0]),
                ("zebra pass coupled", partial(tdma_cuda.zebra_pass, fac, z.clone(), rhs, w_lo,
                                               w_hi, 0, z_o, m),
                 bound(ROW_BYTES_PER_PX["8z fused zebra pass, coupled (flow_hs)"] * h * w,
                       0)[0])):
            k1, k2 = cuda_ms(kern, 5), cuda_ms(kern, 5)
            dev_ms, dev_ops, _, _ = device_profile(kern, 3)
            plain_txt = ""
            if ((h, w), axis) == LONG_TIME and what == "whole":
                plain = partial(plain_tdma.thomas_solve, a, b, c, d, axis)
                p1 = timed(plain)[1] * 1e3
                p2 = timed(plain)[1] * 1e3
                times[("tridiag_long", axis, h, w)] = ((k1 + k2) / 2, (p1 + p2) / 2)
                bounds[("tridiag_long", axis, h, w)] = (b_ms, b_by)
                plain_txt = f", plain {p1:.1f} / {p2:.1f} ms"
            print(f"  time tridiag_long {what} axis={axis} {h}x{w} per call: kernel {k1:.4f} / "
                  f"{k2:.4f} ms (device busy {dev_ms:.4f} ms in {dev_ops:.0f} operations)"
                  f"{plain_txt}, bound {case_bound:.4f} ms, chain floor {floor_ms:.4f} ms "
                  f"(L = {length})", flush=True)

    for label, bpp in ROW_BYTES_PER_PX.items():
        print(f"  bound of row {label}: " + ", ".join(
            f"{h}x{w} {bound(bpp * h * w, 0)[0]:.4f} ms" for h, w in TIME_SHAPES), flush=True)

    main_launches = {}

    def sor_launches(shape, scl_factor, stop, scales, calls, family, batch, global_key,
                     per_call, iters=None):
        """The launches of ``calls`` solver calls at every pyramid level of
        ``shape`` (``planned_launches``)."""
        levels = pyramid_scales(shape[-2], shape[-1], scl_factor, stop, scales)
        return planned_launches(levels, calls, family, batch, global_key, per_call, iters)

    def model_reweights(shape, prm, stop, robust, weights=1):
        """``reweight_launches`` of a warping model's frame of ``shape``:
        firstLoop x secondLoop reweightings at each pyramid level."""
        n = len(pyramid_scales(shape[-2], shape[-1], prm.scl_factor, stop, prm.scales))
        return reweight_launches(n, prm.firstLoop * prm.secondLoop, robust, weights)

    def planned_launches(levels, calls, family, batch, global_key, per_call, iters=None):
        """The launches of ``calls`` solver calls at each of ``levels``,
        counted apart from the dispatch's own routing: one resident launch a
        call where ``plan_resident`` gives the level a plan; else, where the
        tile kernel takes the batch (llin4, elin4 and llin8 one system, disp
        two, pde4 and pde8 three channels) and, for the families that fill
        the border, the level is 3 px or more each way, ``ceil(iters / 4)``
        launches of the tile kernel a call (chunks of ``pde_tpu``'s
        k_max = 4 sweeps); else ``per_call`` launches of the global
        kernel."""
        resident_key = {"llin4": "resident_flow_llin4", "disp": "resident_disp_llin4",
                        "pde4": "resident_pde4", "elin4": "resident_flow_elin4",
                        "llin8": "resident_flow_llin8", "pde8": "resident_pde8"}[family]
        tile_key = {"llin4": "tiled_flow_llin4", "elin4": "tiled_flow_elin4",
                    "llin8": "tiled_flow_llin8", "disp": "tiled_disp_llin4",
                    "pde4": "tiled_pde4", "pde8": "tiled_pde8"}[family]
        max_batch, fill = {"llin4": (1, 0), "elin4": (1, 0), "llin8": (1, 0), "disp": (2, 1),
                           "pde4": (3, 1), "pde8": (3, 1)}[family]
        want = {resident_key: 0, global_key: 0, tile_key: 0}
        for h, w in levels:
            if resident_cuda.plan_resident(h, w, family, batch, sms) is not None:
                want[resident_key] += calls
            elif batch <= max_batch and (not fill or min(h, w) >= 3):
                if iters is None:
                    fail(f"the {family} launches at {h}x{w} need the sweeps a call")
                want[tile_key] += calls * -(-iters // 4)
            else:
                want[global_key] += calls * per_call
        return want

    phase(f"4 main path: flow_nd {MAIN_SHAPE}, default parameters")
    p = FlowNDParams()
    it0, it1 = (torch.from_numpy(f).to(dev)
                for f in shifted_frames(rng, MAIN_SHAPE, [(0.0, 0.0), MAIN_SHIFT]))
    n_levels = len(pyramid_scales(MAIN_SHAPE[1], MAIN_SHAPE[2], p.scl_factor, 20, p.scales))
    nd_reweights = model_reweights(MAIN_SHAPE, p, 20, "robust_flow")
    expected = {**sor_launches(MAIN_SHAPE, p.scl_factor, 20, p.scales,
                               p.firstLoop * p.secondLoop, "llin4", 1, "flow_llin4_sor",
                               1 + 2 * p.iter, p.iter), **nd_reweights}
    frame_s = []
    for _ in range(3):
        reset_counts()
        (u, v), sec = timed(lambda: flow_nd(it0, it1, "grad", "gradmag"))
        frame_s.append(sec)
        check_counts("flow_nd", expected)
    main_launches.update(expected)
    # phase 20 holds the mesh's frame against this one
    nd_frames, nd_main, nd_warm_s = (it0, it1), (u, v), frame_s[1:]
    print(f"  {n_levels} levels; frame time: cold {frame_s[0]:.3f} s, "
          f"warm {frame_s[1]:.3f} / {frame_s[2]:.3f} s", flush=True)
    nd_prof = device_profile(lambda: flow_nd(it0, it1, "grad", "gradmag"))
    print_profile("flow_nd", min(frame_s[1:]), nd_prof)
    if u.shape != MAIN_SHAPE[1:] or v.shape != MAIN_SHAPE[1:] or u.device != dev:
        fail(f"flow of shape {tuple(u.shape)} on {u.device}")
    if not (torch.isfinite(u).all() and torch.isfinite(v).all()):
        fail("non-finite flow on the main path")
    inner = (slice(16, -16), slice(16, -16))
    mu, mv = float(u[inner].median()), float(v[inner].median())
    print(f"  median interior flow U={mu:.4f} V={mv:.4f} (shift {MAIN_SHIFT[1]}, "
          f"{MAIN_SHIFT[0]})", flush=True)
    if abs(mu - MAIN_SHIFT[1]) > SHIFT_TOL or abs(mv - MAIN_SHIFT[0]) > SHIFT_TOL:
        fail(f"flow ({mu}, {mv}) misses the shift {MAIN_SHIFT[::-1]} by more than {SHIFT_TOL} px")
    reset_counts()
    with dispatch.plain_solvers():
        (up, vp), plain_frame_s = timed(lambda: flow_nd(it0, it1, "grad", "gradmag"))
    check_counts("the plain path", {})
    d_plain = mean_flow_diff((u, v), (up, vp))
    print(f"  plain path on the card: frame {plain_frame_s:.3f} s, "
          f"mean |dflow| vs kernel path {d_plain:.3g} px", flush=True)
    if not d_plain <= FLOW_TOL:
        fail(f"kernel path and plain path differ by {d_plain} px > {FLOW_TOL}")
    small0, small1 = shifted_frames(rng, SMALL_SHAPE, [(0.0, 0.0), MAIN_SHIFT])
    ug, vg = flow_nd(torch.from_numpy(small0).to(dev), torch.from_numpy(small1).to(dev))
    uc, vc = flow_nd(small0, small1, device="cpu")
    d_cpu = mean_flow_diff((ug.cpu(), vg.cpu()), (uc, vc))
    print(f"  {SMALL_SHAPE} card vs CPU path: mean |dflow| {d_cpu:.3g} px", flush=True)
    if not d_cpu <= FLOW_TOL:
        fail(f"card and CPU paths differ by {d_cpu} px > {FLOW_TOL}")

    phase(f"5 flow_nd_sequence, 3 frames of {SEQ_SHAPE}")
    clip = torch.from_numpy(np.stack(shifted_frames(
        rng, SEQ_SHAPE, [(0.0, 0.0), MAIN_SHIFT, (2 * MAIN_SHIFT[0], 2 * MAIN_SHIFT[1])]))).to(dev)
    reset_counts()
    us, vs = flow_nd_sequence(clip, "grad", "gradmag")
    torch.cuda.synchronize()
    # every pair is a flow_nd_fused call: the first captures one pair's
    # frame (models/_graph.py runs it twice, the warm-up and the capture),
    # the others replay it and count nothing. So the clip counts twice one
    # pair's launches, whatever its length
    pair_calls = p.firstLoop * p.secondLoop
    check_counts("flow_nd_sequence (one capture)", {**sor_launches(
        SEQ_SHAPE, p.scl_factor, 20, p.scales, 2 * pair_calls, "llin4", 1,
        "flow_llin4_sor", 1 + 2 * p.iter, p.iter), **{
            k: 2 * n for k, n in model_reweights(SEQ_SHAPE, p, 20, "robust_flow").items()}})
    if us.shape != (2,) + SEQ_SHAPE[1:]:
        fail(f"sequence flow of shape {tuple(us.shape)}")
    seq_err = 0.0
    for t in range(2):
        u_t, v_t = flow_nd(clip[t], clip[t + 1], "grad", "gradmag")
        seq_err = max(seq_err, float((us[t] - u_t).abs().max()), float((vs[t] - v_t).abs().max()))
    print(f"  max |dflow| vs per-pair flow_nd {seq_err:.3g} px", flush=True)
    if not seq_err <= FLOW_TOL:
        fail(f"flow_nd_sequence differs from per-pair flow_nd by {seq_err} px")
    release_graphs()

    phase(f"6 disparity_nd {MAIN_SHAPE}, default parameters")
    dp = DisparityParams()
    il, ir = (torch.from_numpy(f).to(dev)
              for f in shifted_frames(rng, MAIN_SHAPE, [(0.0, 0.0), DISP_SHIFT]))
    d_levels = len(pyramid_scales(MAIN_SHAPE[1], MAIN_SHAPE[2], dp.scl_factor, 10, dp.scales))
    d_reweights = model_reweights(MAIN_SHAPE, dp, 10, "robust_disp")
    d_expected = {**sor_launches(MAIN_SHAPE, dp.scl_factor, 10, dp.scales,
                                 dp.firstLoop * dp.secondLoop, "disp", 1, "disp_llin4_sor",
                                 3 * dp.iter, dp.iter), **d_reweights}
    frame_s = []
    for _ in range(3):
        reset_counts()
        ud, sec = timed(lambda: disparity_nd(il, ir, "grad", "gradmag"))
        frame_s.append(sec)
        check_counts("disparity_nd", d_expected)
    main_launches.update(d_expected)
    print(f"  {d_levels} levels x {dp.firstLoop} x {dp.secondLoop} calls, one launch each; "
          f"frame time: cold {frame_s[0]:.3f} s, warm {frame_s[1]:.3f} / {frame_s[2]:.3f} s",
          flush=True)
    print_profile("disparity_nd", min(frame_s[1:]),
                  device_profile(lambda: disparity_nd(il, ir, "grad", "gradmag")))
    if ud.shape != MAIN_SHAPE[1:] or ud.device != dev or not torch.isfinite(ud).all():
        fail(f"disparity of shape {tuple(ud.shape)} on {ud.device}, or not finite")
    md = float(ud[inner].median())
    print(f"  median interior disparity {md:.4f} (shift {DISP_SHIFT[1]})", flush=True)
    if abs(md - DISP_SHIFT[1]) > DISP_SHIFT_TOL:
        fail(f"disparity {md} misses the shift {DISP_SHIFT[1]} by more than {DISP_SHIFT_TOL} px")
    reset_counts()
    with dispatch.plain_solvers():
        udp, plain_frame_s = timed(lambda: disparity_nd(il, ir, "grad", "gradmag"))
    check_counts("the plain path", {})
    d_plain = float((ud - udp).abs().mean())
    print(f"  plain path on the card: frame {plain_frame_s:.3f} s, "
          f"mean |dU| vs kernel path {d_plain:.3g} px", flush=True)
    if not d_plain <= FLOW_TOL:
        fail(f"disparity kernel path and plain path differ by {d_plain} px > {FLOW_TOL}")
    small0, small1 = shifted_frames(rng, SMALL_SHAPE, [(0.0, 0.0), DISP_SHIFT])
    ug = disparity_nd(torch.from_numpy(small0).to(dev), torch.from_numpy(small1).to(dev))
    uc = disparity_nd(small0, small1, device="cpu")
    d_cpu = float((ug.cpu() - uc).abs().mean())
    print(f"  {SMALL_SHAPE} card vs CPU path: mean |dU| {d_cpu:.3g} px", flush=True)
    if not d_cpu <= FLOW_TOL:
        fail(f"disparity card and CPU paths differ by {d_cpu} px > {FLOW_TOL}")

    phase(f"7 disparity_sym {MAIN_SHAPE}, default parameters")
    sp = DisparitySymParams()
    s_levels = len(pyramid_scales(MAIN_SHAPE[1], MAIN_SHAPE[2], sp.scl_factor, 10, sp.scales))
    # one call with B = 2 per solve of the pair: two calls would count twice
    # and two weights4 launches a reweighting (the pair forms its own terms)
    s_expected = {**sor_launches(MAIN_SHAPE, sp.scl_factor, 10, sp.scales,
                                 sp.firstLoop * sp.secondLoop, "disp", 2, "disp_llin4_sor",
                                 3 * sp.iter, sp.iter),
                  **model_reweights(MAIN_SHAPE, sp, 10, None, 2)}
    frame_s = []
    for _ in range(2):
        reset_counts()
        us_, sec = timed(lambda: disparity_sym(il, ir))
        frame_s.append(sec)
        check_counts("disparity_sym", s_expected)
    # the pair's planes go to the resident kernel as two sets: no stack
    pair = disp_fields(rng, 1, *MAIN_SHAPE[1:], True, dev) + disp_fields(
        rng, 1, *MAIN_SHAPE[1:], True, dev)
    torch_stack, stacks = torch.stack, []
    torch.stack = lambda *a, **k: stacks.append(1) or torch_stack(*a, **k)
    try:
        dispatch.sor_disp_llin_sym4(*pair, sp.iter, sp.omega)
    finally:
        torch.stack = torch_stack
    torch.cuda.synchronize()
    print(f"  the pair's solve at {MAIN_SHAPE[1:]}: {len(stacks)} torch.stack calls", flush=True)
    if stacks:
        fail("sor_disp_llin_sym4 stacked the pair's planes")
    if us_.shape != (2,) + MAIN_SHAPE[1:] or not torch.isfinite(us_).all():
        fail(f"symmetric disparity of shape {tuple(us_.shape)}, or not finite")
    m0, m1 = float(us_[0][inner].median()), float(us_[1][inner].median())
    print(f"  {s_levels} levels; frame time: cold {frame_s[0]:.3f} s, warm {frame_s[1]:.3f} s; "
          f"median interior U0 {m0:.4f}, U1 {m1:.4f} (shift +-{DISP_SHIFT[1]})", flush=True)
    print_profile("disparity_sym", frame_s[1], device_profile(lambda: disparity_sym(il, ir)))
    if abs(m0 - DISP_SHIFT[1]) > DISP_SHIFT_TOL or abs(m1 + DISP_SHIFT[1]) > DISP_SHIFT_TOL:
        fail(f"symmetric disparity ({m0}, {m1}) misses +-{DISP_SHIFT[1]} by more than "
             f"{DISP_SHIFT_TOL} px")
    reset_counts()
    with dispatch.plain_solvers():
        usp, plain_frame_s = timed(lambda: disparity_sym(il, ir))
    check_counts("the plain path", {})
    d_plain = float((us_ - usp).abs().mean())
    print(f"  plain path on the card: frame {plain_frame_s:.3f} s, "
          f"mean |dU| vs kernel path {d_plain:.3g} px", flush=True)
    if not d_plain <= FLOW_TOL:
        fail(f"disparity_sym kernel path and plain path differ by {d_plain} px > {FLOW_TOL}")

    phase(f"8 tv_denoise4 {MAIN_SHAPE}, default parameters")
    tp = TVDenoise4Params()
    noisy = torch.from_numpy(noisy_blocks(rng, MAIN_SHAPE)).to(dev)
    tv_levels = len(tv4_levels_hw)
    # C = 3 channels over shared weights: one resident launch a call
    tv_expected = {**planned_launches(tv4_levels_hw, tp.outer_iter + 1, "pde4", MAIN_SHAPE[0],
                                      "pde4_sor", 3 * tp.inner_iter, tp.inner_iter),
                   **reweight_launches(tv_levels, tp.outer_iter + 1, None)}
    frame_s = []
    for _ in range(2):
        reset_counts()
        den, sec = timed(lambda: tv_denoise4(noisy))
        frame_s.append(sec)
        check_counts("tv_denoise4", tv_expected)
    main_launches.update(tv_expected)
    print(f"  {tv_levels} levels x {tp.outer_iter + 1} calls, one resident launch each; "
          f"image time: cold {frame_s[0]:.3f} s, warm {frame_s[1]:.3f} s", flush=True)
    print_profile("tv_denoise4", frame_s[1], device_profile(lambda: tv_denoise4(noisy)))
    if den.shape != MAIN_SHAPE or not torch.isfinite(den).all():
        fail(f"denoised image of shape {tuple(den.shape)}, or not finite")
    reset_counts()
    with dispatch.plain_solvers():
        denp, plain_s = timed(lambda: tv_denoise4(noisy))
    check_counts("the plain path", {})
    scale = float(noisy.max() - noisy.min())
    d_rel = float((den - denp).abs().max()) / scale
    # a patch of the flat background; noise std per channel, averaged
    flat = (slice(None), slice(3 * MAIN_SHAPE[1] // 4 + 8, -8), slice(8, MAIN_SHAPE[2] // 2))
    sd_in_tv = float(noisy[flat].std(dim=(1, 2)).mean())
    sd_out = float(den[flat].std(dim=(1, 2)).mean())
    print(f"  plain path on the card: {plain_s:.3f} s, max |du| / range vs kernel path "
          f"{d_rel:.3g}; flat-patch noise std {sd_in_tv:.4f} -> {sd_out:.4f}", flush=True)
    if not d_rel <= TV_REL_TOL:
        fail(f"tv_denoise4 kernel path and plain path differ by {d_rel} > {TV_REL_TOL} "
             f"of the range")
    if not sd_out < 0.5 * sd_in_tv:
        fail(f"flat-patch noise {sd_out} is not under half of the input's {sd_in_tv}")

    def pcg_launches(calls: int, fields: int, iters: int) -> dict:
        """Line-solve launches of ``calls`` PCG solves of ``fields`` coupled
        fields: per call one factor per field and direction, and per
        preconditioner pass (``iters + 1``) 8 fused zebra passes per field;
        no separate parity solve."""
        return {"tridiag_factor": calls * 2 * fields,
                "tridiag_zebra_pass": calls * (iters + 1) * 8 * fields}

    def kernel_vs_plain(what, run, diff, tol):
        """``run()`` on the kernel path and on the plain path at
        PLAIN_SHAPE; fails if ``diff`` of the two exceeds ``tol``."""
        got = run()
        reset_counts()
        with dispatch.plain_solvers():
            want, plain_s = timed(run)
        check_counts(f"{what}'s plain path", {})
        err = diff(got, want)
        print(f"  {what} at {PLAIN_SHAPE}: kernel path vs plain path {err:.3g} "
              f"(plain path {plain_s:.3f} s on the card)", flush=True)
        if not err <= tol:
            fail(f"{what}: kernel path and plain path differ by {err} > {tol}")

    small0, small1 = (torch.from_numpy(f).to(dev)
                      for f in shifted_frames(rng, PLAIN_SHAPE, [(0.0, 0.0), MAIN_SHIFT]))

    phase(f"9 flow_hs {MAIN_SHAPE}, default parameters (solver=2, PCG)")
    hp = FlowHSParams()
    hs_levels = len(pyramid_scales(MAIN_SHAPE[1], MAIN_SHAPE[2], hp.scl_factor, 20, hp.scales))
    hs_expected = pcg_launches(hs_levels, 2, hp.iter)
    frame_s = []
    for _ in range(3):
        reset_counts()
        (uh, vh), sec = timed(lambda: flow_hs(it0, it1))
        frame_s.append(sec)
        check_counts("flow_hs", hs_expected)
    main_launches["tridiag"] = hs_expected["tridiag_factor"]
    main_launches["tridiag_zebra_pass"] = hs_expected["tridiag_zebra_pass"]
    print(f"  {hs_levels} levels x (4 factors + {hp.iter + 1} preconditioner passes x 16 "
          f"fused zebra passes); frame time: cold {frame_s[0]:.3f} s, warm {frame_s[1]:.3f} / "
          f"{frame_s[2]:.3f} s", flush=True)
    print_profile("flow_hs", min(frame_s[1:]), device_profile(lambda: flow_hs(it0, it1)))
    if uh.shape != MAIN_SHAPE[1:] or not (torch.isfinite(uh).all() and torch.isfinite(vh).all()):
        fail(f"flow_hs flow of shape {tuple(uh.shape)}, or not finite")
    print(f"  median interior flow U={float(uh[inner].median()):.4f} "
          f"V={float(vh[inner].median()):.4f} (shift {MAIN_SHIFT[1]}, {MAIN_SHIFT[0]})",
          flush=True)
    kernel_vs_plain("flow_hs", lambda: flow_hs(small0, small1), mean_flow_diff, FLOW_TOL)
    s0, s1 = shifted_frames(rng, SMALL_SHAPE, [(0.0, 0.0), MAIN_SHIFT])
    ug, vg = flow_hs(torch.from_numpy(s0).to(dev), torch.from_numpy(s1).to(dev))
    d_cpu = mean_flow_diff((ug.cpu(), vg.cpu()), flow_hs(s0, s1, device="cpu"))
    print(f"  {SMALL_SHAPE} card vs CPU path: mean |dflow| {d_cpu:.3g} px", flush=True)
    if not d_cpu <= FLOW_TOL:
        fail(f"flow_hs card and CPU paths differ by {d_cpu} px > {FLOW_TOL}")

    phase(f"10 flow_hs {MAIN_SHAPE}, solver=1 (elin4 SOR)")
    # one resident launch a level
    elin_expected = sor_launches(MAIN_SHAPE, hp.scl_factor, 20, hp.scales, 1, "elin4", 1,
                                 "flow_elin4_sor", 1 + 2 * hp.iter, hp.iter)
    frame_s = []
    for _ in range(3):
        reset_counts()
        (u1, v1), sec = timed(lambda: flow_hs(it0, it1, solver=1))
        frame_s.append(sec)
        check_counts("flow_hs solver=1", elin_expected)
    main_launches.update(elin_expected)
    print_profile("flow_hs solver=1", min(frame_s[1:]),
                  device_profile(lambda: flow_hs(it0, it1, solver=1)))
    if not (torch.isfinite(u1).all() and torch.isfinite(v1).all()):
        fail("flow_hs solver=1: non-finite flow")
    reset_counts()
    with dispatch.plain_solvers():
        (u1p, v1p), plain_s = timed(lambda: flow_hs(it0, it1, solver=1))
    check_counts("the plain path", {})
    d_plain = mean_flow_diff((u1, v1), (u1p, v1p))
    print(f"  {hs_levels} levels, one resident launch each; frame time: cold {frame_s[0]:.3f} s, "
          f"warm {frame_s[1]:.3f} / {frame_s[2]:.3f} s; plain path {plain_s:.3f} s, mean "
          f"|dflow| vs kernel path {d_plain:.3g} px", flush=True)
    if not d_plain <= FLOW_TOL:
        fail(f"flow_hs solver=1 kernel path and plain path differ by {d_plain} px")
    # the pair of tests/test_models.py: HS relaxed pointwise needs ~400
    # sweeps to approach a 1-px shift on this smooth pattern
    import scipy.ndimage as ndi
    base = ndi.gaussian_filter(rng.random((48, 56)).astype(np.float32), 3.0) * 255.0
    us1, vs1 = flow_hs(torch.from_numpy(base).to(dev),
                       torch.from_numpy(np.roll(base, 1, axis=1)).to(dev), iter=400, solver=1)
    mu, mv = float(us1[8:-8, 8:-8].median()), float(vs1[8:-8, 8:-8].median())
    print(f"  48x56 pair shifted 1 px, iter=400: median U={mu:.4f} V={mv:.4f}", flush=True)
    if not (torch.isfinite(us1).all() and abs(mu) > 0.55 and abs(mv) < 0.2):
        fail(f"flow_hs solver=1 misses the 1-px shift: median ({mu}, {mv})")

    phase(f"11 diffusion4 {MAIN_SHAPE}, default parameters")
    fp = Diffusion4Params()
    img = noisy * 255.0
    diff_expected = 2 * (fp.outer_iter + 1)
    frame_s = []
    for _ in range(2):
        reset_counts()
        dif, sec = timed(lambda: diffusion4(img))
        frame_s.append(sec)
        check_counts("diffusion4", {"tridiag_thomas": diff_expected,
                                    **reweight_launches(1, fp.outer_iter + 1, None)})
    if dif.shape != MAIN_SHAPE or not torch.isfinite(dif).all():
        fail(f"diffused image of shape {tuple(dif.shape)}, or not finite")
    reset_counts()
    with dispatch.plain_solvers():
        difp, plain_s = timed(lambda: diffusion4(img))
    check_counts("the plain path", {})
    d_rel = float((dif - difp).abs().max()) / float(img.max() - img.min())
    sd_in = float(img[flat].std(dim=(1, 2)).mean())
    sd_out = float(dif[flat].std(dim=(1, 2)).mean())
    print(f"  {fp.outer_iter + 1} iterations x 2 solves; image time: cold {frame_s[0]:.4f} s, "
          f"warm {frame_s[1]:.4f} s; plain path {plain_s:.3f} s, max |du| / range vs kernel "
          f"path {d_rel:.3g}; flat-patch noise std {sd_in:.3f} -> {sd_out:.3f}", flush=True)
    if not d_rel <= TV_REL_TOL:
        fail(f"diffusion4 kernel path and plain path differ by {d_rel} of the range")
    if not sd_out < 0.5 * sd_in:
        fail(f"diffusion4: flat-patch noise {sd_out} is not under half of the input's {sd_in}")

    phase(f"12 flow_ad {MAIN_SHAPE}, default parameters (anisotropic tensor, llin8)")
    ap_ = FlowADParams()
    ad_levels = len(pyramid_scales(MAIN_SHAPE[1], MAIN_SHAPE[2], ap_.scl_factor, 20,
                                   ap_.scales))
    # the robust terms on the kernel; its weights are the anisotropic tensor's
    ad_expected = {**sor_launches(MAIN_SHAPE, ap_.scl_factor, 20, ap_.scales,
                                  ap_.firstLoop * ap_.secondLoop, "llin8", 1, "flow_llin8_sor",
                                  1 + 2 * ap_.iter, ap_.iter),
                   **model_reweights(MAIN_SHAPE, ap_, 20, "robust_flow", 0)}
    frame_s = []
    for _ in range(3):
        reset_counts()
        (ua, va), sec = timed(lambda: flow_ad(it0, it1, "grad", "gradmag"))
        frame_s.append(sec)
        check_counts("flow_ad", ad_expected)
    main_launches.update(ad_expected)
    print(f"  {ad_levels} levels x {ap_.firstLoop} x {ap_.secondLoop} calls, one resident "
          f"launch each; frame time: cold {frame_s[0]:.3f} s, warm {frame_s[1]:.3f} / "
          f"{frame_s[2]:.3f} s", flush=True)
    print_profile("flow_ad", min(frame_s[1:]),
                  device_profile(lambda: flow_ad(it0, it1, "grad", "gradmag")))
    if ua.shape != MAIN_SHAPE[1:] or ua.device != dev or not (
            torch.isfinite(ua).all() and torch.isfinite(va).all()):
        fail(f"flow_ad flow of shape {tuple(ua.shape)} on {ua.device}, or not finite")
    mu, mv = float(ua[inner].median()), float(va[inner].median())
    print(f"  median interior flow U={mu:.4f} V={mv:.4f} (shift {MAIN_SHIFT[1]}, "
          f"{MAIN_SHIFT[0]})", flush=True)
    if abs(mu - MAIN_SHIFT[1]) > SHIFT_TOL or abs(mv - MAIN_SHIFT[0]) > SHIFT_TOL:
        fail(f"flow_ad ({mu}, {mv}) misses the shift {MAIN_SHIFT[::-1]} by more than "
             f"{SHIFT_TOL} px")
    reset_counts()
    with dispatch.plain_solvers():
        (uap, vap), plain_frame_s = timed(lambda: flow_ad(it0, it1, "grad", "gradmag"))
    check_counts("the plain path", {})
    d_plain = mean_flow_diff((ua, va), (uap, vap))
    print(f"  plain path on the card: frame {plain_frame_s:.3f} s, "
          f"mean |dflow| vs kernel path {d_plain:.3g} px", flush=True)
    if not d_plain <= FLOW_TOL:
        fail(f"flow_ad kernel path and plain path differ by {d_plain} px > {FLOW_TOL}")
    s0, s1 = shifted_frames(rng, SMALL_SHAPE, [(0.0, 0.0), MAIN_SHIFT])
    ug, vg = flow_ad(torch.from_numpy(s0).to(dev), torch.from_numpy(s1).to(dev))
    d_cpu = mean_flow_diff((ug.cpu(), vg.cpu()), flow_ad(s0, s1, device="cpu"))
    print(f"  {SMALL_SHAPE} card vs CPU path: mean |dflow| {d_cpu:.3g} px", flush=True)
    if not d_cpu <= FLOW_TOL:
        fail(f"flow_ad card and CPU paths differ by {d_cpu} px > {FLOW_TOL}")

    phase(f"13 tv_denoise8 {MAIN_SHAPE}, default parameters (anisotropic tensor, pde8)")
    tp8 = TVDenoise8Params()
    tv8_levels = partial_pyramid_levels(MAIN_SHAPE, tp8.scl, tp8.scl_factor)
    # C = 3 channels over shared weights: one resident launch a call
    tv8_expected = planned_launches(tv8_levels_hw, tp8.outer_iter + 1, "pde8", MAIN_SHAPE[0],
                                    "pde8_sor", 3 * tp8.inner_iter, tp8.inner_iter)
    frame_s = []
    for _ in range(2):
        reset_counts()
        den8, sec = timed(lambda: tv_denoise8(noisy))
        frame_s.append(sec)
        check_counts("tv_denoise8", tv8_expected)
    main_launches.update(tv8_expected)
    print(f"  {tv8_levels} levels x {tp8.outer_iter + 1} calls, one resident launch each; "
          f"image time: cold {frame_s[0]:.3f} s, warm {frame_s[1]:.3f} s", flush=True)
    print_profile("tv_denoise8", frame_s[1], device_profile(lambda: tv_denoise8(noisy)))
    if den8.shape != MAIN_SHAPE or not torch.isfinite(den8).all():
        fail(f"tv_denoise8 image of shape {tuple(den8.shape)}, or not finite")
    reset_counts()
    with dispatch.plain_solvers():
        den8p, plain_s = timed(lambda: tv_denoise8(noisy))
    check_counts("the plain path", {})
    d_rel = float((den8 - den8p).abs().max()) / scale
    sd_out = float(den8[flat].std(dim=(1, 2)).mean())
    print(f"  plain path on the card: {plain_s:.3f} s, max |du| / range vs kernel path "
          f"{d_rel:.3g}; flat-patch noise std {sd_in_tv:.4f} -> {sd_out:.4f}", flush=True)
    if not d_rel <= TV_REL_TOL:
        fail(f"tv_denoise8 kernel path and plain path differ by {d_rel} > {TV_REL_TOL} "
             f"of the range")
    if not sd_out < 0.5 * sd_in_tv:
        fail(f"tv_denoise8: flat-patch noise {sd_out} is not under half of the input's "
             f"{sd_in_tv}")

    phase(f"14 solver=2 (PCG) in flow_nd, disparity_nd, disparity_sym, tv_denoise4, "
          f"flow_ad, tv_denoise8 {MAIN_SHAPE}")
    loops = dict(firstLoop=2, secondLoop=2)  # the plain comparisons' loop counts
    # (name, run at full size, expected launches, check of the result, run
    # at PLAIN_SHAPE, difference of two results, tolerance)
    cases = [
        ("flow_nd", lambda: flow_nd(it0, it1, "grad", "gradmag", solver=2),
         {**pcg_launches(n_levels * p.firstLoop * p.secondLoop, 2, p.iter), **nd_reweights},
         lambda f: ((float(f[0][inner].median()), float(f[1][inner].median())),
                    abs(float(f[0][inner].median()) - MAIN_SHIFT[1]) <= SHIFT_TOL
                    and abs(float(f[1][inner].median()) - MAIN_SHIFT[0]) <= SHIFT_TOL),
         lambda: flow_nd(small0, small1, "grad", "gradmag", solver=2, **loops),
         mean_flow_diff, FLOW_TOL),
        ("disparity_nd", lambda: disparity_nd(il, ir, "grad", "gradmag", solver=2),
         {**pcg_launches(d_levels * dp.firstLoop * dp.secondLoop, 1, dp.iter), **d_reweights},
         lambda u: (float(u[inner].median()),
                    abs(float(u[inner].median()) - DISP_SHIFT[1]) <= DISP_SHIFT_TOL),
         lambda: disparity_nd(small0, small1, "grad", "gradmag", solver=2, **loops),
         lambda a, b: float((a - b).abs().mean()), FLOW_TOL),
        ("disparity_sym", lambda: disparity_sym(il, ir, solver=2),
         {**pcg_launches(s_levels * sp.firstLoop * sp.secondLoop, 1, sp.iter),
          **model_reweights(MAIN_SHAPE, sp, 10, None, 2)},
         lambda u: ((float(u[0][inner].median()), float(u[1][inner].median())),
                    abs(float(u[0][inner].median()) - DISP_SHIFT[1]) <= DISP_SHIFT_TOL
                    and abs(float(u[1][inner].median()) + DISP_SHIFT[1]) <= DISP_SHIFT_TOL),
         lambda: disparity_sym(small0, small1, solver=2, **loops),
         lambda a, b: float((a - b).abs().mean()), FLOW_TOL),
        ("tv_denoise4", lambda: tv_denoise4(noisy, solver=2),
         {**pcg_launches(tv_levels * (tp.outer_iter + 1), 1, tp.inner_iter),
          **reweight_launches(tv_levels, tp.outer_iter + 1, None)},
         lambda u: ((float(noisy[flat].std(dim=(1, 2)).mean()),
                     float(u[flat].std(dim=(1, 2)).mean())),
                    float(u[flat].std(dim=(1, 2)).mean())
                    < 0.5 * float(noisy[flat].std(dim=(1, 2)).mean())),
         lambda: tv_denoise4(small0 / 255.0, solver=2, outer_iter=2),
         lambda a, b: float((a - b).abs().max()) / float((small0 / 255.0).max()
                                                       - (small0 / 255.0).min()),
         TV_REL_TOL),
        ("flow_ad", lambda: flow_ad(it0, it1, "grad", "gradmag", solver=2),
         {**pcg_launches(ad_levels * ap_.firstLoop * ap_.secondLoop, 2, ap_.iter),
          **model_reweights(MAIN_SHAPE, ap_, 20, "robust_flow", 0)},
         lambda f: ((float(f[0][inner].median()), float(f[1][inner].median())),
                    abs(float(f[0][inner].median()) - MAIN_SHIFT[1]) <= SHIFT_TOL
                    and abs(float(f[1][inner].median()) - MAIN_SHIFT[0]) <= SHIFT_TOL),
         lambda: flow_ad(small0, small1, "grad", "gradmag", solver=2, **loops),
         mean_flow_diff, FLOW_TOL),
        ("tv_denoise8", lambda: tv_denoise8(noisy, solver=2),
         pcg_launches(tv8_levels * (tp8.outer_iter + 1), 1, tp8.inner_iter),
         lambda u: ((sd_in_tv, float(u[flat].std(dim=(1, 2)).mean())),
                    float(u[flat].std(dim=(1, 2)).mean()) < 0.5 * sd_in_tv),
         lambda: tv_denoise8(small0 / 255.0, solver=2, outer_iter=2),
         lambda a, b: float((a - b).abs().max()) / float((small0 / 255.0).max()
                                                       - (small0 / 255.0).min()),
         TV_REL_TOL),
    ]
    for name, run, expected, check, run_small, diff, tol in cases:
        frame_s = []
        for _ in range(2):
            reset_counts()
            out, sec = timed(run)
            frame_s.append(sec)
            check_counts(f"{name} solver=2", expected)
        outs = out if isinstance(out, tuple) else (out,)
        if not all(torch.isfinite(o).all() for o in outs):
            fail(f"{name} solver=2: non-finite result")
        value, ok = check(out)
        print(f"  {name}: {sum(expected.values())} line-solve launches; frame time: cold "
              f"{frame_s[0]:.3f} s, warm {frame_s[1]:.3f} s; result check {value}", flush=True)
        if not ok:
            fail(f"{name} solver=2: result check failed ({value})")
        print_profile(f"{name} solver=2", frame_s[1], device_profile(run))
        kernel_vs_plain(f"{name} solver=2", run_small, diff, tol)

    hh, hw = HEADLINE_SHAPE
    phase(f"15 tiled engine, bench.py's headline: llin4 and elin4 sweeps at {hh}x{hw}")
    hpx = hh * hw

    def bench_field(scale=1.0):
        return torch.from_numpy((rng.random(HEADLINE_SHAPE) * scale).astype(np.float32)).to(dev)

    # bench.py's inputs
    bu, bv, bdu, bdv = bench_field(0.1), bench_field(0.1), bench_field(0.0), bench_field(0.0)
    bm, bcu, bcv = bench_field(0.01), bench_field(), bench_field()
    bduc, bdvc = bench_field() + 1.0, bench_field() + 1.0
    bw = torch.full(HEADLINE_SHAPE, 0.25, device=dev)
    coef = (bm, bcu, bcv, bduc, bdvc, bw, bw, bw, bw)
    llin_prep, llin_sw = sweeps.flow_llin4_sweep(1.9)
    elin_prep, elin_sw = sweeps.flow_elin4_sweep(1.9)
    # name: (family, one call from the relaxed pair a, b)
    variants = {
        "flow_llin4_sor": ("flow_llin4", lambda a, b, it: sor_cuda.flow_llin4_sor(
            bu, bv, a, b, *coef, it, 1.9)),
        "tiled_flow_llin4": ("flow_llin4", lambda a, b, it: tiled.tiled_relax(
            (a, b, bu, bv) + coef, llin_sw, 2, it, k_max=4, prepare_fn=llin_prep)),
        "tiled_flow_llin4_db": ("flow_llin4", lambda a, b, it: tiled.tiled_relax(
            (a, b, bu, bv) + coef, llin_sw, 2, it, k_max=4, prepare_fn=llin_prep,
            double_buffer=True)),
        "flow_elin4_sor": ("flow_elin4", lambda a, b, it: sor_cuda.flow_elin4_sor(
            a, b, *coef, it, 1.9)),
        "tiled_flow_elin4": ("flow_elin4", lambda a, b, it: tiled.tiled_relax(
            (a, b) + coef, elin_sw, 2, it, k_max=4, prepare_fn=elin_prep)),
        "tiled_flow_elin4_db": ("flow_elin4", lambda a, b, it: tiled.tiled_relax(
            (a, b) + coef, elin_sw, 2, it, k_max=4, prepare_fn=elin_prep, double_buffer=True)),
    }
    start = {"flow_llin4": (bdu, bdv), "flow_elin4": (bu, bv)}
    plans = {name: tiled.plan_tiles(hh, hw, fam, HEADLINE_ITERS[1], 4, double_buffer=db,
                                    sm_count=sms)
             for name, (fam, db) in TILED.items()}
    expected = {}

    def call(name, a, b, iters):
        """One call of ``name``, tallying the launches it must make."""
        expected[name] = expected.get(name, 0) + (
            -(-iters // plans[name].k) if name in TILED else 1 + 2 * iters)
        return variants[name][1](a, b, iters)

    def chained_ms(name, iters, reps=3):
        """Best of ``reps`` of two chained calls (the output fed back in),
        ms a call, CUDA events."""
        def two():
            a, b = start[variants[name][0]]
            for _ in range(2):
                a, b = call(name, a, b, iters)
        two()
        best = float("inf")
        for _ in range(reps):
            t0_ev, t1_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0_ev.record()
            two()
            t1_ev.record()
            t1_ev.synchronize()
            best = min(best, t0_ev.elapsed_time(t1_ev) / 2)
        return best

    reset_counts()
    rates = {}
    for name, (family, _) in variants.items():
        t_lo, t_hi = (chained_ms(name, it) for it in HEADLINE_ITERS)
        ms_sweep = (t_hi - t_lo) / (HEADLINE_ITERS[1] - HEADLINE_ITERS[0])
        rate = hpx / (ms_sweep * 1e-3) / 1e6
        rates[name] = rate
        if name in TILED:
            plan = plans[name]
            bpp = tiled.bytes_per_pixel_iter(plan, family)
            how = f"plan k={plan.k}, {plan.tile_h}x{plan.tile_w} tiles"
        else:
            bpp = GLOBAL_BYTES_PER_PX_SWEEP[name]
            how = "two colour launches a sweep"
        gbps = rate * 1e6 * bpp / 1e9
        print(f"  {name}: {rate:.0f} Mpix-iters/s sustained ({t_lo:.4f} ms a call of "
              f"{HEADLINE_ITERS[0]} sweeps, {t_hi:.4f} ms of {HEADLINE_ITERS[1]}); "
              f"{bpp:.1f} B a pixel-iteration ({how}) -> {gbps:.0f} GB/s, "
              f"{100 * gbps / (HBM_BYTES_PER_S / 1e9):.1f}% of 3.35 TB/s", flush=True)
    for family in ("flow_llin4", "flow_elin4"):
        ref = call(f"{family}_sor", *start[family], HEADLINE_ITERS[1])
        outs = {name: call(name, *start[family], HEADLINE_ITERS[1])
                for name in (f"tiled_{family}", f"tiled_{family}_db")}
        torch.cuda.synchronize()
        for name, out in outs.items():
            if not all(torch.isfinite(o).all() for o in out):
                fail(f"{name}: non-finite result after {HEADLINE_ITERS[1]} sweeps")
            d = max(float((a - b).abs().max()) for a, b in zip(out, ref))
            print(f"  {name} after {HEADLINE_ITERS[1]} sweeps: max |d| vs {family}_sor {d:.3g}; "
                  f"{rates[name] / rates[family + '_sor']:.2f}x its sustained rate", flush=True)
            if not d <= SOR_TOL:
                fail(f"{name} differs from {family}_sor by {d} > {SOR_TOL} after "
                     f"{HEADLINE_ITERS[1]} sweeps")
        if not bit_equal(*outs.values()):
            fail(f"tiled_{family}: serial and double-buffered differ after "
                 f"{HEADLINE_ITERS[1]} sweeps")
    check_counts("phase 15", expected)
    # the headline is no main path: no model launches the double-buffered
    # tile kernels (pde_tpu's bench.py alone reaches _stripe_kernel_db), so
    # the kernels line gives them 0; phase 16's frames give the serial ones
    # theirs
    for name in (*TILED, *TILED_NEW_DB):
        main_launches[name] = 0

    phase(f"16 flow_nd, disparity_nd, flow_ad, tv_denoise8, tv_denoise4 and flow_hs solver=1 "
          f"{LARGE_SHAPE}: levels without a resident plan")
    # the finest level is too large for one band an SM, so the tile kernel
    # takes its solves, in every family; every other level goes to the
    # resident kernel (tv_denoise8: neither level, 1024x1024 and 768x768,
    # has a plan, since three channels' planes of a band would need more
    # shared memory; tv_denoise4: nor 768x768 and 576x576, whose three
    # channels would need 5 slots a thread)
    big0, big1 = (torch.from_numpy(f).to(dev)
                  for f in shifted_frames(rng, LARGE_SHAPE, [(0.0, 0.0), MAIN_SHIFT]))
    for name, run, want, key in (
            ("flow_nd", lambda: flow_nd(big0, big1, "grad", "gradmag"),
             {**sor_launches(LARGE_SHAPE, p.scl_factor, 20, p.scales,
                             p.firstLoop * p.secondLoop, "llin4", 1, "flow_llin4_sor",
                             1 + 2 * p.iter, p.iter),
              **model_reweights(LARGE_SHAPE, p, 20, "robust_flow")}, "flow_llin4_sor"),
            ("disparity_nd", lambda: disparity_nd(big0, big1, "grad", "gradmag"),
             {**sor_launches(LARGE_SHAPE, dp.scl_factor, 10, dp.scales,
                             dp.firstLoop * dp.secondLoop, "disp", 1, "disp_llin4_sor",
                             3 * dp.iter, dp.iter),
              **model_reweights(LARGE_SHAPE, dp, 10, "robust_disp")}, "disp_llin4_sor"),
            ("flow_ad", lambda: flow_ad(big0, big1, "grad", "gradmag"),
             {**sor_launches(LARGE_SHAPE, ap_.scl_factor, 20, ap_.scales,
                             ap_.firstLoop * ap_.secondLoop, "llin8", 1, "flow_llin8_sor",
                             1 + 2 * ap_.iter, ap_.iter),
              **model_reweights(LARGE_SHAPE, ap_, 20, "robust_flow", 0)}, "flow_llin8_sor"),
            ("tv_denoise8", lambda: tv_denoise8(big0 / 255.0),
             planned_launches(partial_pyramid_shapes(LARGE_SHAPE, tp8.scl, tp8.scl_factor),
                              tp8.outer_iter + 1, "pde8", LARGE_SHAPE[0], "pde8_sor",
                              3 * tp8.inner_iter, tp8.inner_iter), "pde8_sor"),
            ("tv_denoise4", lambda: tv_denoise4(big0 / 255.0),
             {**planned_launches(partial_pyramid_shapes(LARGE_SHAPE, tp.scl, tp.scl_factor),
                                 tp.outer_iter + 1, "pde4", LARGE_SHAPE[0], "pde4_sor",
                                 3 * tp.inner_iter, tp.inner_iter),
              **reweight_launches(partial_pyramid_levels(LARGE_SHAPE, tp.scl, tp.scl_factor),
                                  tp.outer_iter + 1, None)}, "pde4_sor"),
            ("flow_hs solver=1", lambda: flow_hs(big0, big1, solver=1),
             sor_launches(LARGE_SHAPE, hp.scl_factor, 20, hp.scales, 1, "elin4", 1,
                          "flow_elin4_sor", 1 + 2 * hp.iter, hp.iter), "flow_elin4_sor")):
        fixed = PHASE16_TILED.get(name)
        if fixed is not None and {k: n for k, n in want.items() if k.startswith("tiled")} != fixed:
            fail(f"{name} at {LARGE_SHAPE}: expected {want}, not the tile kernel's {fixed}")
        reset_counts()
        out, sec = timed(run)
        check_counts(name, want)
        outs = out if isinstance(out, tuple) else (out,)
        if not all(torch.isfinite(o).all() and o.shape[-2:] == LARGE_SHAPE[1:] for o in outs):
            fail(f"{name} at {LARGE_SHAPE}: non-finite result or wrong shape")
        # the main path's launches of the global kernel and of the tile
        # kernels (0 where the frame has none: no model launches the global
        # SOR kernels since the tile kernel takes their shapes)
        main_launches.update({k: n for k, n in want.items()
                              if k == key or k in TILED or k in TILED_NEW})
        print(f"  {name}: frame {sec:.3f} s (cold), finite; launches "
              f"{ {k: n for k, n in want.items() if n} }", flush=True)
        if name.startswith("tv_denoise"):
            # a warm frame's device ms in each of the port's kernels (the
            # tile kernel's is tiled_family_kernel)
            own = {}
            for e in device_events(run):
                if kernel := own_kernel(e.key):
                    own[kernel] = own.get(kernel, 0.0) + e.self_device_time_total / 1e3
            print(f"  {name}: a warm frame's kernels under torch.profiler: "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in sorted(own.items())), flush=True)

    phase(f"17 flow_fmg {MAIN_SHAPE}, default parameters (V-cycle; solver=2 and solver=1)")
    fp_ = FlowFMGParams()

    def fmg_expected(shape, solver, cycle_index, p_):
        """Exact launches of a flow_fmg call: solver=1 ``planned_launches``
        of each level's solves (one resident elin4 launch a solve where the
        level has a plan), solver=2 pcg_launches of every solve."""
        levels = fmg_levels(shape, p_.scales)
        calls = fmg_smooth_calls(len(levels), cycle_index)
        weights = {"weights4": fmg_weights4(len(levels), cycle_index, p_.firstLoop)}
        if solver == 2:
            return {**pcg_launches(sum(calls) * p_.firstLoop, 2, p_.iter), **weights}
        want = dict(weights)
        for (h, w), c in zip(levels, calls):
            for key, n in planned_launches([(h, w)], c * p_.firstLoop, "elin4", 1,
                                           "flow_elin4_sor", 1 + 2 * p_.iter, p_.iter).items():
                want[key] = want.get(key, 0) + n
        return want

    f0, f1 = (torch.from_numpy(f).to(dev)
              for f in shifted_frames(rng, MAIN_SHAPE, [(0.0, 0.0), FMG_SHIFT]))
    fmg_lv = fmg_levels(MAIN_SHAPE)
    # the sign convention of the warping flow on this pair (tests/test_models.py)
    nd_sign = float(torch.sign(flow_nd(f0, f1, "grad", "none")[0][inner].median()))
    fmg_out, fmg_warm_s, fmg_prof = {}, {}, {}
    fmg_frames = (f0, f1)
    for solver in (2, 1):
        expected = fmg_expected(MAIN_SHAPE, solver, 1, fp_)
        frame_s = []
        for _ in range(3):
            reset_counts()
            (uf, vf), sec = timed(lambda: flow_fmg(f0, f1, solver=solver))
            frame_s.append(sec)
            check_counts(f"flow_fmg solver={solver}", expected)
        fmg_out[solver] = (uf, vf)
        fmg_warm_s[solver] = frame_s[1:]
        if not (torch.isfinite(uf).all() and torch.isfinite(vf).all()):
            fail(f"flow_fmg solver={solver}: non-finite flow")
        mu, mv = float(uf[inner].median()), float(vf[inner].median())
        print(f"  solver={solver}: {len(fmg_lv)} levels {fmg_lv[0]} to {fmg_lv[-1]}, "
              f"{sum(fmg_smooth_calls(len(fmg_lv), 1)) * fp_.firstLoop} solves, "
              f"{sum(expected.values())} kernel launches; frame time: cold {frame_s[0]:.3f} s, "
              f"warm {frame_s[1]:.3f} / {frame_s[2]:.3f} s; median interior U={mu:.4f} "
              f"V={mv:.4f} (shift {FMG_SHIFT[1]}, flow_nd's sign {nd_sign:+.0f})", flush=True)
        if not (mu * nd_sign > 0.4 and abs(mv) < 0.3):
            fail(f"flow_fmg solver={solver} misses the {FMG_SHIFT[1]}-px shift: median ({mu}, "
                 f"{mv})")
        fmg_prof[solver] = device_profile(lambda: flow_fmg(f0, f1, solver=solver))
        print_profile(f"flow_fmg solver={solver}", min(frame_s[1:]), fmg_prof[solver])
    # the FAS cycles amplify rounding (ROADMAP F7): at full size one ulp
    # more in every smoothing solve's U (or less in V) moves the plain path's
    # flow by a few tenths of a px, so the kernel path is held against the
    # plain path within a few times that there, and to FLOW_TOL at
    # PLAIN_SHAPE (every resident elin4 call at this pyramid's levels is held
    # against the plain solve in phase 3)
    fmg_mod = importlib.import_module("pde_tpu_torch.models.flow_fmg")

    def nudged_solve(field):
        """The plain solve with U one ulp up (field 0) or V one ulp down (1)."""
        def solve(*args):
            out = list(dispatch.sor_flow_elin4(*args))
            out[field] = torch.nextafter(out[field], torch.full_like(out[field], (1, -1)[field]
                                                                     * float("inf")))
            return tuple(out)
        return solve

    reset_counts()
    with dispatch.plain_solvers():
        fmg_plain, plain_s = timed(lambda: flow_fmg(f0, f1, solver=1))
        d_ulp = 0.0
        for field in (0, 1):
            fmg_mod.sor_flow_elin4 = nudged_solve(field)
            try:
                d_ulp = max(d_ulp, mean_flow_diff(flow_fmg(f0, f1, solver=1), fmg_plain))
            finally:
                fmg_mod.sor_flow_elin4 = dispatch.sor_flow_elin4
    check_counts("the plain path", {})
    d_plain = mean_flow_diff(fmg_out[1], fmg_plain)
    print(f"  solver=1 plain path on the card: frame {plain_s:.3f} s, mean |dflow| vs kernel "
          f"path {d_plain:.3g} px; the plain path with every solve's U one ulp up, or V one "
          f"ulp down, moves up to {d_ulp:.3g} px", flush=True)
    if not d_plain <= FMG_ULP_FACTOR * max(d_ulp, FLOW_TOL):
        fail(f"flow_fmg solver=1 kernel path and plain path differ by {d_plain} px, more than "
             f"{FMG_ULP_FACTOR} x the plain path's one-ulp sensitivity {d_ulp} px")
    fs0, fs1 = (torch.from_numpy(f).to(dev)
                for f in shifted_frames(rng, PLAIN_SHAPE, [(0.0, 0.0), FMG_SHIFT]))
    for solver in (1, 2):
        kernel_vs_plain(f"flow_fmg solver={solver}",
                        lambda: flow_fmg(fs0, fs1, solver=solver, firstLoop=2),
                        mean_flow_diff, FLOW_TOL)
    w0, w1 = (torch.from_numpy(f).to(dev)
              for f in shifted_frames(rng, FMG_W_SHAPE, [(0.0, 0.0), FMG_SHIFT]))
    expected = fmg_expected(FMG_W_SHAPE, 2, 2, fp_)
    reset_counts()
    (uw, vw), sec = timed(lambda: flow_fmg(w0, w1, cycle_index=2))
    check_counts("flow_fmg W-cycle", expected)
    w_lv = fmg_levels(FMG_W_SHAPE)
    print(f"  W-cycle at {FMG_W_SHAPE}: {len(w_lv)} levels, "
          f"{sum(fmg_smooth_calls(len(w_lv), 2)) * fp_.firstLoop} solves, "
          f"{sum(expected.values())} kernel launches, frame {sec:.3f} s (cold); median interior "
          f"U={float(uw[inner].median()):.4f} V={float(vw[inner].median()):.4f}", flush=True)
    if not (torch.isfinite(uw).all() and torch.isfinite(vw).all()):
        fail("flow_fmg W-cycle: non-finite flow")

    phase("18 gac_a and gac_b, default parameters, on gac_ctour.npz's phi0 with a synthetic "
          "image")
    gp = GACParams()
    phi0 = np.load(HERE / "tests" / "golden" / "gac_ctour.npz")["phi0"]
    gh, gw = phi0.shape
    gy, gx = np.mgrid[:gh, :gw]
    cy, cx, radius = 108, 165, 35  # a bright disc inside the initial contour
    gimg = 0.3 + 0.1 * rng.random((3, gh, gw)).astype(np.float32)
    gimg[:, (gy - cy) ** 2 + (gx - cx) ** 2 < radius ** 2] += 0.5
    import scipy.ndimage as ndi
    gimg = torch.from_numpy(ndi.gaussian_filter(gimg, (0, 1.5, 1.5)).astype(np.float32)).to(dev)
    phi0_d = torch.from_numpy(phi0).to(dev)
    area0 = int((phi0_d > 0).sum())
    for name, fn in (("gac_a", gac_a), ("gac_b", gac_b)):
        frame_s = []
        for _ in range(3):
            reset_counts()
            phi, sec = timed(lambda: fn(gimg, phi0_d))
            frame_s.append(sec)
            check_counts(name, {"tridiag_thomas": 2 * gp.ITER})
        area = int((phi > 0).sum())
        print(f"  {name}: {gp.ITER} AOS steps, {2 * gp.ITER} tridiag_thomas launches; frame "
              f"time: cold {frame_s[0]:.3f} s, warm {frame_s[1]:.3f} / {frame_s[2]:.3f} s; "
              f"positive area {area0} -> {area} px, phi at the disc's centre "
              f"{float(phi[cy, cx]):.3f}", flush=True)
        if not torch.isfinite(phi).all() or phi.shape != phi0_d.shape:
            fail(f"{name}: non-finite level set or wrong shape")
        if not (0 < area < area0 and float(phi[cy, cx]) > 0):
            fail(f"{name}: the contour did not shrink around the disc ({area0} -> {area} px, "
                 f"phi at the centre {float(phi[cy, cx])})")
        print_profile(name, min(frame_s[1:]), device_profile(lambda: fn(gimg, phi0_d)))
        sh, sw = GAC_SMALL
        small_img = gimg[:, cy - sh // 2:cy + sh // 2, cx - sw // 2:cx + sw // 2].contiguous()
        sy, sx = np.mgrid[:sh, :sw]
        small_phi = torch.from_numpy(
            (28.0 - np.hypot(sy - sh / 2, sx - sw / 2)).astype(np.float32)).to(dev)

        got = fn(small_img, small_phi, ITER=20)
        reset_counts()
        with dispatch.plain_solvers():
            want, plain_s = timed(lambda: fn(small_img, small_phi, ITER=20))
        check_counts(f"{name}'s plain path", {})
        err = float((got - want).abs().max())
        print(f"  {name} at {GAC_SMALL}, ITER=20: kernel path vs plain path max |dphi| "
              f"{err:.3g} (plain path {plain_s:.3f} s on the card)", flush=True)
        if not err <= GAC_TOL:
            fail(f"{name}: kernel path and plain path differ by {err} > {GAC_TOL}")
    # rows longer than the staged solve holds: the global-rows variant in a
    # model call, held against the CPU path
    lh, lw = GAC_STRIP
    strip = 0.2 + 0.1 * rng.random((lh, lw)).astype(np.float32)
    strip[4:12, lw // 3:2 * lw // 3] += 0.6
    strip_phi = np.broadcast_to(6.0 - np.abs(np.arange(lh, dtype=np.float32) - lh / 2)[:, None],
                                (lh, lw)).copy()
    reset_counts()
    phi_s = gac_a(torch.from_numpy(strip).to(dev), torch.from_numpy(strip_phi).to(dev), ITER=2)
    torch.cuda.synchronize()
    check_counts(f"gac_a {GAC_STRIP}", {"tridiag_thomas": 2, "tridiag_thomas_long": 2})
    main_launches["tridiag_long"] = 2
    phi_c = gac_a(strip, strip_phi, ITER=2, device="cpu")
    d_strip = float((phi_s.cpu() - phi_c).abs().max()) / float(phi_c.max() - phi_c.min())
    print(f"  gac_a on a {lh}x{lw} strip, ITER=2: 2 staged and 2 global-rows tridiag_thomas "
          f"launches; card vs CPU path max |dphi| / range {d_strip:.3g}", flush=True)
    if not d_strip <= TV_REL_TOL:
        fail(f"gac_a on the strip: card and CPU paths differ by {d_strip} of the range")

    phase("19 disp_segmentation (dense and sparse) on tests/fixtures/disparity_maps.npz, "
          "default parameters")
    maps = np.load(HERE / "tests" / "fixtures" / "disparity_maps.npz")
    dd, ds = maps["dd"].astype(np.float32), maps["ds"].astype(np.float32)
    # what each pipeline call returned, phase by phase: (kind, segments out)
    seg_calls = []
    real_gen, real_rc = seg_mod._generate_seeds, seg_mod._region_competition

    def gen_logged(*a, **k):
        out = real_gen(*a, **k)
        seg_calls.append(("seeds", len(out[0])))
        return out

    def rc_logged(*a, **k):
        out = real_rc(*a, **k)
        seg_calls.append(("competition", len(out[0])))
        return out

    seg_mod._generate_seeds, seg_mod._region_competition = gen_logged, rc_logged
    # the inputs of the segmentation's own AOS steps: the largest (H, W)
    # seeding step and the largest (S, H, W) competition step of the dense
    # and the sparse call, whose line solves are held against the plain
    # solve below (a copy is taken only when a larger step comes)
    aos_inputs = {}
    aos_label = ["dense"]
    real_aos = seg_mod.cv_aos_step

    def aos_logged(phi, *rest):
        which = (aos_label[0], "seeding" if phi.ndim == 2 else "competition")
        if phi.numel() > aos_inputs.get(which, (0, None))[0] and (phi.ndim == 2
                                                                   or phi.shape[0] > 1):
            aos_inputs[which] = (phi.numel(), tuple(x.clone() if torch.is_tensor(x) else x
                                                   for x in (phi, *rest)))
        return real_aos(phi, *rest)

    seg_mod.cv_aos_step = aos_logged

    def seg_expected(din, sparse, p, warm_start):
        """tridiag_thomas launches of one call: two an AOS step, one step a
        seed and stage iteration of every seeding (dead seeds run on behind
        their gate) and a stage iteration of every competition, for the
        phases the segments found let run (seg_calls)."""
        _, _, seed_pyr, comp_pyr = seg_mod._build_pyramids(
            torch.from_numpy(din).to(dev), p, sparse, dev)
        ls, lc = len(seed_pyr) - 1, len(comp_pyr) - 1
        found = [n for _, n in seg_calls]
        if warm_start:  # competition, one seed, competition if any segment
            steps = lc * p.rc_iterations2 + lc * p.seed_iterations
            steps += lc * p.rc_iterations2 if found[0] + found[1] else 0
        else:
            steps = p.seeds * ls * p.seed_iterations
            if p.seeds != 1 and found[0]:
                steps += lc * p.rc_iterations + p.seeds * lc * p.seed_iterations
                steps += lc * p.rc_iterations2 if found[1] + found[2] else 0
        return {"tridiag_thomas": 2 * steps}, (seed_pyr, comp_pyr)

    def seg_run(fn, din, sparse, p, **kw):
        """One counted call: (outputs, seconds, expected launches, pyramids)."""
        seg_calls.clear()
        reset_counts()
        out, sec = timed(lambda: fn(torch.from_numpy(din).to(dev), **kw))
        want, pyrs = seg_expected(din, sparse, p, "phi" in kw)
        check_counts(f"{fn.__name__} {din.shape}", want)
        return out, sec, want, pyrs

    def seg_summary(what, out, sec, want, pyrs):
        phi, seg, sparam = out
        print(f"  {what}: {phi.shape[0]} segments, coverage {float((seg > 0).float().mean()):.4f}, "
              f"frame {sec:.3f} s, {want['tridiag_thomas']} tridiag_thomas launches (pyramids "
              f"{pyrs[0]}, {pyrs[1]}; phases {seg_calls})", flush=True)

    dense_p, sparse_p = seg_mod.DispSegParams(), seg_mod.sparse_defaults()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for label in ("cold", "warm"):
        out, sec, want, pyrs = seg_run(seg_mod.disp_segmentation, dd, False, dense_p)
        seg_summary(f"disp_segmentation {dd.shape} ({label})", out, sec, want, pyrs)
        runs.append((out, sec))
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    main_launches["tridiag_seg"] = want["tridiag_thomas"]
    phi, seg, sparam = runs[-1][0]
    dmin, dmax = float(np.nanmin(dd)), float(np.nanmax(dd))
    offsets_ok = bool(((sparam[:, 2] > dmin - 3.0) & (sparam[:, 2] < dmax + 3.0)).any())
    coverage = float((seg > 0).float().mean())
    if not (phi.shape[0] >= 2 and coverage > 0.35 and offsets_ok and torch.isfinite(phi).all()):
        fail(f"disp_segmentation: {phi.shape[0]} segments, coverage {coverage}, a surface "
             f"offset within [{dmin - 3}, {dmax + 3}]: {offsets_ok}, finite phi: "
             f"{bool(torch.isfinite(phi).all())}")
    if runs[0][0][0].shape != phi.shape or not torch.equal(runs[0][0][1], seg):
        fail("disp_segmentation: two calls from one seed differ")
    torch.cuda.reset_peak_memory_stats()
    aos_label[0] = "sparse"
    out, sec, want, pyrs = seg_run(seg_mod.disp_segmentation_sparse, ds, True, sparse_p)
    seg_summary(f"disp_segmentation_sparse {ds.shape} ({np.isnan(ds).mean():.2%} NaN)", out,
                sec, want, pyrs)
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    phi_s, _, sparam_s = out
    if not (phi_s.shape[0] >= 1 and torch.isfinite(phi_s).all()
            and torch.isfinite(sparam_s).all()):
        fail(f"disp_segmentation_sparse: {phi_s.shape[0]} segments or non-finite phi/SParam")
    seg_mod.cv_aos_step = real_aos

    # tridiag_thomas at the main path's own shapes: both line solves of each
    # captured AOS step, on its coefficients, against the plain solve on the
    # same card tensors, bit for bit
    solves = []
    real_solve = aos_mod.thomas_solve

    def solve_logged(a, b, c, d, axis):
        solves.append((a, b, c, d, axis))
        return real_solve(a, b, c, d, axis)

    aos_mod.thomas_solve = solve_logged
    seg_solve = None
    for (variant, step), (_, inputs) in sorted(aos_inputs.items()):
        solves.clear()
        real_aos(*inputs)
        for a, b, c, d, axis in list(solves):
            label = f"{variant} {step} {tuple(d.shape)} axis={axis}"
            got = tdma_cuda.thomas_solve(a, b, c, d, axis)
            with dispatch.plain_solvers():
                want_s = dispatch.thomas_solve(a, b, c, d, axis)
            err = hold("tridiag_seg", got, want_s, label)
            if not bit_equal((got,), (want_s,)):
                fail(f"tridiag_thomas at {label}: not the plain version's bits")
            print(f"  tridiag_thomas at the segmentation's {label}: bit for bit with the plain "
                  f"solve (max_abs_err {err:.3g})", flush=True)
            if (variant, step, axis) == ("dense", "seeding", -2):
                seg_solve = (a, b, c, d, axis)
    aos_mod.thomas_solve = real_solve
    if seg_solve is None:
        fail("disp_segmentation: no full-size seeding step was captured")
    # the dense call's finest seeding solve, timed as the report's entry
    a, b, c, d, axis = seg_solve
    n = d.numel()
    k_ms, p_ms, turns = in_turns(partial(tdma_cuda.thomas_solve, a, b, c, d, axis),
                                 partial(plain_tdma.thomas_solve, a, b, c, d, axis), reps=20,
                                 plain_reps=2)
    times[("tridiag_seg",)] = (k_ms, p_ms)
    bounds[("tridiag_seg",)] = bound((4 + 1) * 4 * n, TRIDIAG_FLOPS_PER_PX * n)
    print(f"  time tridiag_thomas at the segmentation's {tuple(d.shape)} axis={axis} per call: "
          f"kernel {turns[1]:.4f} / {turns[2]:.4f} ms, plain {turns[0]:.4f} / {turns[3]:.4f} "
          f"ms, bound {bounds[('tridiag_seg',)][0]:.4f} ms", flush=True)

    # the kernel path against the plain path on the crop: one card generator
    # seeded alike draws the same samples while the line solves agree bit for
    # bit, so the runs agree exactly
    crop_d = np.ascontiguousarray(dd[::2, ::2][SEG_CROP_WINDOW])
    crop_s = np.ascontiguousarray(ds[::2, ::2][SEG_CROP_WINDOW])
    warm_phi = None
    for what, fn, din, sparse, p in (
            ("dense", seg_mod.disp_segmentation, crop_d, False, dense_p),
            ("sparse", seg_mod.disp_segmentation_sparse, crop_s, True, sparse_p),
            ("warm start", seg_mod.disp_segmentation, crop_d, False, dense_p)):
        kw = dict(SEG_REDUCED) if what != "warm start" else dict(SEG_REDUCED, phi=warm_phi)
        p_run = seg_mod.with_overrides(p, **{k: v for k, v in kw.items() if k != "phi"})
        got, sec_k, want_k, _ = seg_run(fn, din, sparse, p_run, **kw)
        reset_counts()
        with dispatch.plain_solvers():
            ref, sec_p = timed(lambda: fn(torch.from_numpy(din).to(dev), **kw))
        check_counts(f"{what}'s plain path", {})
        same = got[0].shape == ref[0].shape and torch.equal(got[1], ref[1])
        err = float((got[0] - ref[0]).abs().max()) if got[0].shape == ref[0].shape else np.inf
        print(f"  {what} {din.shape}, reduced counts: {got[0].shape[0]} segments, "
              f"{want_k['tridiag_thomas']} tridiag_thomas launches; kernel vs plain path: SEG "
              f"equal {same}, max |dphi| {err:.3g} (kernel path {sec_k:.3f} s, plain path "
              f"{sec_p:.3f} s)", flush=True)
        if not (same and err <= SEG_TOL):
            fail(f"disp_segmentation {what}: kernel and plain paths differ (SEG equal {same}, "
                 f"max |dphi| {err} > {SEG_TOL})")
        if what == "dense":
            warm_phi = got[0]

    # one reduced full-size call of each variant: profiled, and its host syncs
    # counted by the port's line that made them (the connected components'
    # rounds are the syncs of their convergence check)
    for what, fn, din, sparse, p in (
            ("disp_segmentation", seg_mod.disp_segmentation, dd, False, dense_p),
            ("disp_segmentation_sparse", seg_mod.disp_segmentation_sparse, ds, True, sparse_p)):
        reduced = dict(SEG_REDUCED, seeds=2)
        red_fn = partial(fn, torch.from_numpy(din).to(dev), **reduced)
        _, red_s = timed(red_fn)
        _, red_s = timed(red_fn)
        seg_calls.clear()
        syncs = {}

        def note_sync(message, *rest, **kw):
            site = [f for f in traceback.extract_stack()[:-1] if "pde_tpu_torch" in f.filename]
            key = f"{Path(site[-1].filename).name}:{site[-1].lineno} {site[-1].line}" if site \
                else "outside the port"
            syncs[key] = syncs.get(key, 0) + 1

        torch.cuda.synchronize()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = note_sync
            torch.cuda.set_sync_debug_mode("warn")
            try:
                red_fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        want, _ = seg_expected(din, sparse, seg_mod.with_overrides(p, **reduced), False)
        print(f"  {what} reduced ({reduced}): warm frame {red_s:.3f} s, "
              f"{want['tridiag_thomas']} tridiag_thomas launches, {sum(syncs.values())} host "
              f"syncs; phases {seg_calls}", flush=True)
        for site, n in sorted(syncs.items(), key=lambda kv: -kv[1])[:8]:
            print(f"    {n:6d} syncs at {site[:110]}", flush=True)
        print_profile(f"{what} (reduced)", red_s, device_profile(red_fn))
    seg_mod._generate_seeds, seg_mod._region_competition = real_gen, real_rc

    mty, mtx = MESH_SHAPE
    phase(f"20 the mesh: flow_nd and flow_fmg {MAIN_SHAPE} on a virtual {mty}x{mtx} mesh of "
          f"{dev}, the sharded solvers")
    vmesh = pmesh.make_mesh(mty, mtx, devices=[dev] * (mty * mtx))

    def win_chunks(h, w, iters, mesh_shape=MESH_SHAPE, k=4):
        """Chunks of a sharded solve of ``iters`` sweeps (parallel/tiled.py's
        k_eff): one windowed launch a shard each."""
        k_eff = max(1, min(k, iters, h // mesh_shape[0] // 2, w // mesh_shape[1] // 2))
        return -(-iters // k_eff)

    def mesh_expected(levels, calls, family, global_key, per_call, iters, shard_min=64):
        """Launches of ``calls[i]`` solves at each of ``levels`` over the mesh:
        a windowed launch a shard and chunk where the level is sharded, one
        resident launch a solve (or the global kernel's) elsewhere."""
        want = {f"tiled_flow_{family}_win": 0}
        whole = []
        for (h, w), c in zip(levels, calls):
            if min(h, w) >= shard_min and h % mty == 0 and w % mtx == 0:
                want[f"tiled_flow_{family}_win"] += c * mty * mtx * win_chunks(h, w, iters)
            else:
                whole.append(((h, w), c))
        for (h, w), c in whole:
            for key, n in planned_launches([(h, w)], c, family, 1, global_key, per_call,
                                           iters).items():
                want[key] = want.get(key, 0) + n
        return want

    p = FlowNDParams()
    nd_levels = pyramid_scales(MAIN_SHAPE[1], MAIN_SHAPE[2], p.scl_factor, 20, p.scales)
    expected = {**mesh_expected(nd_levels, [p.firstLoop * p.secondLoop] * len(nd_levels),
                                "llin4", "flow_llin4_sor", 1 + 2 * p.iter, p.iter),
                **nd_reweights}
    reset_counts()
    (um, vm), sec = timed(lambda: flow_nd(*nd_frames, "grad", "gradmag", mesh=vmesh))
    check_counts("flow_nd on the mesh", expected)
    main_launches["tiled_flow_llin4_win"] = expected["tiled_flow_llin4_win"]
    if not bit_equal((um, vm), nd_main):
        fail(f"flow_nd on the mesh differs from phase 4's flow: max |dU| "
             f"{float((um - nd_main[0]).abs().max())}")
    n_sharded = sum(min(h, w) >= 64 and h % mty == 0 and w % mtx == 0 for h, w in nd_levels)
    print(f"  flow_nd on the {mty}x{mtx} mesh: {n_sharded} of {len(nd_levels)} levels sharded, "
          f"frame {sec:.3f} s (phase 4 unsharded, warm: {nd_warm_s[0]:.3f} / "
          f"{nd_warm_s[1]:.3f} s); == phase 4's flow bit for bit", flush=True)
    mesh_prof = device_profile(lambda: flow_nd(*nd_frames, "grad", "gradmag", mesh=vmesh))
    print_profile("flow_nd on the mesh", sec, mesh_prof)
    print(f"  the port's CUDA kernels, device ms a frame: flow_nd on the mesh {mesh_prof[2]:.3f}, "
          f"unsharded (phase 4) {nd_prof[2]:.3f}", flush=True)

    for solver in (1, 2):
        if solver == 2:
            expected = fmg_expected(MAIN_SHAPE, 2, 1, fp_)
        else:
            lv = fmg_levels(MAIN_SHAPE, fp_.scales)
            expected = {**mesh_expected(lv, [c * fp_.firstLoop
                                             for c in fmg_smooth_calls(len(lv), 1)],
                                        "elin4", "flow_elin4_sor", 1 + 2 * fp_.iter, fp_.iter),
                        "weights4": fmg_weights4(len(lv), 1, fp_.firstLoop)}
        reset_counts()
        (um, vm), sec = timed(lambda: flow_fmg(*fmg_frames, solver=solver, mesh=vmesh))
        check_counts(f"flow_fmg solver={solver} on the mesh", expected)
        if solver == 1:
            main_launches["tiled_flow_elin4_win"] = expected["tiled_flow_elin4_win"]
        if not bit_equal((um, vm), fmg_out[solver]):
            fail(f"flow_fmg solver={solver} on the mesh differs from phase 17's flow: max |dU| "
                 f"{float((um - fmg_out[solver][0]).abs().max())}")
        print(f"  flow_fmg solver={solver} on the {mty}x{mtx} mesh: frame {sec:.3f} s (phase 17 "
              f"unsharded, warm: {fmg_warm_s[solver][0]:.3f} / {fmg_warm_s[solver][1]:.3f} s); "
              f"== phase 17's flow bit for bit", flush=True)
        if solver == 1:
            mesh_prof = device_profile(lambda: flow_fmg(*fmg_frames, solver=1, mesh=vmesh))
            print_profile("flow_fmg solver=1 on the mesh", sec, mesh_prof)
            print(f"  the port's CUDA kernels, device ms a frame: flow_fmg solver=1 on the mesh "
                  f"{mesh_prof[2]:.3f}, unsharded (phase 17) {fmg_prof[1][2]:.3f}", flush=True)

    # the sharded llin8, disp and pde4 solvers: each shard's chunk one launch
    # of the windowed tile kernel, the unsharded solve's bits (its resident
    # kernel here), and disp's and pde4's the plain global solver's too
    mh, mw = MAIN_SHAPE[1:]
    for name, fields, sharded, plain, kernel, omega in (
            ("flow_llin8", llin8_fields(rng, mh, mw, True, dev), ptiled.tiled_sor_flow_llin8,
             plain_sor.sor_flow_llin8, dispatch.sor_flow_llin8, 1.9),
            ("disp_llin4", disp_fields(rng, 1, mh, mw, True, dev), ptiled.tiled_sor_disp_llin4,
             plain_sor.sor_disp_llin4, dispatch.sor_disp_llin4, 1.9),
            ("pde4", pde4_fields(rng, 1, mh, mw, True, dev), ptiled.tiled_sor_pde4,
             plain_sor.sor_pde4, dispatch.sor_pde4, 1.75)):
        expected = {f"tiled_{name}_win": mty * mtx * win_chunks(mh, mw, 9)}
        reset_counts()
        got, sec = timed(lambda: sharded(vmesh, *fields, 9, omega))
        check_counts(f"tiled_sor_{name}", expected)
        main_launches.update(expected)
        got = as_tuple(got)
        kern = as_tuple(kernel(*fields, 9, omega))
        if not bit_equal(got, kern):
            fail(f"tiled_sor_{name} on the mesh: not the unsharded solve's bits")
        want = as_tuple(plain(*fields, 9, omega))
        if tiled.LAYOUTS[name].fill and not bit_equal(got, want):
            fail(f"tiled_sor_{name} on the mesh: not the plain global solver's bits")
        torch.cuda.synchronize()
        d_plain = max(float(torch.where(torch.isfinite(b), a - b, 0.0).abs().max())
                      for a, b in zip(got, want))
        if not d_plain <= SOR_TOL:
            fail(f"tiled_sor_{name} on the mesh differs from the plain solver by {d_plain} > "
                 f"{SOR_TOL}")
        print(f"  tiled_sor_{name} {mh}x{mw}, 9 sweeps on the mesh: {sec * 1e3:.1f} ms, "
              f"{expected} ; == the unsharded solve bit for bit, max |d| {d_plain:.3g} against "
              f"the plain global solver", flush=True)

    # the double-buffered windowed variant, through the sharded llin4 and
    # elin4 solvers: 9 sweeps in chunks of 4, 4 and 1
    for family, make in (("flow_llin4", sor_fields), ("flow_elin4", elin_fields)):
        tf = tile_order(family, make(rng, mh, mw, True, dev))
        factory = getattr(sweeps, f"{family}_sweep")
        serial = ptiled.tiled_relax_sharded(vmesh, factory, tf, 2, 9, 1.9)
        expected = {f"tiled_{family}_win_db": mty * mtx * win_chunks(mh, mw, 9)}
        reset_counts()
        db, sec = timed(lambda: ptiled.tiled_relax_sharded(vmesh, factory, tf, 2, 9, 1.9,
                                                           double_buffer=True))
        check_counts(f"tiled_relax_sharded {family} double-buffered", expected)
        main_launches.update(expected)
        if not bit_equal(db, serial):
            fail(f"tiled_{family}_win_db on the mesh: not the serial variant's bits")
        print(f"  tiled_relax_sharded {family} double-buffered, 9 sweeps: {sec * 1e3:.1f} ms; == "
              f"serial bit for bit", flush=True)

    # the tiled PCG: tile-local zebra lines, one tridiag_thomas a tile and
    # line pass (16 a preconditioner step); bit for bit against its plain
    # path at PCG_SMALL, where the plain line solve's scan is affordable
    pty, ptx = PCG_MESH
    pmesh_card = pmesh.make_mesh(pty, ptx, devices=[dev] * (pty * ptx))
    fields = sor_fields(rng, mh, mw, True, dev)
    expected = {"tridiag_thomas": pty * ptx * 16 * (PCG_ITERS + 1)}
    reset_counts()
    (pu, pv), sec = timed(lambda: ptiled.tiled_pcg_flow_llin4(pmesh_card, *fields, PCG_ITERS))
    check_counts("tiled_pcg_flow_llin4", expected)
    if not (torch.isfinite(pu).all() and torch.isfinite(pv).all()):
        fail("tiled_pcg_flow_llin4: non-finite result")
    from pde_tpu_torch.solvers.krylov import pcg_flow_llin4
    ref = pcg_flow_llin4(*fields, PCG_ITERS, 1.9)
    d_ref = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip((pu, pv), ref))
    small = sor_fields(rng, *PCG_SMALL, True, dev)
    got = ptiled.tiled_pcg_flow_llin4(pmesh_card, *small, 2)
    with dispatch.plain_solvers():
        want = ptiled.tiled_pcg_flow_llin4(pmesh_card, *small, 2)
    if not bit_equal(got, want):
        fail(f"tiled_pcg_flow_llin4 at {PCG_SMALL}: the kernel path is not the plain path's bits")
    print(f"  tiled_pcg_flow_llin4 {mh}x{mw} on a {pty}x{ptx} mesh, {PCG_ITERS} iterations: "
          f"{sec:.3f} s, max |d| against the unsharded PCG {d_ref:.3g} of its scale; kernel "
          f"path == plain path bit for bit at {PCG_SMALL[0]}x{PCG_SMALL[1]}", flush=True)

    if torch.cuda.device_count() >= 2:
        cards = pmesh.make_mesh(1, 2, devices=[torch.device("cuda", i) for i in (0, 1)])
        fields = sor_fields(rng, mh, mw, True, dev)
        got, sec = timed(lambda: ptiled.tiled_sor_flow_llin4(cards, *fields, 9, 1.9))
        if not bit_equal(got, sor_cuda.flow_llin4_sor(*fields, 9, 1.9)):
            fail("tiled_sor_flow_llin4 over two cards: not the global kernel's bits")
        print(f"  tiled_sor_flow_llin4 {mh}x{mw} on a 1x2 mesh of two cards, 9 sweeps: "
              f"{sec * 1e3:.1f} ms; == the global kernel on one card bit for bit", flush=True)
    else:
        print(f"  {torch.cuda.device_count()} card: the copies between two cards went "
              f"unexercised", flush=True)

    phase("21 fused frames: the *_fused entry points and flow_nd_sequence as CUDA-graph replays")
    graph_mod = importlib.import_module("pde_tpu_torch.models._graph")
    release_graphs()

    def launched():
        return {k: n for k, n in counts().items() if n}

    # (a) one captured call of each CUDA entry point, replayed, bit for bit
    # against the eager call on the same inputs (made before the capture:
    # a copy from the host cannot be captured)
    def capture_launch(what, call):
        reset_counts()
        want = as_tuple(call())
        torch.cuda.synchronize()
        eager = launched()
        graph = torch.cuda.CUDAGraph()
        reset_counts()
        with torch.cuda.graph(graph):
            got = as_tuple(call())
        at_capture = launched()
        if at_capture != eager or not eager:
            fail(f"captured {what}: launches {at_capture}, the eager call's {eager}")
        reset_counts()
        graph.replay()
        torch.cuda.synchronize()
        if launched():
            fail(f"a replay of {what} counted launches {launched()}")
        if not bit_equal(got, want):
            fail(f"captured {what}: the replay is not the eager call's bits")
        graph.reset()
        print(f"  captured {what}: {at_capture}, replayed bit for bit", flush=True)

    def fields_call(make, run):
        """A call of ``run`` on fields ``make()`` made now."""
        fields = make()
        return lambda: run(*fields)

    t21 = time.time()
    # the resident kernel in every scope plan_resident picks at MAIN_SHAPE's
    # levels, for every family and batch the models launch
    resident_cases = (
        ("llin4", 1, flow_levels, lambda h, w: fields_call(
            lambda: sor_fields(rng, h, w, True, dev),
            lambda *f: resident_cuda.flow_llin4_sor(*f, p.iter, p.omega))),
        ("disp", 1, stereo_levels, lambda h, w: fields_call(
            lambda: disp_fields(rng, 1, h, w, True, dev),
            lambda *f: resident_cuda.disp_llin4_sor(*f, dp.iter, dp.omega))),
        ("disp", 2, stereo_levels, lambda h, w: fields_call(
            lambda: (disp_fields(rng, 1, h, w, True, dev), disp_fields(rng, 1, h, w, True, dev)),
            lambda f0, f1: torch.stack(resident_cuda.disp_llin4_pair(f0, f1, sp.iter,
                                                                     sp.omega)))),
        ("pde4", 3, tv4_levels_hw, lambda h, w: fields_call(
            lambda: pde4_fields(rng, 3, h, w, True, dev),
            lambda *f: resident_cuda.pde4_sor(*f, tp4_.inner_iter, tp4_.omega))),
        ("elin4", 1, fmg_levels(MAIN_SHAPE), lambda h, w: fields_call(
            lambda: elin_fields(rng, h, w, True, dev),
            lambda *f: resident_cuda.flow_elin4_sor(*f, fp_.iter, fp_.omega))),
        ("llin8", 1, ad_levels_hw, lambda h, w: fields_call(
            lambda: llin8_fields(rng, h, w, True, dev),
            lambda *f: resident_cuda.flow_llin8_sor(*f, ap_.iter, ap_.omega))),
        ("pde8", 3, tv8_levels_hw, lambda h, w: fields_call(
            lambda: pde8_fields(rng, 3, h, w, True, dev),
            lambda *f: resident_cuda.pde8_sor(*f, tp8.inner_iter, tp8.omega))))
    for family, batch, levels, case in resident_cases:
        scopes = {}
        for h, w in levels:
            plan = resident_cuda.plan_resident(h, w, family, batch, sms)
            if plan is not None and plan.scope not in scopes:
                scopes[plan.scope] = (h, w)
        for scope, (h, w) in scopes.items():
            capture_launch(f"resident {family} B={batch} {h}x{w} ({scope} scope)", case(h, w))
    # the global kernels, at a shape with no resident plan
    gh_, gw_ = TIME_SHAPES[0]
    for what, make, run in (
            ("flow_llin4_sor", lambda: sor_fields(rng, gh_, gw_, True, dev),
             lambda *f: sor_cuda.flow_llin4_sor(*f, 4, 1.9)),
            ("flow_elin4_sor", lambda: elin_fields(rng, gh_, gw_, True, dev),
             lambda *f: sor_cuda.flow_elin4_sor(*f, 4, 1.9)),
            ("flow_llin8_sor", lambda: llin8_fields(rng, gh_, gw_, True, dev),
             lambda *f: sor_cuda.flow_llin8_sor(*f, 4, 1.9)),
            ("disp_llin4_sor B=2", lambda: disp_fields(rng, 2, gh_, gw_, True, dev),
             lambda *f: interior_cuda.disp_llin4_sor(*f, 4, 1.9)),
            ("pde4_sor C=3", lambda: pde4_fields(rng, 3, gh_, gw_, True, dev),
             lambda *f: interior_cuda.pde4_sor(*f, 5, 1.75)),
            ("pde8_sor C=3", lambda: pde8_fields(rng, 3, gh_, gw_, True, dev),
             lambda *f: interior_cuda.pde8_sor(*f, 4, 1.75))):
        capture_launch(f"{what} {gh_}x{gw_}", fields_call(make, run))
    # the tile kernel at 1024x1024, serial and double-buffered, and a solve
    # the dispatch sends to it (pde4, C = 3, as tv_denoise4's finest level)
    th_, tw_ = TIME_SHAPES[-1]
    for db in (False, True):
        prep, sw = sweeps.flow_llin4_sweep(1.9)
        capture_launch(f"tiled_relax llin4 {th_}x{tw_} double_buffer={db}", fields_call(
            lambda: tile_order("flow_llin4", sor_fields(rng, th_, tw_, True, dev)),
            lambda *f, db=db, prep=prep, sw=sw: tiled.tiled_relax(
                f, sw, 2, 9, k_max=4, prepare_fn=prep, double_buffer=db)))
    capture_launch(f"dispatch.sor_pde4 C=3 {th_}x{tw_}", fields_call(
        lambda: pde4_fields(rng, 3, th_, tw_, True, dev),
        lambda *f: dispatch.sor_pde4(*f, 5, 1.75)))
    # the line solves: whole (staged and global-rows), factor and solve, the
    # fused zebra pass
    ta, tb, tc, td = tridiag_fields(rng, MAIN_SHAPE, dev)
    for axis in (-2, -1):
        capture_launch(f"tridiag_thomas {MAIN_SHAPE} axis={axis}",
                       lambda axis=axis: tdma_cuda.thomas_solve(ta, tb, tc, td, axis))
        capture_launch(f"tridiag_factor + tridiag_solve {MAIN_SHAPE} axis={axis}",
                       lambda axis=axis: tdma_cuda.tridiag_solve(
                           tdma_cuda.tridiag_factor(ta, tb, tc, axis), td))
    la, lb, lc, ld = tridiag_fields(rng, LONG_TIME[0], dev)
    capture_launch(f"tridiag_thomas {LONG_TIME[0]} axis={LONG_TIME[1]} (global rows)",
                   lambda: tdma_cuda.thomas_solve(la, lb, lc, ld, LONG_TIME[1]))
    zfac = tdma_cuda.tridiag_factor(ta, tb, tc, -2)
    zz, zrhs, zo, zm, zlo, zhi, *zd = zebra_fields(rng, MAIN_SHAPE, dev)
    for par in (0, 1):
        capture_launch(f"tridiag_zebra_pass {MAIN_SHAPE} parity={par}, coupled, 8 neighbours",
                       lambda par=par: tdma_cuda.zebra_pass(
                           zfac, zz.clone(), zrhs, zlo, zhi, par, z_o=zo, m=zm,
                           w_diag=tuple(zd)))
    print(f"  single launches: {time.time() - t21:.1f} s", flush=True)

    # (b) each fused entry point at default parameters on the earlier phases'
    # inputs: the capture's launches (the first call runs the eager frame
    # once as the warm-up, then captures: twice the pinned eager counts), a
    # replay's (none), the replayed result against the eager frame bit for
    # bit, warm frames in turns, one replay profiled, the first call's time
    # beyond a replay, and the reserve it leaves once the allocator's free
    # blocks are returned: the graph's pool (and the small returned outputs)
    fused_rows = []

    def fused_check(what, fused, eager, pinned):
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        reset_counts()
        cold_s = timed(fused)[1]
        torch.cuda.empty_cache()
        pool_mib = (torch.cuda.memory_reserved() - reserved) / 2**20
        got = counts()
        if got != {k: 2 * pinned.get(k, 0) for k in got}:
            fail(f"{what}: the first call launched {launched()}, not twice the eager frame's "
                 f"{ {k: n for k, n in pinned.items() if n} } (warm-up and capture)")
        if len(graph_mod._FRAMES) != 1:
            fail(f"{what}: {len(graph_mod._FRAMES)} captured frames, expected 1")
        reset_counts()
        out, _ = timed(fused)
        if launched():
            fail(f"{what}: a replay counted launches {launched()}")
        fused_s, eager_s, ref = [], [], None
        for turn in "effeef":
            if turn == "e":
                res, sec = timed(eager)
                eager_s.append(sec)
                ref = res if ref is None else ref
            else:
                fused_s.append(timed(fused)[1])
        if not bit_equal(as_tuple(out), as_tuple(ref)):
            again = eager()
            diff = max(float(torch.nan_to_num(a - b).abs().max())
                       for a, b in zip(as_tuple(out), as_tuple(ref)))
            fail(f"{what}: the replayed frame is not the eager frame's bits (max |d| {diff}); "
                 f"eager against eager: "
                 f"{'the same bits' if bit_equal(as_tuple(again), as_tuple(ref)) else 'differs'}")
        busy_ms, n_ops, own_ms, top = device_profile(fused)
        setup_s = cold_s - min(fused_s)
        row = {"path": what, "replay_s": fused_s, "eager_s": eager_s, "cold_s": cold_s,
               "setup_s": setup_s, "pool_mib": pool_mib, "busy_ms": busy_ms,
               "device_ops": n_ops, "own_ms": own_ms,
               "launches": {k: n for k, n in pinned.items() if n}}
        fused_rows.append(row)
        print(f"  {what}: launches at capture {row['launches']} (+ the warm-up's), none at a "
              f"replay; replayed == eager bit for bit; warm frame replayed "
              f"{min(fused_s):.4f} s ({', '.join(f'{s:.4f}' for s in fused_s)}), eager "
              f"{min(eager_s):.4f} s ({', '.join(f'{s:.4f}' for s in eager_s)}); first call "
              f"{cold_s:.3f} s ({setup_s:.3f} s beyond a replay: the warm-up and the capture); "
              f"graph pool {pool_mib:.1f} MiB", flush=True)
        print_profile(f"{what} replayed", min(fused_s), (busy_ms, n_ops, own_ms, top))
        if own_ms == 0:
            print(f"  {what}: the profiler shows none of the port's kernels inside the graph; "
                  f"its launches are the capture's", flush=True)
        release_graphs()

    nd_pinned = {**sor_launches(MAIN_SHAPE, p.scl_factor, 20, p.scales,
                                p.firstLoop * p.secondLoop, "llin4", 1, "flow_llin4_sor",
                                1 + 2 * p.iter, p.iter), **nd_reweights}
    t21b = time.time()
    fused_check(f"flow_nd_fused {MAIN_SHAPE}", lambda: flow_nd_fused(it0, it1),
                lambda: flow_nd(it0, it1), nd_pinned)
    fused_check(f"flow_nd_fused {LARGE_SHAPE}", lambda: flow_nd_fused(big0, big1),
                lambda: flow_nd(big0, big1),
                {**sor_launches(LARGE_SHAPE, p.scl_factor, 20, p.scales,
                                p.firstLoop * p.secondLoop, "llin4", 1, "flow_llin4_sor",
                                1 + 2 * p.iter, p.iter),
                 **model_reweights(LARGE_SHAPE, p, 20, "robust_flow")})
    fused_check(f"flow_nd_sequence 3 x {SEQ_SHAPE}", lambda: flow_nd_sequence(clip),
                lambda: tuple(torch.stack(f) for f in zip(
                    *(flow_nd(clip[t], clip[t + 1]) for t in range(clip.shape[0] - 1)))),
                {**sor_launches(SEQ_SHAPE, p.scl_factor, 20, p.scales,
                                p.firstLoop * p.secondLoop, "llin4", 1, "flow_llin4_sor",
                                1 + 2 * p.iter, p.iter),
                 **model_reweights(SEQ_SHAPE, p, 20, "robust_flow")})
    fused_check(f"disparity_nd_fused {MAIN_SHAPE}", lambda: disparity_nd_fused(il, ir),
                lambda: disparity_nd(il, ir), d_expected)
    fused_check(f"disparity_sym_fused {MAIN_SHAPE}", lambda: disparity_sym_fused(il, ir),
                lambda: disparity_sym(il, ir), s_expected)
    fused_check(f"flow_ad_fused {MAIN_SHAPE}", lambda: flow_ad_fused(it0, it1),
                lambda: flow_ad(it0, it1), ad_expected)
    fused_check(f"tv_denoise4_fused {MAIN_SHAPE}", lambda: tv_denoise4_fused(noisy),
                lambda: tv_denoise4(noisy), tv_expected)
    fused_check(f"tv_denoise8_fused {MAIN_SHAPE}", lambda: tv_denoise8_fused(noisy),
                lambda: tv_denoise8(noisy), tv8_expected)
    for name, fused_fn, eager_fn in (("gac_a", gac_a_fused, gac_a), ("gac_b", gac_b_fused, gac_b)):
        fused_check(f"{name}_fused {tuple(gimg.shape)}", lambda: fused_fn(gimg, phi0_d),
                    lambda: eager_fn(gimg, phi0_d), {"tridiag_thomas": 2 * gp.ITER})
    for solver in (2, 1):
        fp_s = FlowFMGParams(solver=solver)
        fused_check(f"flow_fmg_fused {MAIN_SHAPE} solver={solver}",
                    lambda: flow_fmg_fused(f0, f1, fp_s), lambda: flow_fmg(f0, f1, fp_s),
                    fmg_expected(MAIN_SHAPE, solver, 1, fp_))
    print(f"  fused frames: {time.time() - t21b:.1f} s; phase 21 {time.time() - t21:.1f} s",
          flush=True)
    print("fused frames " + json.dumps(fused_rows), flush=True)

    rw_rows = reweight_phase(args.seed)

    sources = {"flow_llin4_sor": ("pde_tpu_torch/csrc/flow_llin4_sor.cu",
                                  "pde_tpu/kernels/sor_pallas.py:71"),
               "disp_llin4_sor": ("pde_tpu_torch/csrc/interior_sor.cu",
                                  "pde_tpu/kernels/sweeps.py:145"),
               "pde4_sor": ("pde_tpu_torch/csrc/interior_sor.cu",
                            "pde_tpu/kernels/sweeps.py:174"),
               "flow_elin4_sor": ("pde_tpu_torch/csrc/flow_llin4_sor.cu",
                                  "pde_tpu/kernels/sweeps.py:234"),
               "flow_llin8_sor": ("pde_tpu_torch/csrc/flow_llin4_sor.cu",
                                  "pde_tpu/kernels/sweeps.py:107"),
               "pde8_sor": ("pde_tpu_torch/csrc/interior_sor.cu",
                            "pde_tpu/kernels/sweeps.py:204"),
               "resident_flow_llin4": ("pde_tpu_torch/csrc/resident_sor.cu",
                                       "pde_tpu/kernels/sor_pallas.py:71"),
               "resident_disp_llin4": ("pde_tpu_torch/csrc/resident_sor.cu",
                                       "pde_tpu/kernels/tiled.py:113"),
               "resident_pde4": ("pde_tpu_torch/csrc/resident_sor.cu",
                                 "pde_tpu/kernels/sweeps.py:174"),
               "resident_flow_elin4": ("pde_tpu_torch/csrc/resident_sor.cu",
                                       "pde_tpu/kernels/sweeps.py:234"),
               # _stripe_kernel (tiled.py:113) driving these sweeps
               "resident_flow_llin8": ("pde_tpu_torch/csrc/resident8_sor.cu",
                                       "pde_tpu/kernels/sweeps.py:107"),
               "resident_pde8": ("pde_tpu_torch/csrc/resident8_sor.cu",
                                 "pde_tpu/kernels/sweeps.py:204"),
               "tridiag": ("pde_tpu_torch/csrc/tridiag.cu",
                           "pde_tpu/kernels/tdma_pallas.py:82"),
               # its global-rows variant: lines longer than the staged one holds
               "tridiag_long": ("pde_tpu_torch/csrc/tridiag.cu",
                                "pde_tpu/kernels/tdma_pallas.py:82"),
               # the same whole solve, launched by the segmentation's AOS steps
               "tridiag_seg": ("pde_tpu_torch/csrc/tridiag.cu",
                               "pde_tpu/kernels/tdma_pallas.py:82"),
               # the preconditioner's pass around the same Pallas solve
               "tridiag_zebra_pass": ("pde_tpu_torch/csrc/tridiag.cu",
                                      "pde_tpu/kernels/tdma_pallas.py:82"),
               **{name: ("pde_tpu_torch/csrc/tiled_sor.cu",
                         "pde_tpu/kernels/tiled.py:" + ("172" if db else "113"))
                  for name, (_, db) in (TILED | TILED_WIN).items()},
               # _stripe_kernel (tiled.py:113) driving the disp, pde4, llin8
               # and pde8 sweeps, and _stripe_kernel_db (tiled.py:172)
               **{name: ("pde_tpu_torch/csrc/tiled_sor.cu", "pde_tpu/kernels/tiled.py:113")
                  for name in (*TILED_NEW, *TILED_WIN_NEW)},
               **{name: ("pde_tpu_torch/csrc/tiled_sor.cu", "pde_tpu/kernels/tiled.py:172")
                  for name in TILED_NEW_DB}}
    th, tw = TIME_SHAPES[0]
    # the tridiagonal solve is reported whole, the fused pass coupled, along
    # axis -2; a resident kernel without a plan at th x tw (pde8 and pde4 with
    # C = 3) at the main path's finest level
    key = {name: ((name, -2, th, tw) if name.startswith("tridiag") else (name, th, tw))
           for name in sources}
    key["tridiag_long"] = ("tridiag_long", LONG_TIME[1], *LONG_TIME[0])
    key["tridiag_seg"] = ("tridiag_seg",)
    key.update({name: (name, "win") for name in (*TILED_WIN, *TILED_WIN_NEW)})
    # the double-buffered forms of the other families: 1024x1024 and the shard
    key.update({name: (name, "win") if "_win" in name else (name, *TIME_SHAPES[-1])
                for name in TILED_NEW_DB})
    for name in AT_MAIN:
        if key[name] not in times:
            key[name] = (name, *MAIN_SHAPE[1:])
    report = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": src,
        "replaces": replaces,
        "launches": main_launches[name],
        "max_abs_err": max_err[name],
        "ms": times[key[name]][0],
        "plain_ms": times[key[name]][1],
        "bound_ms": bounds[key[name]][0],
        "bound_by": bounds[key[name]][1],
        # no single PyTorch call computes a red-black SOR sweep or a batched
        # tridiagonal solve
        "library_ms": None,
    } for name, (src, replaces) in sources.items()]}
    # the reweighting kernels: the main path's launches (phases 4 and 6: flow_nd
    # and disparity_nd at MAIN_SHAPE), phase 22's readings at the cells'
    # finest levels; the TPU package runs these chains as XLA fusions
    for name, case, launches, replaces in (
            ("reweight_flow_kernel", "robust_flow", nd_reweights["robust_flow"],
             "pde_tpu/models/flow_nd.py:118"),
            ("reweight_disp_kernel", "robust_disp", d_reweights["robust_disp"],
             "pde_tpu/models/disparity.py:100"),
            ("weights4_kernel", "weights4_flow",
             nd_reweights["weights4"] + d_reweights["weights4"], "pde_tpu/ops/weights.py:63")):
        row = rw_rows[case]
        report["kernels"].append({
            "name": name, "route": "cuda", "source": "pde_tpu_torch/csrc/reweight.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": row["max_abs_err"],
            "ms": row["device_ms"], "plain_ms": row["plain_device_ms"],
            "bound_ms": row["bound_ms"], "bound_by": "bytes", "library_ms": None})
    print(f"total {time.time() - t_start:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
