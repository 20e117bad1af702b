#!/usr/bin/env python3
"""Where a serial launch of the tile kernel (``pde_tpu_torch/csrc/tiled_sor.cu``,
``tiled_family_kernel``) spends its cycles, on one CUDA card.

    python3 scripts/tiled_phase_clocks.py [--root DIR] [--families F ...]
        [--shape H W] [--batch B] [--plan TILE_H TILE_W PAIRS] [--out FILE]

Builds a copy of the checkout's ``tiled_sor.cu`` (``--root``, default this
one) with ``clock()`` reads at the serial kernel's phase boundaries: the
neighbour planes' copy issue, the coefficient loads and prepare, the wait
for the copies and the barrier before the sweeps (with whatever the kernel
does between them), each colour phase, each barrier after a phase, and the
store. Lane 0 of every warp adds its cycles to counters in device memory,
so the split printed is the mean over the warps of one 4-sweep call at the
family's default plan (``kernels/tiled.plan_tiles``; ``--plan`` another
tile and pairs a thread, for every family asked). The copy is built for
each family with the kernel's launch bounds set to the plan's threads and
the blocks an SM the family's own kernel holds (from its registers), so
that it runs as many blocks an SM as the kernel does (both occupancies
printed: two blocks sharing an SM stretch each warp's cycles). It also
prints, from
uninstrumented builds of the same source, the compiler's registers and
spills for each family's kernels and, from the SASS (``cuobjdump -sass``),
the shared loads and stores, integer and float instructions of the serial
kernel at the plan's pairs a thread, in all and between the clock reads
around the colour phases (both colours' bodies, so half is one phase;
where the kernel has a path for pixels with an edge bit, also with that
path taken out: what an interior pixel runs). The library the package
loads is never touched: everything is built in a temporary directory. An
anchor missing from the source fails the script.
Exits non-zero without a CUDA card; prints the card's name and power limit
first and, last, one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
FAMILIES = ("flow_llin8", "disp_llin4")
# (anchor, replacement) of the serial kernel's body and of sweep_family;
# each anchor must occur in the source exactly once
PROBES = [
    ("namespace {\n",
     "__device__ unsigned long long tiled_clocks[16];\nnamespace {\n"),
    ("    copy_family<F>(smem, sys, sb, b, g, pos);\n    __pipeline_commit();\n",
     "    const unsigned t0 = clock();\n"
     "    copy_family<F>(smem, sys, sb, b, g, pos);\n    __pipeline_commit();\n"
     "    const unsigned t1 = clock();\n"),
    ("    load_family<F>(sys, sb, b, g, pos, px, word);\n    __pipeline_wait_prior(0);\n",
     "    load_family<F>(sys, sb, b, g, pos, px, word);\n    const unsigned t2 = clock();\n"
     "    __pipeline_wait_prior(0);\n"),
    ("    __syncthreads();\n    sweep_family<F",
     "    __syncthreads();\n    const unsigned t3 = clock();\n    sweep_family<F"),
    ("    store_family<F>(sys, sb, smem, b, g, word);\n",
     "    const unsigned t4 = clock();\n"
     "    store_family<F>(sys, sb, smem, b, g, word);\n"
     "    const unsigned t5 = clock();\n"
     "    if ((threadIdx.x & 31) == 0) {\n"
     "      atomicAdd(tiled_clocks + 0, (unsigned long long)(t1 - t0));\n"
     "      atomicAdd(tiled_clocks + 1, (unsigned long long)(t2 - t1));\n"
     "      atomicAdd(tiled_clocks + 2, (unsigned long long)(t3 - t2));\n"
     "      atomicAdd(tiled_clocks + 5, (unsigned long long)(t5 - t4));\n"
     "      atomicAdd(tiled_clocks + 6, (unsigned long long)(t5 - t0));\n"
     "      atomicAdd(tiled_clocks + 7, 1ull);\n"
     "    }\n"),
    ("  const int par = (g.r0 + g.c0 + b.gr0 + b.gc0) & 1;  // the image colour of local colour 0\n",
     "  const int par = (g.r0 + g.c0 + b.gr0 + b.gc0) & 1;  // the image colour of local colour 0\n"
     "  unsigned c_phase = 0, c_bar = 0;\n"),
    ("      if ((color ^ par) == 0)\n        family_phase<",
     "      const unsigned ca = clock();\n      if ((color ^ par) == 0)\n        family_phase<"),
    ("one_minus_omega);\n      __syncthreads();\n    }\n  }\n}\n\n"
     "// This thread's pixels of the tile's interior, from the slot, to the\n// box-sized",
     "one_minus_omega);\n      const unsigned cb = clock();\n      __syncthreads();\n"
     "      c_bar += clock() - cb;\n      c_phase += cb - ca;\n    }\n  }\n"
     "  if ((threadIdx.x & 31) == 0) {\n"
     "    atomicAdd(tiled_clocks + 3, (unsigned long long)c_phase);\n"
     "    atomicAdd(tiled_clocks + 4, (unsigned long long)c_bar);\n"
     "  }\n}\n\n"
     "// This thread's pixels of the tile's interior, from the slot, to the\n// box-sized"),
]
NAMES = ("copy issue", "coefficient loads and prepare", "wait, fill and barrier",
         "colour phases", "barriers after the phases", "store", "total")
# the kernels' family indices (kernels/tiled.LAYOUTS)
INDEX = {"flow_llin4": 0, "flow_elin4": 1, "disp_llin4": 2, "pde4": 3, "flow_llin8": 4,
         "pde8": 5}
KERNEL = re.compile(r"tiled_family_kernelILi(\d)ELi(\d)ELb([01])ELi(\d)EE")
INT_OPS = ("IMAD", "IADD3", "IADD", "LEA", "LOP3", "ISETP", "SEL", "SHF", "IMNMX", "VIMNMX",
           "PRMT", "IABS", "SGXT", "BMSK", "LOP", "ISCADD", "IMUL", "SHL", "SHR", "MOV", "P2R",
           "R2P", "PLOP3", "FLO", "POPC", "BREV", "I2F", "F2I", "UIADD3", "UIMAD", "ULOP3",
           "USHF", "ULEA", "USEL", "UISETP", "UMOV", "S2R", "S2UR", "CS2R", "VOTE")
FLOAT_OPS = ("FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "MUFU", "FCHK", "FSET")


def instrumented(src: str) -> str:
    for anchor, probe in PROBES:
        if src.count(anchor) != 1:
            sys.exit(f"tiled_sor.cu has changed: this anchor occurs {src.count(anchor)} times:\n"
                     f"{anchor}")
        src = src.replace(anchor, probe, 1)
    cases = "".join(f"    case {f * 10 + n}: return q(tiled_family_kernel<{f}, 1, false, {n}>);\n"
                    for f in (2, 4) for n in (1, 2, 3, 4))
    return src + ('extern "C" int tiled_read_clocks(unsigned long long* h) {\n'
                  "  return (int)cudaMemcpyFromSymbol(h, tiled_clocks, sizeof(tiled_clocks));\n"
                  "}\n"
                  'extern "C" int tiled_reset_clocks() {\n'
                  "  unsigned long long z[16] = {0};\n"
                  "  return (int)cudaMemcpyToSymbol(tiled_clocks, z, sizeof(z));\n"
                  "}\n"
                  "// blocks an SM of the instrumented serial kernel of disp (2) or\n"
                  "// llin8 (4) at `slots` pairs\n"
                  'extern "C" int tiled_clock_occupancy(int family, int slots, int threads, '
                  "int smem, int* blocks) {\n"
                  "  auto q = [&](auto kernel) {\n"
                  "    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, "
                  "smem);\n"
                  "    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, "
                  "threads, smem);\n"
                  "  };\n"
                  "  switch (family * 10 + slots) {\n" + cases + "  }\n"
                  "  return -1;\n"
                  "}\n")


def nvcc(build, args, cwd):
    proc = subprocess.run([build.find_nvcc(), *args], capture_output=True, text=True, cwd=cwd)
    if proc.returncode != 0:
        sys.exit(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout + proc.stderr


def registers(report: str) -> dict:
    """(family, channels, double-buffered, pairs a thread) -> (registers,
    spill stores bytes, spill loads bytes, stack bytes), from ptxas -v."""
    out, key = {}, None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line) or re.search(
            r"Compiling entry function '(\S+)'", line)
        if m:
            k = KERNEL.search(m.group(1))
            key = tuple(int(x) for x in k.groups()) if k else None
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m:
            out.setdefault(key, {}).update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(key, {})["registers"] = int(m.group(1))
    return out


def sass_functions(cuobjdump: str, cubin: Path) -> dict:
    """Each tiled_family_kernel's SASS opcodes, in address order."""
    text = subprocess.run([cuobjdump, "-sass", str(cubin)], capture_output=True, text=True,
                          check=True).stdout
    funcs, key = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = KERNEL.search(m.group(1))
            key = tuple(int(x) for x in k.groups()) if k else None
            if key:
                funcs[key] = []
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(\.[\w.]*)?\s*(.*)",
                     line)
        if key and m:
            funcs[key].append((m.group(1), (m.group(2) or "") + " " + m.group(3)))
    return funcs


def classify(ops) -> dict:
    c = Counter()
    for op, rest in ops:
        if op in ("LDS", "LDSM"):
            c["shared loads"] += 1
        elif op == "STS":
            c["shared stores"] += 1
        elif op == "LDGSTS":
            c["cp.async"] += 1
        elif op in ("LDG", "LD"):
            c["global loads"] += 1
        elif op in ("STG", "ST"):
            c["global stores"] += 1
        elif op == "BAR":
            c["barriers"] += 1
        elif op in INT_OPS:
            c["integer"] += 1
        elif op in FLOAT_OPS:
            c["float"] += 1
        elif op in ("BRA", "BSSY", "BSYNC", "EXIT", "RET", "CALL", "WARPSYNC", "NOP", "YIELD"):
            c["control"] += 1
        else:
            c["other"] += 1
        c["all"] += 1
    return dict(c)


def phase_region(ops) -> dict:
    """The instructions between the clock reads around the colour phases:
    the region between two reads of SR_CLOCKLO with the most shared
    loads."""
    marks = [i for i, (op, rest) in enumerate(ops) if "SR_CLOCKLO" in rest]
    best = {}
    for a, b in zip(marks, marks[1:]):
        c = classify(ops[a + 1:b])
        if c.get("shared loads", 0) > best.get("shared loads", -1):
            best = c
    return best


def held(src: str, index: int, threads: int, blocks: int) -> str:
    """``src`` with tiled_family_kernel's launch bounds, for family
    ``index``, at ``threads`` a block and ``blocks`` an SM."""
    end = src.index("\n    tiled_family_kernel(")
    start = src.rindex("__launch_bounds__(", 0, end)
    args = src[start + len("__launch_bounds__("):end].rstrip()[:-1]
    depth = 0
    for i, ch in enumerate(args):
        depth += (ch == "(") - (ch == ")")
        if ch == "," and depth == 0:
            break
    bound_t, bound_b = args[:i].strip(), args[i + 1:].strip()
    return (src[:start] + f"__launch_bounds__(kFam == {index} ? {threads} : ({bound_t}), "
            f"kFam == {index} ? {blocks} : ({bound_b}))" + src[end:])


def occupancy(regs: int, threads: int, smem: int) -> int:
    """Blocks an SM of a kernel of ``regs`` registers a thread (allocated
    in steps of 8), ``threads`` a block and ``smem`` bytes of dynamic shared
    memory (1 KB more reserved a block) on an H100."""
    warps = -(-threads // 32)
    by_regs = 65536 // (warps * 32 * (-(-regs // 8) * 8))
    return min(32, 2048 // (warps * 32), by_regs, 233472 // (smem + 1024))


# the test that sends a pixel without an edge bit to the fixed-offset path,
# made always true for the interior pixels' SASS (absent from a kernel that
# has one path)
INTERIOR_TEST = "      if (kFast && !(bits & kEdges))\n"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE.parent,
                    help="the checkout whose tiled_sor.cu and package to measure")
    ap.add_argument("--families", nargs="+", default=list(FAMILIES), choices=list(INDEX)[2:])
    ap.add_argument("--shape", type=int, nargs=2, default=(1024, 1024), metavar=("H", "W"))
    ap.add_argument("--batch", type=int, default=1, help="disp systems, pde channels")
    ap.add_argument("--plan", type=int, nargs=3, metavar=("TILE_H", "TILE_W", "PAIRS"),
                    help="time this tile and pairs a thread in place of the default plan")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA card: the tile kernel runs only on the card")
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    sys.path.insert(1, str(HERE))
    from pde_tpu_torch.kernels import build, tiled, tiled_cuda
    from tiled_plan_sweep import device_ms, make_fields

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    csrc = root / "pde_tpu_torch" / "csrc"
    tmp = Path(tempfile.mkdtemp())
    for f in csrc.glob("*.cuh"):
        shutil.copy(f, tmp / f.name)
    src = (csrc / "tiled_sor.cu").read_text()
    clocks = instrumented(src)
    (tmp / "plain.cu").write_text(src)
    (tmp / "clocks.cu").write_text(clocks)
    arch = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
    report = nvcc(build, [*arch, "-cubin", "-Xptxas", "-v", "-o", "plain.cubin", "plain.cu"], tmp)
    nvcc(build, [*arch, "-cubin", "-o", "clocks.cubin", "clocks.cu"], tmp)
    regs = registers(report)
    cuobjdump = str(Path(build.find_nvcc()).parent / "cuobjdump")
    plain_sass = sass_functions(cuobjdump, tmp / "plain.cubin")
    clock_sass = sass_functions(cuobjdump, tmp / "clocks.cubin")
    interior_sass = {}
    if clocks.count(INTERIOR_TEST) == 1:
        (tmp / "interior.cu").write_text(clocks.replace(INTERIOR_TEST, "      if (true)\n"))
        nvcc(build, [*arch, "-cubin", "-o", "interior.cubin", "interior.cu"], tmp)
        interior_sass = sass_functions(cuobjdump, tmp / "interior.cubin")

    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(args.seed)
    h, w = args.shape
    results = []
    for family in args.families:
        batch = min(args.batch, tiled.LAYOUTS[family].max_batch)
        plan = (tiled.make_plan(h, w, family, 4, *args.plan, batch=batch) if args.plan
                else tiled.plan_tiles(h, w, family, 4, 4, sm_count=sms, batch=batch))
        channels = batch if tiled.LAYOUTS[family].block_batch else 1
        keys = {db: (INDEX[family], channels, db, plan.slots) for db in (0, 1)}
        own = occupancy(regs[keys[0]]["registers"], plan.threads, plan.smem_bytes)
        # the instrumented library, held to the family's kernel's blocks an SM
        name = f"clocks_{family}"
        (tmp / f"{name}.cu").write_text(held(clocks, INDEX[family], plan.threads, own))
        clk_regs = registers(nvcc(build, [*build.NVCC_FLAGS, "-Xptxas", "-v", "-o", f"{name}.so",
                                          f"{name}.cu"], tmp)).get(keys[0])
        lib_path = tmp / f"{name}.so"
        lib = ctypes.CDLL(str(lib_path))
        build.load = lambda name: lib  # the wrapper's bindings, on the instrumented library
        tiled_cuda._lib.cache_clear()
        tiled_cuda._lib()
        lib.tiled_read_clocks.argtypes = [ctypes.c_void_p]
        blocks = ctypes.c_int(0)
        lib.tiled_clock_occupancy(INDEX[family], plan.slots, plan.threads, plan.smem_bytes,
                                  ctypes.byref(blocks))
        tf = make_fields(rng, family, h, w, dev, False, batch, shared=False)

        def run():
            return tiled_cuda.tiled_sor(family, tf, 4, 1.9, 4, plan.tile_h, plan.tile_w, False,
                                        plan.slots)

        ms = device_ms(run)
        lib.tiled_reset_clocks()
        run()
        torch.cuda.synchronize()
        cycles = (ctypes.c_ulonglong * 16)()
        lib.tiled_read_clocks(cycles)
        warps = max(cycles[7], 1)
        split = {n: cycles[i] / warps for i, n in enumerate(NAMES)}
        row = {"family": family, "shape": [h, w], "batch": batch,
               "plan": [plan.tile_h, plan.tile_w, plan.slots, plan.threads],
               "tiles": plan.n_tiles_h * plan.n_tiles_w, "warps": cycles[7],
               "blocks_an_sm": {"kernel": own, "instrumented": blocks.value},
               "instrumented_compiler": clk_regs,
               "instrumented_device_ms": ms, "cycles_a_warp": split,
               "compiler": {("double-buffered" if db else "serial"): regs.get(k)
                            for db, k in keys.items()},
               "compiler_all_pairs": {f"{'db' if k[2] else 'serial'} {k[3]} pairs": v
                                      for k, v in sorted(regs.items())
                                      if k[0] == INDEX[family] and k[1] == channels},
               "sass_serial_kernel": classify(plain_sass.get(keys[0], [])),
               "sass_both_colour_phases": phase_region(clock_sass.get(keys[0], [])),
               "sass_both_colour_phases_interior": phase_region(
                   interior_sass.get(keys[0], [])) if interior_sass else None}
        results.append(row)
        print(f"{family} {h}x{w} B={batch} plan {plan.tile_h}x{plan.tile_w} at {plan.slots} "
              f"pairs, {plan.threads} threads, {row['tiles']} tiles; blocks an SM "
              f"{row['blocks_an_sm']}; instrumented ({clk_regs}) 4-sweep call "
              f"{ms:.4f} device ms; cycles a warp: "
              + ", ".join(f"{n} {v:.0f}" for n, v in split.items()), flush=True)
        print(f"  compiler: {row['compiler']}; every pairs a thread: "
              f"{row['compiler_all_pairs']}", flush=True)
        print(f"  SASS, the serial kernel: {row['sass_serial_kernel']}", flush=True)
        print(f"  SASS, both colour phases' bodies: {row['sass_both_colour_phases']}; "
              f"without the edge path: {row['sass_both_colour_phases_interior']}", flush=True)
    report = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "root": str(root),
              "results": results}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report))
    print(smi, flush=True)
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
