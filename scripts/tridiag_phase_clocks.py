#!/usr/bin/env python3
"""Where a launch of the tridiagonal kernel (``pde_tpu_torch/csrc/tridiag.cu``)
spends its cycles, on one CUDA card.

    python3 scripts/tridiag_phase_clocks.py

Builds a copy of the source with ``clock64()`` reads at its phase
boundaries (the copy warps' prologue, waits and copies; the walking warp's
barrier waits, forward walk, backward walk and copy-out) and prints, for
the first block's first walking thread and first copy thread, the cycles
of each phase for a zebra parity solve, the coupled fused zebra pass and a
whole solve at 481x641 along both axes with the default plan. The source in
the repository is not changed; an anchor that is no longer in it fails the
script. Exits non-zero without a CUDA card; prints the card's name and
power limit first.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SHAPE = (481, 641)
# (anchor in the source, what replaces it): the counters are per thread;
# block (0, 0)'s thread 0 (walker) and 32 (first copier) store theirs
PROBES = [
    ("namespace {\n", "__device__ long long phase_cycles[16];\nnamespace {\n"),
    ("  if (!walker)\n    for (int ch = 0; ch < g.stages - 1; ++ch) issue(ch);\n",
     "  long long c0 = clock64(), c_wait = 0, c_bar = 0, c_walk = 0, c_issue = 0;\n"
     "  if (!walker)\n    for (int ch = 0; ch < g.stages - 1; ++ch) issue(ch);\n"
     "  const long long c1 = clock64();\n"),
    ("    if (!walker) wait_prior(g.stages - 2);\n    __syncthreads();\n"
     "    if (!walker) {\n      issue(ch + g.stages - 1);\n    } else if (t < n_g) {",
     "    const long long ca = clock64();\n    if (!walker) wait_prior(g.stages - 2);\n"
     "    const long long cb = clock64();\n    __syncthreads();\n"
     "    const long long cc = clock64();\n    c_wait += cb - ca;\n    c_bar += cc - cb;\n"
     "    if (!walker) {\n      issue(ch + g.stages - 1);\n      c_issue += clock64() - cc;\n"
     "    } else if (t < n_g) {"),
    ("      else walk(yes(), yes());\n    }\n",
     "      else walk(yes(), yes());\n      c_walk += clock64() - cc;\n    }\n"),
    ("  if (!walker) __pipeline_wait_prior(0);\n",
     "  const long long c2 = clock64();\n  if (!walker) __pipeline_wait_prior(0);\n"),
    ("  __syncthreads();\n\n  // the group's lines out",
     "  __syncthreads();\n  const long long c3 = clock64();\n\n  // the group's lines out"),
]
# inserted before the kernel's closing brace
STORE = """  __syncthreads();
  if (blockIdx.x == 0 && blockIdx.y == 0 && (threadIdx.x == 0 || threadIdx.x == 32)) {
    long long* p = phase_cycles + (threadIdx.x ? 8 : 0);
    p[0] = c1 - c0, p[1] = c_wait, p[2] = c_bar, p[3] = c_walk, p[4] = c_issue;
    p[5] = c3 - c2, p[6] = clock64() - c3, p[7] = n_chunks;
  }
"""
NAMES = ("prologue", "copy wait", "barrier", "walk", "copy issue", "backward", "copy-out",
         "chunks")


def instrumented_source() -> str:
    src = (ROOT / "pde_tpu_torch" / "csrc" / "tridiag.cu").read_text()
    for anchor, probe in PROBES:
        if anchor not in src:
            sys.exit(f"tridiag.cu has changed: anchor not found:\n{anchor}")
        src = src.replace(anchor, probe, 1)
    end = src.index("template <int kMode, int kR>\ncudaError_t launch_r")
    close = src.rindex("}\n", 0, end)
    src = src[:close] + STORE + src[close:]
    return src + ('extern "C" int read_phase_cycles(long long* h) {\n'
                  "  return (int)cudaMemcpyFromSymbol(h, phase_cycles, sizeof(long long) * 16);\n"
                  "}\n")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("no CUDA card: the tridiagonal kernel runs only on the card")
    from pde_tpu_torch.kernels import build, tdma_cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    tmp = Path(tempfile.mkdtemp())
    (tmp / "tridiag_clocks.cu").write_text(instrumented_source())
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(tmp / "lib.so"),
                    str(tmp / "tridiag_clocks.cu")], check=True)
    lib = ctypes.CDLL(str(tmp / "lib.so"))
    # the wrapper's bindings, on the instrumented library
    build.load = lambda name: lib
    tdma_cuda._lib.cache_clear()
    tdma_cuda._lib()
    lib.read_phase_cycles.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def field(lo, hi):
        return torch.rand(SHAPE, device=dev, generator=gen) * (hi - lo) + lo

    a, c = field(-0.5, -0.1), field(-0.5, -0.1)
    b = a.abs() + c.abs() + field(0.5, 1.5)
    d, z, z_o, m, w = field(-1, 1), field(-1, 1), field(-1, 1), field(0, 0.01), field(0.1, 1.1)
    cycles = (ctypes.c_longlong * 16)()
    for axis in (-2, -1):
        fac = tdma_cuda.tridiag_factor(a, b, c, axis)
        for case, run in (("parity solve", lambda: tdma_cuda.tridiag_solve(fac, d, 0)),
                          ("fused zebra pass, coupled",
                           lambda: tdma_cuda.zebra_pass(fac, z, d, w, w, 0, z_o, m)),
                          ("whole solve", lambda: tdma_cuda.thomas_solve(a, b, c, d, axis))):
            for _ in range(3):
                run()
            torch.cuda.synchronize()
            lib.read_phase_cycles(cycles)
            walker = ", ".join(f"{n} {cycles[k]}" for k, n in enumerate(NAMES)
                               if n not in ("copy wait", "copy issue"))
            copier = ", ".join(f"{n} {cycles[8 + k]}" for k, n in enumerate(NAMES)
                               if n in ("prologue", "copy wait", "barrier", "copy issue"))
            print(f"{SHAPE[0]}x{SHAPE[1]} axis={axis} {case}: walking thread: {walker}; "
                  f"copy thread: {copier} (cycles)", flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
