"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface, for ``sm_90a`` (Hopper), into ``pde_tpu_torch/_build/``. The
library's name carries a hash of the source, of every header it includes
with quotes (``#include "x.cuh"``, found beside the file that includes it)
and of the flags, so an edited source or header is rebuilt and a stale
library is never loaded. The library is
loaded with ``ctypes``. Nothing here runs at import time; a missing
``nvcc`` raises. ``utils/observe.py`` counts the ``nvcc`` runs
(``kernels.built``) and the libraries loaded (``kernels.loaded``) and
times both (the spans ``kernels.build`` and ``kernels.load``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

from pde_tpu_torch.utils import observe

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def find_nvcc() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME/bin`` (default
    ``/usr/local/cuda``). Raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin: "
                       "the CUDA kernels cannot be built")


_QUOTED_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def _with_headers(path: Path) -> list[Path]:
    """``path`` and the headers it includes with quotes, recursively, each
    once, in the order they are first included."""
    files, todo = [], [path]
    while todo:
        f = todo.pop(0)
        if f in files:
            continue
        files.append(f)
        todo += [f.parent / inc.decode() for inc in _QUOTED_INCLUDE.findall(f.read_bytes())]
    return files


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    digest = hashlib.sha256()
    for f in _with_headers(CSRC / f"{name}.cu"):
        digest.update(f.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(name: str, verbose: bool = False, force: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` unless the library for its current hash
    exists (or ``force``); returns the library's path. ``verbose`` adds
    ``-Xptxas -v`` and prints the compiler's report (registers, spills)."""
    with observe.timed("kernels.build"):
        out = library_path(name)
        if out.exists() and not force:
            return out
        observe.count("kernels.built")
        _compile(name, out, verbose)
    return out


def _compile(name: str, out: Path, verbose: bool) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent process never
    # sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, str(CSRC / f"{name}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {name}.cu:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        if verbose:
            print(proc.stdout + proc.stderr, flush=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; one handle per process."""
    path = build(name)
    with observe.timed("kernels.load"):
        observe.count("kernels.loaded")
        return ctypes.CDLL(str(path))
