"""The card a run uses: its checks, its description, and the modules the
run must not have loaded."""

from __future__ import annotations

import subprocess
import sys

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "pde_tpu")


class NoCard(RuntimeError):
    """The run needs more CUDA cards than torch sees."""


def require(count: int) -> None:
    """Raise ``NoCard`` unless torch sees ``count`` CUDA cards or more."""
    if not torch.cuda.is_available():
        raise NoCard("torch sees no CUDA device: the benchmark measures the card and never "
                     "falls back to the CPU")
    if torch.cuda.device_count() < count:
        raise NoCard(f"the cell needs {count} CUDA cards; torch sees "
                     f"{torch.cuda.device_count()}")


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else f"nvidia-smi exit {out.returncode}"


def describe(count: int, memory_peak_bytes: int) -> dict:
    """The result's ``device`` entry for a run on ``count`` cards."""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": memory_peak_bytes, "power_limit": power_limit()}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))
