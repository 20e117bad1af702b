"""Tests of the benchmark harness. Run from the repository's root:

    python -m pytest bench_gpu/tests -q

Tests marked ``card`` need a CUDA card; each decides inside itself whether
torch sees one and skips where it does not. On the card:

    python -m pytest bench_gpu/tests -q -m card
"""

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

torch.set_num_threads(2)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips where torch sees none")
