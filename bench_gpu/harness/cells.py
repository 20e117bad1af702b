"""A cell of ``BENCHMARK.json``, resolved from its files by name.

- A cell (an entry of ``workloads``) names a configuration and a traffic mix.
- The configuration's file is the one its entry of ``configs`` names
  (``bench_gpu/configs/<name>.json``): the entry points, their parameters,
  the frame, the synthetic scene, the pyramid, the SOR family, the name of
  its plain reference and the comparison's limits.
- The plain reference is ``bench_gpu/reference/<reference>.py``, a module
  with ``fields(first, second, config, device, precision) -> tuple``.
- The traffic mix is ``bench_gpu/traffic/<traffic>.json``, the parameters
  of the loop it names: ``bench_gpu/loops/<loop>.py``, a module with
  ``run(window) -> Outcome`` (``session.py``).
- A metric's reader is ``bench_gpu/metrics/<metric name>.py``, a module
  with ``read(run) -> float | None``.

A later cell, configuration, traffic mix, loop or metric is new files and
new entries; nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload with its configuration, traffic and the metrics it reports."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple
    per_layer: tuple
    root: Path = ROOT


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def resolve(bench: dict, workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``bench`` with its files read from ``root``."""
    entry = _by_name(bench["workloads"], workload, "workload")
    config_entry = _by_name(bench["configs"], entry["config"], "config")
    with open(root / config_entry["file"]) as f:
        config = json.load(f)
    with open(root / BENCH_DIR.name / "traffic" / f"{entry['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(
        name=workload,
        chips=int(entry["chips"]),
        config=config,
        traffic=traffic,
        end_to_end=tuple(m for m in bench["end_to_end"] if _reports(m, workload)),
        per_layer=tuple(m for m in bench["per_layer"] if _reports(m, workload)),
        root=root,
    )


def find(kind: str, name: str, root: Path = ROOT):
    """The module ``bench_gpu/<kind>/<name>.py`` of ``root``, loaded by path."""
    path = root / BENCH_DIR.name / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_gpu_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``bench_gpu/metrics/<name>.py``."""
    return find("metrics", name, root).read
