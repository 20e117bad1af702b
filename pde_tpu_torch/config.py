"""Typed per-algorithm configs (the reference's ``param`` structs).

Every model has a frozen dataclass of the reference's parameter names
and tuned defaults; ``with_overrides`` applies keyword overrides and
*rejects* unknown names (the reference's ``setParameters.m`` silently
ignores them).
"""

from __future__ import annotations

import dataclasses
from typing import Any, TypeVar

T = TypeVar("T")


def with_overrides(cfg: T, **overrides: Any) -> T:
    unknown = set(overrides) - {f.name for f in dataclasses.fields(cfg)}
    if unknown:
        raise TypeError(f"unknown parameter(s) {sorted(unknown)} for {type(cfg).__name__}")
    return dataclasses.replace(cfg, **overrides)
