"""Solver-state checkpoint and resume, ported from ``pde_tpu/utils/checkpoint.py``.

The reference has no checkpointing; its warm-start inputs (``param.PHI``
re-segmentation, DispSegmentation.m:41,147-180; the RANSAC ``model_in``,
ransac.c:109-144) serve that role and are arguments throughout. This module
adds durable snapshots of solver state (level-set stacks, surface models
and the draw stream's state mid-segmentation) so long runs can resume.

Format, the same as ``pde_tpu``'s: one ``.npz`` holding the leaves of a
nested structure of dicts, lists and tuples as ``leaf_<i>`` and a JSON
``__meta__`` with their count and the structure's description, written
atomically (temporary file and rename) and readable by plain NumPy. Dicts
flatten in sorted key order and the description is written as
``jax.tree_util`` writes it, so either package reads the other's files.
Tensors are saved through the host.
"""

from __future__ import annotations

import json
import os
import tempfile
import warnings

import numpy as np
import torch


def _flatten(state):
    """(leaves, description) of a nested dict/list/tuple structure; None is an
    empty node, anything else a leaf."""
    if isinstance(state, dict):
        keys = sorted(state)
        parts = [_flatten(state[k]) for k in keys]
        desc = "{" + ", ".join(f"{k!r}: {d}" for k, (_, d) in zip(keys, parts)) + "}"
    elif isinstance(state, (list, tuple)):
        parts = [_flatten(x) for x in state]
        inner = ", ".join(d for _, d in parts)
        if isinstance(state, list):
            desc = f"[{inner}]"
        else:
            desc = f"({inner},)" if len(parts) == 1 else f"({inner})"
    elif state is None:
        return [], "None"
    else:
        return [state], "*"
    return [leaf for leaves, _ in parts for leaf in leaves], desc


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken from the iterator ``leaves``."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves) for x in like)
    if like is None:
        return None
    return next(leaves)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def save_state(path: str, state) -> None:
    """Snapshot a nested structure of arrays, tensors and scalars to ``path``
    (atomic)."""
    leaves, desc = _flatten(state)
    arrays = {f"leaf_{i}": _host(x) for i, x in enumerate(leaves)}
    meta = json.dumps({"n": len(leaves), "treedef": f"PyTreeDef({desc})"})
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=np.frombuffer(meta.encode(), dtype=np.uint8), **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_state(path: str, like):
    """Restore a structure saved by :func:`save_state`, as numpy arrays.

    ``like``: a structure of the same shape (e.g. the initial state). Its
    structure is authoritative: a checkpoint with another number of leaves
    raises ``ValueError``; one of the same arity but another description
    loads with a warning, since reordered or renamed keys would permute the
    leaves.
    """
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        leaves = [z[f"leaf_{i}"] for i in range(meta["n"])]
    want, desc = _flatten(like)
    if len(want) != len(leaves):
        raise ValueError(f"checkpoint holds {len(leaves)} leaves, expected {len(want)}")
    saved = meta.get("treedef")
    expected = f"PyTreeDef({desc})"
    if saved is not None and saved != expected:
        warnings.warn(
            "checkpoint treedef differs from the expected structure "
            f"(saved: {saved!r}; expected: {expected!r}); leaves are "
            "assigned by flatten order — verify the mapping is intended",
            stacklevel=2)
    return _unflatten(like, iter(leaves))
