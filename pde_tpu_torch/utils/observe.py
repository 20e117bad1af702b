"""Opt-in observability hooks, ported from ``pde_tpu/utils/observe.py``.

The reference drops ``imagesc``/``drawnow`` into its hot loops
(DispSegmentation.m:395,644-645, GAC_v10a.m:117). Here, as in ``pde_tpu``:

* model-level ``collect=`` hooks: the drivers' Python loops append fields
  between steps, with no sync beyond what the caller does with them;
* ``probe(tag, value)``: hand a scalar (a residual norm, an energy, a count
  of live pixels) to the registered sinks. The port runs eagerly, so a probe
  calls the sinks at once with ``float(value)``: on a CUDA tensor that is a
  host sync, which waits for every queued kernel. Use it sparingly.

Example::

    from pde_tpu_torch.utils.observe import probe

    for i in range(iters):
        ...
        probe("residual", torch.linalg.norm(r))
"""

from __future__ import annotations

from typing import Callable

_sinks: list[Callable[[str, float], None]] = []


def add_sink(fn: Callable[[str, float], None]) -> None:
    """Register a host-side consumer for probe values (default: print)."""
    _sinks.append(fn)


def clear_sinks() -> None:
    _sinks.clear()


def probe(tag: str, value) -> None:
    """Report a scalar to the sinks now (``float(value)``: a host sync for a
    CUDA tensor)."""
    v = float(value)
    if _sinks:
        for fn in _sinks:
            fn(tag, v)
    else:
        print(f"[probe] {tag} = {v:.6g}", flush=True)
