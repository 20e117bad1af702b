"""The card's published peaks and the least time of a frame's SOR solves.

A roofline counts the algorithm's bytes, not an implementation's: each
input plane of a solver call read once and each output plane written once,
float32, whatever kernel runs the call and however often it rereads a
plane (halos, sweeps). The SOR families' planes:

- llin4 (late-linearisation flow): U, V, dU, dV, M, Cu, Cv, Du, Dv and 4
  weights read, dU, dV written: 15 planes, 60 B a pixel;
- elin4: U, V, M, Cu, Cv, Du, Dv and 4 weights read, U, V written: 52 B;
- llin8: as llin4 with 8 weights: 76 B;
- disp (disparity llin4): U, dU, Cu, Du and 4 weights read, dU written: 36 B;
- pde4 / pde8 over C channels: X, TRACE, B a channel and 4 / 8 shared
  weights read, X a channel written.

A frame's pyramid is the reference's (``reference/plain.pyramid_scales``):
shrink by the scale factor (ceil) until a side is at most the
configuration's ``pyramid_stop``.
"""

from __future__ import annotations

from bench_gpu.reference.plain import pyramid_scales

# NVIDIA H100 SXM5 data sheet: HBM3 bandwidth (float32 outside the tensor
# cores, 67 TFLOP/s, bounds the SOR calls far less: ~40 operations a pixel
# and sweep against 36-76 bytes a pixel and call)
HBM_BYTES_PER_S = 3.35e12


def sor_bytes_per_px(family: str, channels: int = 1) -> int:
    """Bytes a pixel of one solver call reads and writes, each plane once."""
    planes = {"llin4": 15, "elin4": 13, "llin8": 19, "disp": 9}
    if family in planes:
        return 4 * planes[family] * channels
    weights = {"pde4": 4, "pde8": 8}[family]
    return 4 * (4 * channels + weights)


def sor_calls_per_level(config: dict) -> int:
    """Solver calls a pyramid level: the product of the loop counts the
    configuration's ``sor.calls_per_level`` names."""
    n = 1
    for key in config["sor"]["calls_per_level"]:
        n *= int(config["params"][key])
    return n


def sor_frame_bytes(config: dict, frame=None) -> int:
    """Bytes the SOR calls of one frame of ``config`` read and write."""
    _, h, w = frame or config["frame"]
    sor = config["sor"]
    levels = pyramid_scales(h, w, config["params"]["scl_factor"], int(config["pyramid_stop"]),
                            config["params"].get("scales", 10**9))
    per_px = sor_bytes_per_px(sor["family"], sor.get("channels", 1))
    return sor_calls_per_level(config) * per_px * sum(lh * lw for lh, lw in levels)


def sor_least_ms(config: dict, frame=None) -> float:
    """The least device ms one frame's SOR calls could take: their bytes
    over the card's HBM bandwidth."""
    return sor_frame_bytes(config, frame) / HBM_BYTES_PER_S * 1e3
