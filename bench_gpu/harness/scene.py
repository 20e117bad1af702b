"""Synthetic frame clips with a known field, made from the seed.

A configuration's ``scene`` says what a clip of frames is:

- ``texture``: a band-limited RGB texture, the sum of ``components``
  sinusoids a channel with random directions and phases, radial
  frequencies in ``cycles_per_px`` and amplitudes falling as 1/f, mapped to
  mean 127.5 and standard deviation ``std`` and rounded to uint8 (a
  decoder's output);
- ``motion``: the field, a uniform part drawn from ``uniform`` (per axis,
  px) plus ``waves`` smooth sinusoids of amplitude up to ``wave_px`` and
  period ``wave_period_px``; ``axes`` 2 is a flow (dx, dy), 1 a horizontal
  shift alone;
- frame k of a clip samples the texture at X - k * ``sign`` * d: ``sign``
  1 moves the content by d a frame (a flow), -1 against it (a stereo
  pair's right image, whose content lies d px left of the left image's).
  A pair is a clip of two frames; in a longer clip each consecutive pair
  is taken to have the same field, exact where the motion is uniform.

The texture is evaluated analytically at both positions, so the field is
exact, and every seed makes the same sizes: only content changes, and the
solvers run fixed loop counts. The random numbers are drawn on the host
(numpy, from the seed); the images are evaluated on ``device`` and handed
over as numpy arrays.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Clip:
    """(C, H, W) uint8 frames and the field (numpy, px) that maps each
    frame onto the next as the model reports it."""

    frames: tuple
    truth: tuple


def seed_rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for ``seed`` (any whole number) and a sub-stream."""
    return np.random.default_rng([seed % 2**64, *stream])


def _texture(rng, spec, channels: int):
    """Each channel's sinusoids: (frequencies (n, 2), phases, amplitudes)."""
    n = int(spec["components"])
    f_lo, f_hi = spec["cycles_per_px"]
    out = []
    for _ in range(channels):
        f = np.exp(rng.uniform(math.log(f_lo), math.log(f_hi), n))
        theta = rng.uniform(0.0, 2 * math.pi, n)
        phase = rng.uniform(0.0, 2 * math.pi, n)
        amp = 1.0 / f
        amp = amp / math.sqrt(0.5 * float(np.sum(amp**2)))  # unit standard deviation
        out.append((np.stack([f * np.cos(theta), f * np.sin(theta)], 1), phase, amp))
    return out


def _evaluate(waves, xs, ys, std: float) -> np.ndarray:
    """The texture at positions (xs, ys), (C, H, W) uint8."""
    planes = []
    for freq, phase, amp in waves:
        acc = torch.zeros_like(xs)
        for (fx, fy), ph, a in zip(freq, phase, amp):
            acc += float(a) * torch.cos((2 * math.pi * float(fx)) * xs
                                        + (2 * math.pi * float(fy)) * ys + float(ph))
        planes.append(acc)
    img = 127.5 + std * torch.stack(planes)
    return np.ascontiguousarray(torch.round(img.clamp(0.0, 255.0)).to(torch.uint8).cpu().numpy())


def _field(rng, spec, xs, ys):
    """The motion's components (1 or 2 tensors, px) at (xs, ys)."""
    comps = []
    for lo, hi in spec["uniform"][: int(spec["axes"])]:
        d = torch.full_like(xs, float(rng.uniform(lo, hi)))
        for _ in range(int(spec["waves"])):
            period = rng.uniform(*spec["wave_period_px"])
            theta = rng.uniform(0.0, 2 * math.pi)
            amp = rng.uniform(0.0, spec["wave_px"])
            ph = rng.uniform(0.0, 2 * math.pi)
            d += amp * torch.sin((2 * math.pi / period)
                                 * (math.cos(theta) * xs + math.sin(theta) * ys) + ph)
        comps.append(d)
    return comps


def make_clip(scene: dict, shape, n_frames: int, rng, device) -> Clip:
    """A clip of ``n_frames`` frames of ``shape`` (C, H, W) from ``rng``."""
    c, h, w = shape
    ys, xs = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32), indexing="ij")
    waves = _texture(rng, scene["texture"], c)
    motion = scene["motion"]
    field = _field(rng, motion, xs, ys)
    sign = float(motion["sign"])
    dx = field[0]
    dy = field[1] if len(field) > 1 else torch.zeros_like(xs)
    std = float(scene["texture"]["std"])
    frames = tuple(_evaluate(waves, xs - k * sign * dx, ys - k * sign * dy, std)
                   for k in range(n_frames))
    # the model's field: where the next frame's content sits, as the
    # offset at which the warp samples it
    truth = tuple((sign * d).cpu().numpy() for d in field)
    return Clip(frames, truth)


def make_ring(scene: dict, shape, n: int, seed: int, device, n_frames: int = 2) -> list:
    """``n`` distinct clips of ``n_frames`` frames of ``shape`` for ``seed``."""
    return [make_clip(scene, shape, n_frames, seed_rng(seed, 1, k), device) for k in range(n)]
