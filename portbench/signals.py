"""The inputs of the traffic: speech-like clips and the streams per step.

- :func:`speech_like` is ``chip_smoke.py``'s generator (harmonics of a
  gliding pitch under a syllable-rate envelope, plus noise), made for many
  clips at once with a ``torch.Generator`` on the device;
- :func:`dropout_streams` is a frozen copy of the quantization-dropout
  rule (reference scripts/utils.py:11-25; ``esc_tpu_torch/train/data.py::
  quantization_dropout``): with probability ``rate`` a stream count drawn
  uniformly from 1 to ``max_streams``, else all of them.

Both draw only from the seed they are given, so one seed gives the same
traffic in every run on one kind of device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["speech_like", "dropout_streams"]

SR = 16000


def speech_like(gen: torch.Generator, n: int, length: int,
                device) -> torch.Tensor:
    """``n`` clips of ``length`` samples, float32 ``(n, length)`` on
    ``device``: a pitch drawn from 90-250 Hz gliding by 5 %, eight
    harmonics at 1/k with random phases, an envelope at 2.5 Hz, and noise
    at 0.005."""
    def uniform(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen,
                                           device=device)

    f0 = uniform(n, 1, lo=90.0, hi=250.0)
    t = torch.arange(length, device=device, dtype=torch.float32)[None] / SR
    phase = 2 * math.pi * f0 * (t + 0.05 * torch.sin(2 * math.pi * 0.7 * t))
    offsets = uniform(n, 8, hi=2 * math.pi)
    x = torch.zeros(n, length, device=device)
    for k in range(1, 9):
        x += torch.sin(k * phase + offsets[:, k - 1:k]) / k
    env_phase = uniform(n, 1, hi=3.0)
    env = 0.25 + 0.75 * torch.sin(2 * math.pi * 2.5 * t + env_phase) ** 2
    noise = torch.randn(n, length, generator=gen, device=device)
    return 0.12 * env * x + 0.005 * noise


def dropout_streams(rate: float, max_streams: int, n: int,
                    seed: int) -> list:
    """``n`` stream counts by the quantization-dropout rule."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if rng.random() < rate:
            out.append(int(rng.integers(1, max_streams + 1)))
        else:
            out.append(max_streams)
    return out
