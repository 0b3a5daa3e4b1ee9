"""Windowed-sinc rational resampling as strided 1-D convolutions.

Port of ``esc_tpu/ops/resample.py``. The taps are built in float64 numpy
and rounded once to float32, as there; the device work differs only in
form:

- :func:`resample` zero-stuffs the input by ``up`` and runs one ``conv1d``
  of stride ``down`` with the lowpass taps, which is what the JAX
  package's ``conv_general_dilated(lhs_dilation=up, window_strides=down)``
  computes;
- :func:`resample_julius` (julius / audiotools semantics, the MSD's input
  pyramid) runs the bank of phase kernels as one ``conv1d`` of stride
  ``old_sr`` over the edge-padded input and interleaves the phases: the
  polyphase form.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .constants import frozen, on_device

__all__ = ["resample", "resample_kernel", "resample_julius",
           "julius_kernel"]


@functools.lru_cache(maxsize=None)
def resample_kernel(up: int, down: int, zeros: int = 24,
                    rolloff: float = 0.945) -> np.ndarray:
    """Lowpass windowed-sinc for rational resampling by up/down: cutoff at
    ``rolloff`` x the tighter Nyquist, open-ended Hann window of ``zeros``
    zero crossings a side, unit DC gain times ``up``
    (``esc_tpu/ops/resample.py:27``)."""
    fc = rolloff * 0.5 / max(up, down)
    half = int(math.ceil(zeros * max(up, down) / rolloff))
    t = np.arange(-half, half + 1, dtype=np.float64)
    h = 2.0 * fc * np.sinc(2.0 * fc * t)
    h *= np.hanning(2 * half + 1 + 2)[1:-1]
    h *= up / np.sum(h)
    return frozen(h.astype(np.float32))


@functools.lru_cache(maxsize=None)
def julius_kernel(old_sr: int, new_sr: int, zeros: int = 24,
                  rolloff: float = 0.945) -> np.ndarray:
    """julius.ResampleFrac's phase-kernel bank for gcd-reduced rates: one
    row per output phase, ``(new_sr, 2*width + old_sr)`` float32
    (``esc_tpu/ops/resample.py:79``)."""
    sr = rolloff * min(old_sr, new_sr)
    width = int(math.ceil(zeros * old_sr / sr))
    idx = np.arange(-width, width + old_sr, dtype=np.float64)
    rows = []
    for i in range(new_sr):
        t = (-i / new_sr + idx / old_sr) * sr
        t = np.clip(t, -zeros, zeros) * np.pi
        window = np.cos(t / zeros / 2) ** 2
        rows.append(np.sinc(t / np.pi) * window)
    scale = sr / old_sr
    return frozen((np.stack(rows) * scale).astype(np.float32))


def _reduced(orig_sr: int, new_sr: int):
    g = math.gcd(int(orig_sr), int(new_sr))
    return orig_sr // g, new_sr // g


def resample(x: torch.Tensor, orig_sr: int, new_sr: int, zeros: int = 24,
             rolloff: float = 0.945) -> torch.Tensor:
    """Resample ``(B, L)`` or ``(L,)`` from ``orig_sr`` to ``new_sr``;
    the output has ``ceil(L * new_sr / orig_sr)`` samples
    (``esc_tpu/ops/resample.py:46``)."""
    if orig_sr == new_sr:
        return x
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    down, up = _reduced(orig_sr, new_sr)
    h = on_device(resample_kernel, (up, down, zeros, rolloff), -1, x.device)
    half = (h.shape[0] - 1) // 2
    B, L = x.shape
    stuffed = x.new_zeros(B, 1, (L - 1) * up + 1, dtype=torch.float32)
    stuffed[:, 0, ::up] = x.float()
    y = F.conv1d(F.pad(stuffed, (half, half + down)), h[None, None],
                 stride=down)[:, 0, :-(-L * up // down)]
    return y[0] if squeeze else y


def resample_julius(x: torch.Tensor, orig_sr: int, new_sr: int,
                    zeros: int = 24, rolloff: float = 0.945
                    ) -> torch.Tensor:
    """Resample ``(B, L)`` or ``(L,)`` as julius / audiotools do: edge
    padding, ``int(L * new_sr / orig_sr)`` samples out
    (``esc_tpu/ops/resample.py:102``)."""
    if orig_sr == new_sr:
        return x
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    old, new = _reduced(orig_sr, new_sr)
    k = on_device(julius_kernel, (old, new, zeros, rolloff), -1, x.device)
    width = (k.shape[1] - old) // 2
    B, L = x.shape
    xp = F.pad(x.float()[:, None], (width, width + old), mode="replicate")
    ys = F.conv1d(xp, k[:, None], stride=old)           # (B, new, T)
    y = ys.transpose(1, 2).reshape(B, -1)[:, :int(L * new / old)]
    return y[0] if squeeze else y
