"""EnCodec building blocks: streamable convolutions, the SLSTM and the
SEANet residual unit.

Port of ``esc_tpu/baselines/encodec/layers.py`` (Défossez et al. 2022, the
``encodec_24khz`` model) in the release's channels-first layout ``(B, C,
T)`` and under its module names, so that a released state dict loads as it
is: ``<m>.conv.conv.weight_v`` / ``weight_g`` / ``bias`` for a convolution,
``<m>.convtr.convtr.*`` for a transposed one, ``<m>.lstm.weight_ih_l{k}``
for the LSTM. The weight-normalised convolutions are the DAC's
(:mod:`esc_tpu_torch.baselines.dac.layers`), with torch's own weight norm.

The padding is worked out per call from the input's length, as the JAX
package works it out per trace: a causal convolution pads its whole
receptive deficit on the left and, on the right, the samples that make its
frame grid cover the whole signal; a causal transposed convolution trims
``kernel - stride`` samples from the right.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..dac.layers import WNConv1d, WNConvTranspose1d

__all__ = ["extra_padding", "pad1d", "SConv1d", "SConvTranspose1d", "SLSTM",
           "SEANetResnetBlock"]


def extra_padding(length: int, k_eff: int, stride: int,
                  padding_total: int) -> int:
    """The right padding that makes a convolution's frames cover all
    ``length`` samples (``layers.py:28-35``)."""
    n_frames = (length - k_eff + padding_total) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + (k_eff - padding_total)
    return max(0, ideal - length)


def pad1d(x: torch.Tensor, left: int, right: int,
          mode: str = "reflect") -> torch.Tensor:
    """Pad the time axis of ``(B, C, T)``. Where a reflection is asked for
    a pad of at least ``T`` samples, which torch refuses, zeros first extend
    the signal to one sample more than the pad (``layers.py:37-50``)."""
    if left == 0 and right == 0:
        return x
    T = x.shape[-1]
    if mode == "reflect" and max(left, right) >= T:
        x = F.pad(x, (0, max(left, right) - T + 1))
    return F.pad(x, (left, right), mode=mode)


class NormConv1d(nn.Module):
    """The release's wrapper of a weight-normalised ``Conv1d``, ``.conv``."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1):
        super().__init__()
        self.conv = WNConv1d(in_ch, out_ch, kernel_size, stride, dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class NormConvTranspose1d(nn.Module):
    """The release's wrapper of a weight-normalised ``ConvTranspose1d``,
    ``.convtr``."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1):
        super().__init__()
        self.convtr = WNConvTranspose1d(in_ch, out_ch, kernel_size, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.convtr(x)


class SConv1d(nn.Module):
    """Streamable weight-normalised ``Conv1d``: ``causal`` puts the whole
    ``padding_total`` on the left, else it is split with the odd sample and
    the extra on the right (``layers.py:53-84``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, causal: bool = True,
                 pad_mode: str = "reflect"):
        super().__init__()
        self.conv = NormConv1d(in_ch, out_ch, kernel_size, stride, dilation)
        self.kernel_size, self.stride, self.dilation = (kernel_size, stride,
                                                        dilation)
        self.causal, self.pad_mode = causal, pad_mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k_eff = (self.kernel_size - 1) * self.dilation + 1
        padding_total = k_eff - self.stride
        extra = extra_padding(x.shape[-1], k_eff, self.stride, padding_total)
        if self.causal:
            x = pad1d(x, padding_total, extra, self.pad_mode)
        else:
            half = padding_total // 2
            x = pad1d(x, half, padding_total - half + extra, self.pad_mode)
        return self.conv(x)


class SConvTranspose1d(nn.Module):
    """Streamable weight-normalised ``ConvTranspose1d``: the full transposed
    convolution, then ``kernel - stride`` samples trimmed, all from the
    right when ``causal`` (``layers.py:87-110``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, causal: bool = True):
        super().__init__()
        self.convtr = NormConvTranspose1d(in_ch, out_ch, kernel_size, stride)
        self.kernel_size, self.stride, self.causal = (kernel_size, stride,
                                                      causal)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.convtr(x)
        padding_total = self.kernel_size - self.stride
        if padding_total > 0:
            if self.causal:
                y = y[..., :-padding_total]
            else:
                left = padding_total // 2
                y = y[..., left:y.shape[-1] - (padding_total - left)]
        return y


class SLSTM(nn.Module):
    """Stacked LSTM over time with a residual skip (``layers.py:157-171``):
    torch's ``nn.LSTM``, gate order i, f, g, o and two biases, which the
    JAX package's ``_LSTMLayer`` computes with the input product hoisted out
    of its scan."""

    def __init__(self, dim: int, num_layers: int = 2, skip: bool = True):
        super().__init__()
        self.lstm = nn.LSTM(dim, dim, num_layers)
        self.skip = skip

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, _ = self.lstm(x.permute(2, 0, 1))          # (T, B, C)
        y = y.permute(1, 2, 0)
        return y + x if self.skip else y


class SEANetResnetBlock(nn.Module):
    """``[ELU, k3 conv to dim / compress, ELU, k1 conv back]`` plus the
    shortcut: a 1 x 1 convolution (the release's), or the identity with
    ``true_skip`` (``layers.py:174-200``)."""

    def __init__(self, dim: int, kernel_sizes: Tuple[int, int] = (3, 1),
                 dilations: Tuple[int, int] = (1, 1), compress: int = 2,
                 causal: bool = True, true_skip: bool = False,
                 pad_mode: str = "reflect"):
        super().__init__()
        hidden = dim // compress
        dims: Sequence[Tuple[int, int]] = ((dim, hidden), (hidden, dim))
        block = []
        for (cin, cout), k, d in zip(dims, kernel_sizes, dilations):
            block += [nn.ELU(), SConv1d(cin, cout, k, dilation=d,
                                        causal=causal, pad_mode=pad_mode)]
        self.block = nn.Sequential(*block)
        self.shortcut = nn.Identity() if true_skip else SConv1d(
            dim, dim, 1, causal=causal, pad_mode=pad_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.shortcut(x) + self.block(x)
