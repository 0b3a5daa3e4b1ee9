"""DAC building blocks: the snake activation and weight-normalised 1-D
convolutions.

Port of ``esc_tpu/baselines/dac/layers.py`` (reference:
baselines/descript/dac/nn/layers.py) in torch's NCW layout ``(B, C, T)``.
Each layer takes ``padded``: ``False`` drops every convolution's padding
(VALID), the reference's toggle for chunked inference (base.py:57-80).

The convolutions keep the reference's ``torch.nn.utils.weight_norm``
parameters, ``weight_v`` (direction) and ``weight_g`` (magnitude, one per
slice of dim 0: the output channels of a convolution, the input channels of
a transposed one), and compute their kernel with torch's own weight norm,
so a released DAC state dict loads as it is.

Outside training and autograd, :class:`Snake1d` runs the port's snake
kernel (:mod:`esc_tpu_torch.ops.kernels.snake`); ``snake`` is the plain
expression the kernel is held to.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.kernels import snake as snake_kernel
from ...ops.kernels import snake_plain as snake
from ...utils.profiling import annotate

__all__ = ["snake", "Snake1d", "WNConv1d", "WNConvTranspose1d",
           "conv_out_len", "convT_out_len", "ceil_div"]


class Snake1d(nn.Module):
    """Learnable per-channel snake activation, alpha ``(1, C, 1)`` from 1;
    each call in the span ``act.snake``.

    ``plain_ops`` (set by ``DAC``), training mode and a call autograd
    records run the plain expression (:func:`snake`, layers.py:17-24), on
    any device; otherwise the snake kernel, which takes a contiguous copy of
    a strided input."""

    plain_ops = False

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(1, channels, 1))

    def forward(self, x: torch.Tensor, padded: bool = True) -> torch.Tensor:
        with annotate("act.snake"):
            if self.plain_ops or self.training or (
                    torch.is_grad_enabled()
                    and (x.requires_grad or self.alpha.requires_grad)):
                return snake(x, self.alpha)
            return snake_kernel(x.contiguous(), self.alpha)


class _WeightNorm(nn.Module):
    """``weight_v`` of ``shape``, ``weight_g`` of ``shape[0]`` slices and a
    bias of ``out_ch``; :meth:`weight` is ``g * v / |v|`` over dim 0's
    slices. ``flax_names`` are the flax ``nn.WeightNorm`` wrapper's and its
    layer's names (:mod:`esc_tpu_torch.convert`)."""

    flax_names = ("conv", "Conv_0")

    def __init__(self, shape, out_ch: int):
        super().__init__()
        self.weight_v = nn.Parameter(torch.empty(shape))
        self.weight_g = nn.Parameter(torch.ones(shape[0], 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def weight(self) -> torch.Tensor:
        return torch._weight_norm(self.weight_v, self.weight_g, 0)


class WNConv1d(_WeightNorm):
    """Weight-normalised ``Conv1d``; ``padding`` is torch's symmetric
    sample count, dropped where ``padded`` is False."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, padding: int = 0):
        super().__init__((out_ch, in_ch, kernel_size), out_ch)
        self.stride, self.dilation, self.padding = stride, dilation, padding

    def forward(self, x: torch.Tensor, padded: bool = True) -> torch.Tensor:
        return F.conv1d(x, self.weight(), self.bias, self.stride,
                        self.padding if padded else 0, self.dilation)


class WNConvTranspose1d(_WeightNorm):
    """Weight-normalised ``ConvTranspose1d``: the full transposed
    convolution cropped by ``padding`` on both sides (none where
    ``padded`` is False)."""

    flax_names = ("conv", "ConvTranspose_0")

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, padding: int = 0):
        super().__init__((in_ch, out_ch, kernel_size), out_ch)
        self.stride, self.padding = stride, padding

    def forward(self, x: torch.Tensor, padded: bool = True) -> torch.Tensor:
        return F.conv_transpose1d(x, self.weight(), self.bias, self.stride,
                                  self.padding if padded else 0)


def conv_out_len(L: int, k: int, s: int, d: int, p: int) -> int:
    """torch ``Conv1d``'s output length."""
    return (L + 2 * p - d * (k - 1) - 1) // s + 1


def convT_out_len(L: int, k: int, s: int, p: int) -> int:
    """torch ``ConvTranspose1d``'s output length."""
    return (L - 1) * s - 2 * p + k


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)
