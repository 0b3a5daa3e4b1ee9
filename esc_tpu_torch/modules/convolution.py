"""The convolutional backbone of the ablation codecs.

Port of ``esc_tpu/modules/convolution.py`` (reference:
esc/modules/convolution/layers.py). The port is NCHW, PyTorch's convolution
layout, where the JAX package is NHWC; both crop the same rows and columns.
Parameter names are the reference's torch keys: ``conv`` in
``Convolution2D``, ``block.{0..5}`` in ``ResidualUnit``, ``blocks.{i}`` in
``ConvolutionLayer``.

BatchNorm runs on its running statistics, as the JAX package's
``nn.BatchNorm(use_running_average=True)`` does at inference (epsilon 1e-5;
flax's ``momentum=0.9`` is torch's ``momentum=0.1``). The JAX package cannot
train this backbone: its trainer applies the ``params`` collection alone,
and BatchNorm's statistics live in ``batch_stats``. The port keeps to what
it does, so a module of this backbone in training mode raises
(:func:`refuse_training`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["PReLU", "Convolution2D", "ConvolutionStage", "ResidualUnit",
           "ConvolutionLayer", "BN_EPS", "refuse_training"]

BN_EPS = 1e-5


def refuse_training() -> None:
    """Raise the error of a conv-backbone codec asked to train."""
    raise NotImplementedError(
        "training the convolution backbone: its BatchNorm layers need "
        "batch statistics in training, and esc_tpu's trainer applies the "
        "'params' collection alone (no 'batch_stats'), so the reference "
        "cannot train it either; serve or evaluate it instead")


class PReLU(nn.Module):
    """``torch.nn.PReLU`` with one slope, which starts at 0.25."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp_min(x, 0) + self.weight * torch.clamp_max(x, 0)


class Convolution2D(nn.Module):
    """Conv or transposed conv with the reference's crops (layers.py:3-28).

    ``scale`` halves H (conv, stride (2, 1)) or doubles it (transposed);
    W is always cropped back to its input length. The transposed conv is
    flax's ``ConvTranspose(padding="VALID", transpose_kernel=True)`` with H
    cropped by 1 on each side, which is ``ConvTranspose2d(padding=(1, 0))``.

    ``compute_dtype`` (set by the codec) bfloat16 runs the convolution in
    bf16, input, weight and bias cast, and widens its output to float32, as
    the JAX package's ``nn.Conv(dtype=bf16)`` ahead of a float32 BatchNorm.
    """

    compute_dtype = torch.float32

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Sequence[int] = (5, 2), scale: bool = True,
                 transpose: bool = False):
        super().__init__()
        stride = (2, 1) if scale else (1, 1)
        k = tuple(kernel_size)
        self.scale, self.transpose = scale, transpose
        self.conv = (nn.ConvTranspose2d(in_channels, out_channels, k, stride,
                                        padding=(1, 0)) if transpose else
                     nn.Conv2d(in_channels, out_channels, k, stride,
                               padding=(2, 1)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[-2:]
        dt = self.compute_dtype
        if dt == torch.float32:
            y = self.conv(x)
        else:
            c = self.conv
            args = (x.to(dt), c.weight.to(dt), c.bias.to(dt), c.stride,
                    c.padding)
            y = (F.conv_transpose2d(*args) if self.transpose
                 else F.conv2d(*args)).float()
        if self.scale:
            H = H * 2 if self.transpose else H // 2
        return y[..., :H, :W]


class ConvolutionStage(Convolution2D):
    """A :class:`Convolution2D` that keeps the scale, as the backbone's
    ``pre_nn`` and ``post_nn``, with the Swin layers' call protocol
    ``(x, H, W) -> (x', H', W')``."""

    def __init__(self, dim: int, kernel_size: Sequence[int] = (5, 2)):
        super().__init__(dim, dim, kernel_size, scale=False)

    def forward(self, x: torch.Tensor, H: int, W: int):
        return super().forward(x), H, W


class ResidualUnit(nn.Module):
    """(Conv, BatchNorm, PReLU) twice, plus the input (layers.py:30-46)."""

    def __init__(self, dim: int):
        super().__init__()
        self.block = nn.Sequential(
            Convolution2D(dim, dim, (5, 2), scale=False),
            nn.BatchNorm2d(dim, eps=BN_EPS, momentum=0.1), PReLU(),
            Convolution2D(dim, dim, (5, 2), scale=False),
            nn.BatchNorm2d(dim, eps=BN_EPS, momentum=0.1), PReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.block(x)


class ConvolutionLayer(nn.Module):
    """``depth`` residual units, then a scaling conv, BatchNorm and PReLU
    (layers.py:49-63): halves H (conv) or doubles it (transposed). Call
    protocol ``(x, H, W) -> (x', H', W')``, as the Swin layers'."""

    def __init__(self, in_dim: int, out_dim: int, depth: int = 1,
                 kernel_size: Sequence[int] = (5, 2),
                 transpose: bool = False):
        super().__init__()
        self.blocks = nn.Sequential(
            *[ResidualUnit(in_dim) for _ in range(depth)],
            Convolution2D(in_dim, out_dim, kernel_size, scale=True,
                          transpose=transpose),
            nn.BatchNorm2d(out_dim, eps=BN_EPS, momentum=0.1), PReLU())
        self.transpose = transpose

    def forward(self, x: torch.Tensor, H: int, W: int):
        return self.blocks(x), H * 2 if self.transpose else H // 2, W
