"""Patch and scale operations: pixel (un)shuffle, patch (de-)embedding,
patch merge and split.

Port of ``esc_tpu/modules/scale.py``. Token tensors are ``(B, H*W, C)``,
row-major over ``(H, W)``; spectra are ``(B, 2, F, T)`` (NCHW, PyTorch's
convolution layout). Parameter names are the reference's torch keys.
LayerNorm uses epsilon 1e-6, flax's default, as the JAX package does.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["LN_EPS", "pixel_shuffle", "pixel_unshuffle", "PatchEmbed",
           "PatchDeEmbed", "PatchMerge", "PatchSplit"]

LN_EPS = 1e-6


def pixel_unshuffle(x: torch.Tensor, factor: Sequence[int] = (2, 1)
                    ) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/s1, W/s2, C*s1*s2), channel layout [s1, s2, C]."""
    s1, s2 = factor
    B, H, W, C = x.shape
    x = x.reshape(B, H // s1, s1, W // s2, s2, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H // s1, W // s2, C * s1 * s2)


def pixel_shuffle(x: torch.Tensor, factor: Sequence[int] = (2, 1)
                  ) -> torch.Tensor:
    """(B, H, W, C) -> (B, H*s1, W*s2, C/(s1*s2)); inverse of unshuffle."""
    s1, s2 = factor
    B, H, W, C = x.shape
    c = C // (s1 * s2)
    x = x.reshape(B, H, W, s1, s2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H * s1, W * s2, c)


class PatchEmbed(nn.Module):
    """Strided-conv patchify + token LayerNorm: ``(B, 2, F, T)`` ->
    ``(B, H*W, C)``."""

    def __init__(self, in_chans: int, patch_size: Sequence[int],
                 embed_dim: int):
        super().__init__()
        p = tuple(patch_size)
        self.proj = nn.Conv2d(in_chans, embed_dim, p, p)
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.proj(x).flatten(2).transpose(1, 2))


class PatchDeEmbed(nn.Module):
    """conv 5x5 -> pixel shuffle -> conv 3x3: ``(B, H*W, C)`` ->
    ``(B, 2, F, T)``."""

    def __init__(self, freq: int, in_chans: int, patch_size: Sequence[int],
                 embed_dim: int):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.H = freq // self.patch_size[0]
        p0, p1 = self.patch_size
        self.de_proj1 = nn.Conv2d(embed_dim, embed_dim * p0 * p1, 5, 1, 2)
        self.de_proj2 = nn.Conv2d(embed_dim, in_chans, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, C = x.shape
        x = x.transpose(1, 2).reshape(B, C, self.H, L // self.H)
        x = self.de_proj1(x)
        x = pixel_shuffle(x.permute(0, 2, 3, 1), self.patch_size)
        return self.de_proj2(x.permute(0, 3, 1, 2))


class PatchMerge(nn.Module):
    """Halve H: zero-pad odd H, pixel-unshuffle, LayerNorm, Linear down."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(2 * in_dim, eps=LN_EPS)
        self.down = nn.Linear(2 * in_dim, out_dim, bias=False)

    def forward(self, x: torch.Tensor, H: int) -> torch.Tensor:
        B, L, C = x.shape
        x = x.reshape(B, H, L // H, C)
        if H % 2:
            x = F.pad(x, (0, 0, 0, 0, 0, 1))
        x = pixel_unshuffle(x, (2, 1)).reshape(B, -1, 2 * C)
        return self.down(self.norm(x))


class PatchSplit(nn.Module):
    """Double H: LayerNorm, Linear up, pixel-shuffle."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(in_dim, eps=LN_EPS)
        self.up = nn.Linear(in_dim, out_dim * 2, bias=False)

    def forward(self, x: torch.Tensor, H: int) -> torch.Tensor:
        x = self.up(self.norm(x))
        B, L, C = x.shape
        x = pixel_shuffle(x.reshape(B, H, L // H, C), (2, 1))
        return x.reshape(B, -1, C // 2)
