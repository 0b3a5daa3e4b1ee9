"""The Swin encoder and the bitrate formula.

Port of ``esc_tpu/models/base.py`` (``max_bps``, ``Encoder`` with the
transformer backbone; reference: esc/models/base.py:110-158).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from ..modules.scale import PatchEmbed
from ..modules.transformer import TransformerLayer

__all__ = ["Encoder", "max_bps"]


def max_bps(overlap: int, max_streams: int, codebook_size: int,
            group_size: int, time_patch: int) -> float:
    """Maximum bitrate in kbps (esc/models/base.py:70)."""
    return (2 / overlap) * max_streams * math.log2(codebook_size) \
        * group_size // (20 * time_patch // 2)


class Encoder(nn.Module):
    """PatchEmbed, ``pre_nn`` and ``len(h_dims) - 1`` down-scaling Swin
    layers. ``(B, 2, F, T)`` -> (hidden states at every scale, bottom
    ``(H, W)``)."""

    def __init__(self, in_dim: int = 2, h_dims: Sequence[int] = (
            45, 72, 96, 144, 192, 384), patch_size: Sequence[int] = (3, 2),
                 swin_heads: Sequence[int] = (3, 6, 12, 24, 24),
                 swin_depth: int = 2, window_size: int = 4,
                 mlp_ratio: float = 4.0):
        super().__init__()
        h = list(h_dims)
        self.patch_size = tuple(patch_size)
        self.patch_embed = PatchEmbed(in_dim, patch_size, h[0])
        self.pre_nn = TransformerLayer(h[0], h[0], swin_heads[0], swin_depth,
                                       window_size, mlp_ratio, scale=None)
        self.blocks = nn.ModuleList([
            TransformerLayer(h[i], h[i + 1], swin_heads[i], swin_depth,
                             window_size, mlp_ratio, scale="down")
            for i in range(len(h) - 1)])

    def forward(self, x_feat: torch.Tensor
                ) -> Tuple[List[torch.Tensor], Tuple[int, int]]:
        H = x_feat.shape[2] // self.patch_size[0]
        W = x_feat.shape[3] // self.patch_size[1]
        x, H, W = self.pre_nn(self.patch_embed(x_feat), H, W)
        enc_hs = [x]
        for blk in self.blocks:
            x, H, W = blk(x, H, W)
            enc_hs.append(x)
        return enc_hs, (H, W)
