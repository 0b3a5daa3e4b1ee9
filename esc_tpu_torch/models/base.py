"""The encoder, the plain mirror decoder and the bitrate formula.

Port of ``esc_tpu/models/base.py`` (``max_bps``, ``Encoder``, ``Decoder``;
reference: esc/models/base.py:110-203), for both backbones: the Swin
transformer, on tokens ``(B, H*W, C)``, and the convolution backbone of the
ablations, on maps ``(B, C, H, W)``. Every layer takes and returns
``(x, H, W)``, so the stacks are the same code for both.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from ..modules.convolution import ConvolutionLayer, ConvolutionStage
from ..modules.scale import PatchDeEmbed, PatchEmbed
from ..modules.transformer import TransformerLayer
from ..utils.graphs import stage

__all__ = ["Encoder", "Decoder", "max_bps", "BACKBONES", "backbone_layers"]

BACKBONES = ("transformer", "convolution")


def max_bps(overlap: int, max_streams: int, codebook_size: int,
            group_size: int, time_patch: int) -> float:
    """Maximum bitrate in kbps (esc/models/base.py:70)."""
    return (2 / overlap) * max_streams * math.log2(codebook_size) \
        * group_size // (20 * time_patch // 2)


def backbone_layers(backbone: str, h_dims: Sequence[int], scale: str,
                    swin_heads: Sequence[int], swin_depth: int,
                    window_size: int, mlp_ratio: float,
                    kernel_size: Sequence[int], conv_depth: int
                    ) -> Tuple[nn.Module, nn.ModuleList]:
    """The layer that keeps the scale at the top (the encoder's ``pre_nn``
    on ``h_dims[0]``, a decoder's ``post_nn`` on ``h_dims[-1]``) and the
    ``len(h_dims) - 1`` layers that halve (``scale="down"``) or double
    (``"up"``) H between the widths of ``h_dims``."""
    if backbone not in BACKBONES:
        raise ValueError(f"backbone must be one of {BACKBONES}: "
                         f"{backbone!r}")
    h = list(h_dims)
    top = h[0] if scale == "down" else h[-1]
    if backbone == "convolution":
        return (ConvolutionStage(top, kernel_size),
                nn.ModuleList([
                    ConvolutionLayer(h[i], h[i + 1], conv_depth, kernel_size,
                                     transpose=scale == "up")
                    for i in range(len(h) - 1)]))
    heads = list(swin_heads)
    return (TransformerLayer(top, top, heads[0 if scale == "down" else -1],
                             swin_depth, window_size, mlp_ratio, scale=None),
            nn.ModuleList([
                TransformerLayer(h[i], h[i + 1], heads[i], swin_depth,
                                 window_size, mlp_ratio, scale=scale)
                for i in range(len(h) - 1)]))


class Encoder(nn.Module):
    """PatchEmbed, ``pre_nn`` and ``len(h_dims) - 1`` down-scaling layers.
    ``(B, 2, F, T)`` -> (hidden states at every scale, bottom ``(H, W)``)."""

    def __init__(self, in_dim: int = 2, h_dims: Sequence[int] = (
            45, 72, 96, 144, 192, 384), patch_size: Sequence[int] = (3, 2),
                 swin_heads: Sequence[int] = (3, 6, 12, 24, 24),
                 swin_depth: int = 2, window_size: int = 4,
                 mlp_ratio: float = 4.0, backbone: str = "transformer",
                 kernel_size: Sequence[int] = (5, 2), conv_depth: int = 1):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.patch_embed = PatchEmbed(in_dim, patch_size, h_dims[0],
                                      backbone)
        self.pre_nn, self.blocks = backbone_layers(
            backbone, h_dims, "down", swin_heads, swin_depth, window_size,
            mlp_ratio, kernel_size, conv_depth)

    def forward(self, x_feat: torch.Tensor
                ) -> Tuple[List[torch.Tensor], Tuple[int, int]]:
        H = x_feat.shape[2] // self.patch_size[0]
        W = x_feat.shape[3] // self.patch_size[1]
        x, H, W = stage("encoder.embed", self.embed, x_feat, H, W)
        enc_hs = [x]
        for i, blk in enumerate(self.blocks):
            x, H, W = stage(f"encoder.s{i}", blk, x, H, W)
            enc_hs.append(x)
        return enc_hs, (H, W)

    def embed(self, x_feat: torch.Tensor, H: int, W: int
              ) -> Tuple[torch.Tensor, int, int]:
        """PatchEmbed and ``pre_nn``: the spectrum to the top scale."""
        return self.pre_nn(self.patch_embed(x_feat), H, W)


class Decoder(nn.Module):
    """The single-latent mirror decoder of the bottleneck-RVQ codecs
    (esc/models/base.py:161-203): ``len(h_dims) - 1`` up-scaling layers,
    ``post_nn`` and PatchDeEmbed. ``(z_q, (H, W))`` -> ``(B, 2, F, T)``."""

    def __init__(self, in_freq: int = 192, in_dim: int = 2,
                 h_dims: Sequence[int] = (384, 192, 144, 96, 72, 45),
                 patch_size: Sequence[int] = (3, 2),
                 swin_heads: Sequence[int] = (24, 24, 12, 6, 3),
                 swin_depth: int = 2, window_size: int = 4,
                 mlp_ratio: float = 4.0, backbone: str = "transformer",
                 kernel_size: Sequence[int] = (5, 2), conv_depth: int = 1):
        super().__init__()
        post_nn, self.blocks = backbone_layers(
            backbone, h_dims, "up", swin_heads, swin_depth, window_size,
            mlp_ratio, kernel_size, conv_depth)
        self.post_nn = post_nn
        # the rank of a latent: tokens (B, H*W, C) or maps (B, C, H, W)
        self.latent_dims = 3 if backbone == "transformer" else 4
        self.patch_deembed = PatchDeEmbed(in_freq, in_dim, patch_size,
                                          h_dims[-1])

    def forward(self, z_q: torch.Tensor, feat_shape: Tuple[int, int]
                ) -> torch.Tensor:
        H, W = feat_shape
        for i in range(len(self.blocks)):
            z_q, H, W = self.up(i, z_q, H, W)
        return self.post(z_q, H, W)

    def up(self, i: int, x: torch.Tensor, H: int, W: int
           ) -> Tuple[torch.Tensor, int, int]:
        """Up-scaling layer ``i``."""
        return stage(f"decoder.s{i}", self.blocks[i], x, H, W)

    def post(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        """``post_nn`` and PatchDeEmbed: the top scale's tokens or maps to
        the spectrum ``(B, 2, F, T)``."""
        return stage("decoder.post", lambda: self.patch_deembed(
            self.post_nn(x, H, W)[0]))
