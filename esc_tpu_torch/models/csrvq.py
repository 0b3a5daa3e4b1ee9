"""Cross-scale residual vector quantization decoder, at inference.

Port of ``esc_tpu/models/csrvq.py`` (transformer backbone; reference:
esc/models/csrvq.py:63-183). Scale by scale, the decoder refines its
features with the quantized residual between encoder and decoder features:

    residual_i = enc_hs[-1-i] - dec_i
    dec_i'     = VQ_i(residual_i) + dec_i
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from ..modules.scale import PatchDeEmbed
from ..modules.transformer import TransformerLayer

__all__ = ["CrossScaleRVQDecoder"]


class CrossScaleRVQDecoder(nn.Module):
    """Up-scaling Swin layers, ``post_nn`` and PatchDeEmbed. The product VQs
    belong to the codec and are passed in, as in the reference."""

    def __init__(self, in_freq: int = 192, in_dim: int = 2,
                 h_dims: Sequence[int] = (384, 192, 144, 96, 72, 45),
                 patch_size: Sequence[int] = (3, 2),
                 swin_heads: Sequence[int] = (24, 24, 12, 6, 3),
                 swin_depth: int = 2, window_size: int = 4,
                 mlp_ratio: float = 4.0):
        super().__init__()
        h = list(h_dims)
        self.blocks = nn.ModuleList([
            TransformerLayer(h[i], h[i + 1], swin_heads[i], swin_depth,
                             window_size, mlp_ratio, scale="up")
            for i in range(len(h) - 1)])
        self.post_nn = TransformerLayer(h[-1], h[-1], swin_heads[-1],
                                        swin_depth, window_size, mlp_ratio,
                                        scale=None)
        self.patch_deembed = PatchDeEmbed(in_freq, in_dim, patch_size, h[-1])

    def encode(self, enc_hs: List[torch.Tensor], num_streams: int,
               quantizers, feat_shape: Tuple[int, int]) -> torch.Tensor:
        """Encoder states -> codes ``(B, num_streams, groups, T)``; runs only
        the scales that are transmitted."""
        H, W = feat_shape
        code0 = quantizers[0].encode(enc_hs[-1])
        if num_streams == 1:
            return code0[:, None]
        codes, dec = [code0], quantizers[0].decode(code0)
        for i in range(num_streams - 1):
            code_i = quantizers[i + 1].encode(enc_hs[-1 - i] - dec)
            codes.append(code_i)
            if len(codes) == num_streams:
                break
            dec = quantizers[i + 1].decode(code_i) + dec
            dec, H, W = self.blocks[i](dec, H, W)
        return torch.stack(codes, dim=1)

    def decode(self, codes: torch.Tensor, quantizers,
               feat_shape: Tuple[int, int]) -> torch.Tensor:
        """Codes ``(B, s, groups, T)`` -> spectrum ``(B, 2, F, T)``."""
        H, W = feat_shape
        num_streams = codes.shape[1]
        dec = quantizers[0].decode(codes[:, 0])
        for i, blk in enumerate(self.blocks):
            if i < num_streams - 1:
                dec = quantizers[i + 1].decode(codes[:, i + 1]) + dec
            dec, H, W = blk(dec, H, W)
        dec, H, W = self.post_nn(dec, H, W)
        return self.patch_deembed(dec)
