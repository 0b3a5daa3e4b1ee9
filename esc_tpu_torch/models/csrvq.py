"""Cross-scale residual vector quantization decoder.

Port of ``esc_tpu/models/csrvq.py`` (both backbones; reference:
esc/models/csrvq.py:63-183). Scale by scale, the decoder refines its
features with the quantized residual between encoder and decoder features:

    residual_i = enc_hs[-1-i] - dec_i
    dec_i'     = VQ_i(residual_i) + dec_i

In training mode every scale runs, and a scale that is not transmitted is
masked by a multiplication by zero (csrvq.py:43-45), so that every
parameter stays on the gradient path; at inference it is skipped.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..utils.graphs import stage
from .base import Decoder

__all__ = ["CrossScaleRVQDecoder"]


class CrossScaleRVQDecoder(Decoder):
    """The layers of :class:`~esc_tpu_torch.models.base.Decoder` (either
    backbone), run scale by scale between the product VQs. The VQs belong
    to the codec and are passed in, as in the reference; they take the
    backbone's layout, tokens or maps, as it is."""

    def forward(self, enc_hs: List[torch.Tensor], num_streams: int,
                quantizers, feat_shape: Tuple[int, int],
                freeze_vq: bool = False):
        """The step-wise cross-scale decoding of the full forward
        (csrvq.py:97-129): ``(recon_feat, codes, cm_loss, cb_loss)`` with
        per-sample losses. In training mode ``codes`` holds every scale;
        at inference only the transmitted ones."""
        H, W = feat_shape
        dec, cm_loss, cb_loss, code = self._fuse(
            0, enc_hs[-1], 0.0, quantizers[0], True, freeze_vq)
        codes = [code]
        for i in range(len(self.blocks)):
            dec, cm_i, cb_i, code_i = self._fuse(
                i + 1, enc_hs[-1 - i], dec, quantizers[i + 1],
                i < num_streams - 1, freeze_vq)
            cm_loss = cm_loss + cm_i
            cb_loss = cb_loss + cb_i
            if code_i is not None:
                codes.append(code_i)
            dec, H, W = self.up(i, dec, H, W)
        return (self.post(dec, H, W), torch.stack(codes, dim=1), cm_loss,
                cb_loss)

    def _fuse(self, scale: int, enc, dec, vq, transmit: bool,
              freeze_vq: bool):
        """Quantize ``enc - dec`` and add it to ``dec`` (csrvq.py:23-48);
        returns ``(dec', cm_loss, cb_loss, codes)``."""
        if not self.training and not transmit:
            return dec, 0.0, 0.0, None

        def fuse():
            out = vq(enc - dec, freeze_vq=freeze_vq)
            live = float(transmit)
            return (out["z_q"] * live + dec, out["cm_loss"] * live,
                    out["cb_loss"] * live, out["codes"])
        return stage(f"vq.s{scale}", fuse)

    def encode(self, enc_hs: List[torch.Tensor], num_streams: int,
               quantizers, feat_shape: Tuple[int, int]) -> torch.Tensor:
        """Encoder states -> codes ``(B, num_streams, groups, T)``; runs only
        the scales that are transmitted."""
        H, W = feat_shape
        codes: List[torch.Tensor] = []

        def scale(i, dec):
            """Scale ``i``'s codes and the decoder state with them added;
            the last scale sent stacks every scale's codes instead."""
            code = quantizers[i].encode(enc_hs[-1] if i == 0
                                        else enc_hs[-i] - dec)
            if i == num_streams - 1:
                return torch.stack(codes + [code], dim=1), None
            z_q = quantizers[i].decode(code, self.latent_dims)
            return code, z_q if i == 0 else z_q + dec

        dec = None
        for i in range(num_streams):
            code, dec = stage(f"vq.s{i}", scale, i, dec)
            if dec is None:
                return code
            codes.append(code)
            if i > 0:
                dec, H, W = self.up(i - 1, dec, H, W)

    def decode(self, codes: torch.Tensor, quantizers,
               feat_shape: Tuple[int, int]) -> torch.Tensor:
        """Codes ``(B, s, groups, T)`` -> spectrum ``(B, 2, F, T)``."""
        H, W = feat_shape
        num_streams = codes.shape[1]
        dec = stage("vq.s0", lambda: quantizers[0].decode(
            codes[:, 0], self.latent_dims))
        for i in range(len(self.blocks)):
            if i < num_streams - 1:
                dec = stage(f"vq.s{i + 1}", lambda i, dec: quantizers[
                    i + 1].decode(codes[:, i + 1], self.latent_dims) + dec,
                    i, dec)
            dec, H, W = self.up(i, dec, H, W)
        return self.post(dec, H, W)
