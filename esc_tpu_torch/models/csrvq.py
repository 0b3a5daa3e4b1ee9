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

from ..utils.profiling import annotate
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
        with annotate(f"vq.s{scale}"):
            out = vq(enc - dec, freeze_vq=freeze_vq)
            live = float(transmit)
            return (out["z_q"] * live + dec, out["cm_loss"] * live,
                    out["cb_loss"] * live, out["codes"])

    def encode(self, enc_hs: List[torch.Tensor], num_streams: int,
               quantizers, feat_shape: Tuple[int, int]) -> torch.Tensor:
        """Encoder states -> codes ``(B, num_streams, groups, T)``; runs only
        the scales that are transmitted."""
        H, W = feat_shape
        with annotate("vq.s0"):
            code0 = quantizers[0].encode(enc_hs[-1])
            if num_streams == 1:
                return code0[:, None]
            codes, dec = [code0], quantizers[0].decode(code0,
                                                       self.latent_dims)
        for i in range(num_streams - 1):
            with annotate(f"vq.s{i + 1}"):
                code_i = quantizers[i + 1].encode(enc_hs[-1 - i] - dec)
                codes.append(code_i)
                if len(codes) == num_streams:      # the last scale sent
                    return torch.stack(codes, dim=1)
                dec = quantizers[i + 1].decode(code_i, self.latent_dims) \
                    + dec
            dec, H, W = self.up(i, dec, H, W)

    def decode(self, codes: torch.Tensor, quantizers,
               feat_shape: Tuple[int, int]) -> torch.Tensor:
        """Codes ``(B, s, groups, T)`` -> spectrum ``(B, 2, F, T)``."""
        H, W = feat_shape
        num_streams = codes.shape[1]
        with annotate("vq.s0"):
            dec = quantizers[0].decode(codes[:, 0], self.latent_dims)
        for i in range(len(self.blocks)):
            if i < num_streams - 1:
                with annotate(f"vq.s{i + 1}"):
                    dec = quantizers[i + 1].decode(codes[:, i + 1],
                                                    self.latent_dims) + dec
            dec, H, W = self.up(i, dec, H, W)
        return self.post(dec, H, W)
