"""Product vector quantization.

Port of ``esc_tpu/modules/vq.py`` (reference:
esc/modules/vq/{codebook,quantization}.py): ``split_dimension``,
``pre_process`` / ``post_process``, ``Codebook``, ``ProductVectorQuantize``
(ESC's per-scale quantizer), ``ResidualVectorQuantize`` (standalone, on a
latent of its own) and ``ProductResidualVectorQuantize`` (the ablation
codecs' bottleneck, one residual VQ per group). A
latent is either the transformer backbone's tokens ``(B, H*W, C)`` or the
convolution backbone's maps ``(B, C, H, W)``. At inference the
nearest-codeword search is the codebook argmin kernel
(:mod:`esc_tpu_torch.ops.kernels.codebook_argmin`), after the cosine
(L2-normalised) lookup's normalisation. In training mode
(``module.train()``) it is the kernel's plain version, as in the JAX
package (``esc_tpu/modules/vq.py:121``), and the forward returns the
straight-through estimate with per-sample losses.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels import codebook_argmin, codebook_argmin_plain

__all__ = ["split_dimension", "pre_process", "post_process", "Codebook",
           "ProductVectorQuantize", "ResidualVectorQuantize",
           "ProductResidualVectorQuantize"]


def split_dimension(total_dim: int, num: int) -> List[int]:
    """The reference's split of a feature dim into ``num`` groups."""
    if total_dim % num == 0:
        return [total_dim // num] * num
    dims = [total_dim // num] * (num - 1)
    dims.append(total_dim - sum(dims))
    return dims


def pre_process(z_e: torch.Tensor, in_freq: int, overlap: int,
                fix_dim: int) -> torch.Tensor:
    """Tokens ``(B, H*W, C)`` or maps ``(B, C, H, W)`` ->
    ``(B, W//overlap, overlap*C*H)``, feature layout ``[overlap, C, H]``
    (slowest first)."""
    if z_e.dim() == 3:
        B, L, C = z_e.shape
        z = z_e.reshape(B, in_freq, L // in_freq, C).permute(0, 2, 3, 1)
    else:
        z = z_e.permute(0, 3, 1, 2)
    B, W = z.shape[:2]                                   # z: (B, W, C, H)
    z = z.reshape(B, W, fix_dim)
    if overlap > 1:
        if W % overlap:
            raise ValueError(f"time dim {W} is not a multiple of {overlap}")
        z = z.reshape(B, W // overlap, overlap * fix_dim)
    return z


def post_process(z_q: torch.Tensor, in_freq: int, overlap: int,
                 fix_dim: int, dims: int = 3) -> torch.Tensor:
    """Inverse of :func:`pre_process`, back to tokens ``(B, H*W, C)``
    (``dims`` 3) or maps ``(B, C, H, W)`` (``dims`` 4)."""
    B = z_q.shape[0]
    if overlap > 1:
        z_q = z_q.reshape(B, -1, fix_dim)
    W = z_q.shape[1]
    H = in_freq
    z = z_q.reshape(B, W, fix_dim // H, H)
    if dims == 4:
        return z.permute(0, 2, 3, 1)
    return z.permute(0, 3, 1, 2).reshape(B, H * W, fix_dim // H)


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """``x / max(|x|, 1e-12)`` along the last dim, jnp.linalg.norm's sum."""
    return x / torch.sqrt((x * x).sum(-1, keepdim=True)).clamp_min(1e-12)


class Codebook(nn.Module):
    """One VQ codebook with optional cosine (L2-normalised) lookup.

    ``plain_ops`` (set by the codec) runs the plain PyTorch argmin in place
    of the kernel, on any device; so does training mode.
    """

    plain_ops = False

    def __init__(self, embedding_dim: int, num_embeddings: int,
                 l2norm: bool):
        super().__init__()
        self.embedding = nn.Embedding(num_embeddings, embedding_dim)
        self.l2norm = l2norm

    def encode(self, z_e: torch.Tensor) -> torch.Tensor:
        """``(B, T, d)`` -> int32 codes ``(B, T)``."""
        B, _, d = z_e.shape
        codebook = self.embedding.weight.float()
        z = z_e.float().reshape(-1, d)
        if self.l2norm:
            codebook = _l2_normalize(codebook)
            z = _l2_normalize(z)
        search = codebook_argmin_plain if self.plain_ops or self.training \
            else codebook_argmin
        return search(z.contiguous(), codebook.contiguous()).reshape(B, -1)

    def decode(self, code: torch.Tensor) -> torch.Tensor:
        """Integer codes ``(B, *)`` -> embeddings ``(B, *, d)``."""
        return F.embedding(code, self.embedding.weight)

    def forward(self, z_e: torch.Tensor):
        """``(B, T, d)`` -> ``(z_q, code, codebook_loss, commitment_loss)``
        with per-sample ``(B,)`` losses (codebook.py:57-75). In training
        mode ``z_q`` is the straight-through estimate and each loss stops
        the gradient of the other side; at inference both losses are the
        same commitment."""
        with torch.no_grad():
            code = self.encode(z_e)
        z_q = self.decode(code)
        if self.training:
            commitment = ((z_q.detach() - z_e) ** 2).mean((1, 2))
            codebook_l = ((z_q - z_e.detach()) ** 2).mean((1, 2))
            z_q = z_e + (z_q - z_e).detach()
        else:
            commitment = ((z_q - z_e) ** 2).mean((1, 2))
            codebook_l = commitment
        return z_q, code, codebook_l, commitment


class ProductVectorQuantize(nn.Module):
    """Product VQ over channel groups of the frequency-merged,
    frame-grouped latent."""

    def __init__(self, in_dim: int, in_freq: int, overlap: int = 2,
                 num_vqs: int = 3, codebook_dim: int = 8,
                 codebook_size: int = 1024, l2norm: bool = True):
        super().__init__()
        self.in_freq = in_freq
        self.overlap = overlap
        self.fix_dim = in_freq * in_dim
        self.vq_dims = split_dimension(self.fix_dim * overlap, num_vqs)
        self.vqs = nn.ModuleList([Codebook(codebook_dim, codebook_size, l2norm)
                                  for _ in self.vq_dims])
        self.down_projs = nn.ModuleList([nn.Linear(d, codebook_dim, bias=False)
                                         for d in self.vq_dims])
        self.up_projs = nn.ModuleList([nn.Linear(codebook_dim, d, bias=False)
                                       for d in self.vq_dims])

    def forward(self, z_e: torch.Tensor, freeze_vq: bool = False
                ) -> Dict[str, torch.Tensor]:
        """Quantize and dequantize a latent: ``{"z_q" (its layout),
        "codes" (B, num_vqs, T), "cb_loss" (B,), "cm_loss" (B,)}``.
        ``freeze_vq`` is the codebook-freeze pretraining stage
        (quantization.py:56-59): the input passes through the quantized
        path's place, multiplied in so that every parameter stays on the
        graph, and the losses are zero."""
        z = pre_process(z_e, self.in_freq, self.overlap, self.fix_dim)
        z_qs, codes, cb_loss, cm_loss, s = [], [], 0.0, 0.0, 0
        for dim, down, up, vq in zip(self.vq_dims, self.down_projs,
                                     self.up_projs, self.vqs):
            z_m = down(z[..., s:s + dim])
            z_q_m, code, cb, cm = vq(z_m)
            if freeze_vq:
                z_q_m = z_q_m * 0.0 + z_m
                cb = cb * 0.0
                cm = cm * 0.0
            z_qs.append(up(z_q_m))
            codes.append(code)
            cb_loss = cb_loss + cb
            cm_loss = cm_loss + cm
            s += dim
        z_q = post_process(torch.cat(z_qs, dim=-1), self.in_freq,
                           self.overlap, self.fix_dim, z_e.dim())
        n = len(self.vqs)
        return {"z_q": z_q, "codes": torch.stack(codes, dim=1),
                "cb_loss": cb_loss / n, "cm_loss": cm_loss / n}

    def encode(self, z_e: torch.Tensor) -> torch.Tensor:
        """A latent -> codes ``(B, num_vqs, T)``."""
        z = pre_process(z_e, self.in_freq, self.overlap, self.fix_dim)
        codes, s = [], 0
        for dim, down, vq in zip(self.vq_dims, self.down_projs, self.vqs):
            codes.append(vq.encode(down(z[..., s:s + dim])))
            s += dim
        return torch.stack(codes, dim=1)

    def decode(self, codes: torch.Tensor, dims: int = 3) -> torch.Tensor:
        """Codes ``(B, num_vqs, T)`` -> a latent of rank ``dims``."""
        z_qs = [up(vq.decode(codes[:, m]))
                for m, (up, vq) in enumerate(zip(self.up_projs, self.vqs))]
        return post_process(torch.cat(z_qs, dim=-1), self.in_freq,
                            self.overlap, self.fix_dim, dims)


class ResidualVectorQuantize(nn.Module):
    """Classic residual VQ with stream masking (quantization.py:139-274):
    ``num_vqs`` codebooks, each quantizing what the ones before it left,
    behind a projection down to ``codebook_dim`` (and back up) where the
    hidden width differs. Standalone, it frames a latent as
    :class:`ProductVectorQuantize` does (``in_dim``, ``in_freq``,
    ``overlap``; the hidden width defaults to ``fix_dim * overlap``);
    inside :class:`ProductResidualVectorQuantize` each group's quantizer
    takes its group's width as ``hidden_dim`` and only its residual stages
    and projections run."""

    def __init__(self, in_dim: int = 64, in_freq: int = 6,
                 hidden_dim: Optional[int] = None, overlap: int = 4,
                 num_vqs: int = 6, codebook_dim: int = 8,
                 codebook_size: int = 1024, l2norm: bool = True):
        super().__init__()
        self.in_dim, self.in_freq, self.overlap = in_dim, in_freq, overlap
        self.codebook_dim = codebook_dim
        self.hidden_dim = hidden_dim if hidden_dim is not None \
            else self.fix_dim * overlap
        if self.do_proj:
            self.proj_down = nn.Linear(self.hidden_dim, codebook_dim,
                                       bias=False)
            self.proj_up = nn.Linear(codebook_dim, self.hidden_dim,
                                     bias=False)
        self.vqs = nn.ModuleList([Codebook(codebook_dim, codebook_size, l2norm)
                                  for _ in range(num_vqs)])

    @property
    def fix_dim(self) -> int:
        return self.in_freq * self.in_dim

    @property
    def do_proj(self) -> bool:
        return self.hidden_dim != self.codebook_dim

    def down(self, z: torch.Tensor) -> torch.Tensor:
        return self.proj_down(z) if self.do_proj else z

    def up(self, z: torch.Tensor) -> torch.Tensor:
        return self.proj_up(z) if self.do_proj else z

    def residual_vector_quantization(self, z_e: torch.Tensor,
                                     num_streams: int):
        """Quantize ``(B, T, d)`` through every codebook:
        ``(z_q, codes (B, num_vqs, T), cm_loss, cb_loss)``. In training
        mode the codebooks at or past ``num_streams`` are masked by a
        multiplication by zero (quantization.py:185-187); at inference all
        of them add up, as in the JAX package."""
        z_q, codes, cb_loss, cm_loss, residual = 0.0, [], 0.0, 0.0, z_e
        for i, vq in enumerate(self.vqs):
            z_q_i, code, cb, cm = vq(residual)
            residual = residual - z_q_i
            if self.training:
                live = float(i < num_streams)
                z_q_i, cb, cm = z_q_i * live, cb * live, cm * live
            z_q = z_q + z_q_i
            codes.append(code)
            cb_loss = cb_loss + cb
            cm_loss = cm_loss + cm
        return z_q, torch.stack(codes, dim=1), cm_loss, cb_loss

    def quantize_to_code(self, z_e: torch.Tensor, num_streams: int
                         ) -> torch.Tensor:
        """``(B, T, d)`` -> codes ``(B, num_streams, T)``, the first
        ``num_streams`` codebooks only (quantization.py:223-237)."""
        codes, residual = [], z_e
        for vq in self.vqs[:num_streams]:
            codes.append(vq.encode(residual))
            if len(codes) == num_streams:
                break
            residual = residual - vq.decode(codes[-1])
        return torch.stack(codes, dim=1)

    def dequantize_code(self, codes: torch.Tensor) -> torch.Tensor:
        """Codes ``(B, s, T)`` -> the sum of their codewords ``(B, T, d)``."""
        z_q = 0.0
        for i in range(codes.shape[1]):
            z_q = z_q + self.vqs[i].decode(codes[:, i])
        return z_q

    def forward(self, z_e: torch.Tensor, num_streams: int,
                freeze_vq: bool = False) -> Dict[str, torch.Tensor]:
        """Quantize and dequantize a latent: ``{"z_q" (its layout),
        "codes" (B, num_vqs, T), "cb_loss" (B,), "cm_loss" (B,)}``, the
        losses summed over the stages (quantization.py:198-221). Every
        stage runs; in training mode those at or past ``num_streams`` are
        masked. ``freeze_vq`` passes the projected latent through in the
        quantized path's place, as :class:`ProductVectorQuantize` does."""
        z = self.down(pre_process(z_e, self.in_freq, self.overlap,
                                  self.fix_dim))
        z_q, codes, cm_loss, cb_loss = self.residual_vector_quantization(
            z, num_streams)
        if freeze_vq:
            z_q = z + z_q * 0.0
            cb_loss, cm_loss = cb_loss * 0.0, cm_loss * 0.0
        return {"z_q": post_process(self.up(z_q), self.in_freq, self.overlap,
                                    self.fix_dim, z_e.dim()),
                "codes": codes, "cb_loss": cb_loss, "cm_loss": cm_loss}

    def encode(self, z_e: torch.Tensor, num_streams: int) -> torch.Tensor:
        """A latent -> codes ``(B, num_streams, T)``: one search per
        transmitted stage."""
        return self.quantize_to_code(
            self.down(pre_process(z_e, self.in_freq, self.overlap,
                                  self.fix_dim)), num_streams)

    def decode(self, codes: torch.Tensor, dims: int = 3) -> torch.Tensor:
        """Codes ``(B, s, T)`` -> a latent of rank ``dims``."""
        return post_process(self.up(self.dequantize_code(codes)),
                            self.in_freq, self.overlap, self.fix_dim, dims)


class ProductResidualVectorQuantize(nn.Module):
    """The bottleneck quantizer of the RVQ ablation codecs
    (quantization.py:276-378): the frequency-merged, frame-grouped latent
    split into ``num_pvqs`` groups, each through its own residual VQ. Codes
    are ``(B, num_rvqs, num_pvqs, T)``, streams before groups, the layout
    of ESC's codes; the losses are the groups' mean."""

    def __init__(self, in_dim: int, in_freq: int, overlap: int = 2,
                 num_pvqs: int = 3, num_rvqs: int = 6, codebook_dim: int = 8,
                 codebook_size: int = 1024, l2norm: bool = True):
        super().__init__()
        self.in_freq, self.overlap = in_freq, overlap
        self.fix_dim = in_freq * in_dim
        self.codebook_dim = codebook_dim
        self.vq_dims = split_dimension(self.fix_dim * overlap, num_pvqs)
        self.vqs = nn.ModuleList([
            ResidualVectorQuantize(hidden_dim=d, num_vqs=num_rvqs,
                                   codebook_dim=codebook_dim,
                                   codebook_size=codebook_size, l2norm=l2norm)
            for d in self.vq_dims])

    def _groups(self, z_e: torch.Tensor):
        """The groups of a latent, each projected down."""
        z = pre_process(z_e, self.in_freq, self.overlap, self.fix_dim)
        s = 0
        for dim, rvq in zip(self.vq_dims, self.vqs):
            yield rvq, rvq.down(z[..., s:s + dim])
            s += dim

    def forward(self, z_e: torch.Tensor, num_streams: int,
                freeze_vq: bool = False) -> Dict[str, torch.Tensor]:
        """Quantize and dequantize a latent: ``{"z_q" (its layout), "codes"
        (B, num_rvqs, num_pvqs, T), "cb_loss" (B,), "cm_loss" (B,)}``;
        ``freeze_vq`` passes each group through in the quantized path's
        place, as :class:`ProductVectorQuantize` does."""
        z_qs, codes, cb_loss, cm_loss = [], [], 0.0, 0.0
        for rvq, z_m in self._groups(z_e):
            z_q_m, code, cm, cb = rvq.residual_vector_quantization(
                z_m, num_streams)
            if freeze_vq:
                z_q_m = z_m + z_q_m * 0.0
                cm, cb = cm * 0.0, cb * 0.0
            z_qs.append(rvq.up(z_q_m))
            codes.append(code)
            cb_loss = cb_loss + cb
            cm_loss = cm_loss + cm
        z_q = post_process(torch.cat(z_qs, dim=-1), self.in_freq,
                           self.overlap, self.fix_dim, z_e.dim())
        n = len(self.vqs)
        return {"z_q": z_q, "codes": torch.stack(codes, dim=2),
                "cb_loss": cb_loss / n, "cm_loss": cm_loss / n}

    def encode(self, z_e: torch.Tensor, num_streams: int) -> torch.Tensor:
        """A latent -> codes ``(B, num_streams, num_pvqs, T)``."""
        return torch.stack([rvq.quantize_to_code(z_m, num_streams)
                            for rvq, z_m in self._groups(z_e)], dim=2)

    def decode(self, codes: torch.Tensor, dims: int = 3) -> torch.Tensor:
        """Codes ``(B, s, num_pvqs, T)`` -> a latent of rank ``dims``."""
        z_qs = [rvq.up(rvq.dequantize_code(codes[:, :, m]))
                for m, rvq in enumerate(self.vqs)]
        return post_process(torch.cat(z_qs, dim=-1), self.in_freq,
                            self.overlap, self.fix_dim, dims)
