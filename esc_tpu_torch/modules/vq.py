"""Product vector quantization at inference.

Port of the inference path of ``esc_tpu/modules/vq.py`` (reference:
esc/modules/vq/{codebook,quantization}.py): ``split_dimension``,
``pre_process`` / ``post_process``, ``Codebook`` and
``ProductVectorQuantize``. The nearest-codeword search is the codebook
argmin kernel (:mod:`esc_tpu_torch.ops.kernels.codebook_argmin`), after the
cosine (L2-normalised) lookup's normalisation.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels import codebook_argmin, codebook_argmin_plain

__all__ = ["split_dimension", "pre_process", "post_process", "Codebook",
           "ProductVectorQuantize"]


def split_dimension(total_dim: int, num: int) -> List[int]:
    """The reference's split of a feature dim into ``num`` groups."""
    if total_dim % num == 0:
        return [total_dim // num] * num
    dims = [total_dim // num] * (num - 1)
    dims.append(total_dim - sum(dims))
    return dims


def pre_process(z_e: torch.Tensor, in_freq: int, overlap: int,
                fix_dim: int) -> torch.Tensor:
    """Tokens ``(B, H*W, C)`` -> ``(B, W//overlap, overlap*C*H)``, feature
    layout ``[overlap, C, H]`` (slowest first)."""
    B, L, C = z_e.shape
    H = in_freq
    z = z_e.reshape(B, H, L // H, C).permute(0, 2, 3, 1)      # (B, W, C, H)
    z = z.reshape(B, L // H, fix_dim)
    if overlap > 1:
        W = z.shape[1]
        if W % overlap:
            raise ValueError(f"time dim {W} is not a multiple of {overlap}")
        z = z.reshape(B, W // overlap, overlap * fix_dim)
    return z


def post_process(z_q: torch.Tensor, in_freq: int, overlap: int,
                 fix_dim: int) -> torch.Tensor:
    """Inverse of :func:`pre_process`, back to tokens ``(B, H*W, C)``."""
    B = z_q.shape[0]
    if overlap > 1:
        z_q = z_q.reshape(B, -1, fix_dim)
    W = z_q.shape[1]
    H = in_freq
    z = z_q.reshape(B, W, fix_dim // H, H)
    return z.permute(0, 3, 1, 2).reshape(B, H * W, fix_dim // H)


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """``x / max(|x|, 1e-12)`` along the last dim, jnp.linalg.norm's sum."""
    return x / torch.sqrt((x * x).sum(-1, keepdim=True)).clamp_min(1e-12)


class Codebook(nn.Module):
    """One VQ codebook with optional cosine (L2-normalised) lookup.

    ``plain_ops`` (set by the codec) runs the plain PyTorch argmin in place
    of the kernel, on any device.
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
        search = codebook_argmin_plain if self.plain_ops else codebook_argmin
        return search(z.contiguous(), codebook.contiguous()).reshape(B, -1)

    def decode(self, code: torch.Tensor) -> torch.Tensor:
        """Integer codes ``(B, *)`` -> embeddings ``(B, *, d)``."""
        return F.embedding(code, self.embedding.weight)


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

    def encode(self, z_e: torch.Tensor) -> torch.Tensor:
        """Tokens ``(B, H*W, C)`` -> codes ``(B, num_vqs, T)``."""
        z = pre_process(z_e, self.in_freq, self.overlap, self.fix_dim)
        codes, s = [], 0
        for dim, down, vq in zip(self.vq_dims, self.down_projs, self.vqs):
            codes.append(vq.encode(down(z[..., s:s + dim])))
            s += dim
        return torch.stack(codes, dim=1)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """Codes ``(B, num_vqs, T)`` -> tokens ``(B, H*W, C)``."""
        z_qs = [up(vq.decode(codes[:, m]))
                for m, (up, vq) in enumerate(zip(self.up_projs, self.vqs))]
        return post_process(torch.cat(z_qs, dim=-1), self.in_freq,
                            self.overlap, self.fix_dim)
