"""DAC's residual VQ: factorised, L2-normalised codebooks with per-sample
quantizer dropout.

Port of ``esc_tpu/baselines/dac/quantize.py`` (reference:
baselines/descript/dac/nn/quantize.py) in NCW ``(B, C, T)``. Each stage
projects the residual to ``codebook_dim`` channels, looks the normalised
latent up among the normalised codewords (cosine distance, quantize.py:
82-92) and projects the codeword back. The search is the codebook argmin
kernel (:mod:`esc_tpu_torch.ops.kernels.codebook_argmin`) at inference and
its plain version in training mode and under ``plain_ops``, as the JAX
package's ``use_pallas=False`` in training graphs (``:50-51``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...modules.vq import _l2_normalize
from ...ops.kernels import codebook_argmin, codebook_argmin_plain
from .layers import WNConv1d

__all__ = ["VectorQuantize", "ResidualVectorQuantize"]


class VectorQuantize(nn.Module):
    """One stage: 1x1 projections in and out around a ``(codebook_size,
    codebook_dim)`` codebook (quantize.py:13-94)."""

    plain_ops = False

    def __init__(self, input_dim: int, codebook_size: int,
                 codebook_dim: int):
        super().__init__()
        self.in_proj = WNConv1d(input_dim, codebook_dim, 1)
        self.out_proj = WNConv1d(codebook_dim, input_dim, 1)
        self.codebook = nn.Embedding(codebook_size, codebook_dim)

    def decode_latents(self, latents: torch.Tensor):
        """Projected latents ``(B, d, T)`` -> (codewords ``(B, d, T)``,
        int32 codes ``(B, T)``), the nearest by cosine distance."""
        B, d, T = latents.shape
        with torch.no_grad():
            z = _l2_normalize(latents.transpose(1, 2).reshape(-1, d).float())
            cb = _l2_normalize(self.codebook.weight.float())
            search = codebook_argmin_plain if self.plain_ops or self.training \
                else codebook_argmin
            idx = search(z.contiguous(), cb.contiguous()).reshape(B, T)
        return self.decode_code(idx), idx

    def decode_code(self, code: torch.Tensor) -> torch.Tensor:
        """Codes ``(B, T)`` -> codewords ``(B, d, T)``."""
        return F.embedding(code.long(), self.codebook.weight).transpose(1, 2)

    def forward(self, z: torch.Tensor):
        """``z (B, C, T)`` -> (z_q, commitment ``(B,)``, codebook loss
        ``(B,)``, codes ``(B, T)``, projected latents ``(B, d, T)``)
        (quantize.py:34-70): each loss stops the other side's gradient, and
        ``z_q`` is the straight-through estimate ``z_e + (z_q - z_e)``,
        detached, in either mode, as the JAX package computes it."""
        z_e = self.in_proj(z)
        z_q, indices = self.decode_latents(z_e)
        commitment = ((z_e - z_q.detach()) ** 2).mean((1, 2))
        codebook_l = ((z_q - z_e.detach()) ** 2).mean((1, 2))
        z_q = z_e + (z_q - z_e).detach()
        return self.out_proj(z_q), commitment, codebook_l, indices, z_e


class ResidualVectorQuantize(nn.Module):
    """Residual VQ with a per-sample count of stages in training
    (quantize.py:97-198); the losses are scalars, DAC's convention."""

    def __init__(self, input_dim: int = 512, n_codebooks: int = 9,
                 codebook_size: int = 1024,
                 codebook_dim: Union[int, Sequence[int]] = 8,
                 quantizer_dropout: float = 0.0):
        super().__init__()
        self.n_codebooks = n_codebooks
        self.quantizer_dropout = quantizer_dropout
        self.dims: List[int] = ([codebook_dim] * n_codebooks
                                if isinstance(codebook_dim, int)
                                else list(codebook_dim))
        self.quantizers = nn.ModuleList(
            VectorQuantize(input_dim, codebook_size, d) for d in self.dims)

    def forward(self, z: torch.Tensor,
                n_quantizers: Optional[Union[int, torch.Tensor]] = None):
        """``z (B, C, T)`` -> (z_q, codes ``(B, N, T)``, latents
        ``(B, sum d, T)``, commitment, codebook loss). ``n_quantizers`` is
        the stages each sample keeps: ``None`` (all), an int, or a ``(B,)``
        tensor (training's dropout, :meth:`sample_dropout`); stage ``i``
        adds to ``z_q`` where ``i < n_quantizers``. At inference an int
        also ends the loop after that many stages (quantize.py:174-175)."""
        B = z.shape[0]
        if n_quantizers is None:
            n_q = torch.full((B,), float(self.n_codebooks), device=z.device)
        else:
            n_q = torch.as_tensor(n_quantizers, dtype=torch.float32,
                                  device=z.device).expand(B)
        n_loop = self.n_codebooks
        if not self.training and isinstance(n_quantizers, int):
            n_loop = n_quantizers
        z_q, residual = 0.0, z
        commitment = codebook_l = 0.0
        codes, latents = [], []
        for i in range(n_loop):
            z_q_i, cm_i, cb_i, idx_i, z_e_i = self.quantizers[i](residual)
            mask = (i < n_q).float()
            z_q = z_q + z_q_i * mask[:, None, None]
            residual = residual - z_q_i
            commitment = commitment + (cm_i * mask).mean()
            codebook_l = codebook_l + (cb_i * mask).mean()
            codes.append(idx_i)
            latents.append(z_e_i)
        return (z_q, torch.stack(codes, 1), torch.cat(latents, 1), commitment,
                codebook_l)

    def sample_dropout(self, generator: torch.Generator, batch: int
                       ) -> torch.Tensor:
        """Per-sample stage counts for training (quantize.py:166-171): the
        first ``batch * quantizer_dropout`` samples uniform in 1..N, the
        rest N + 1 (every stage)."""
        drop = torch.randint(1, self.n_codebooks + 1, (batch,),
                             generator=generator, dtype=torch.int32)
        n = int(batch * self.quantizer_dropout)
        full = torch.full((batch - n,), self.n_codebooks + 1,
                          dtype=torch.int32)
        return torch.cat([drop[:n], full])

    def from_codes(self, codes: torch.Tensor):
        """Codes ``(B, N, T)`` -> (z_q, codewords ``(B, sum d, T)``, codes)
        (quantize.py:200-220)."""
        z_q, z_ps = 0.0, []
        for i in range(codes.shape[1]):
            z_p = self.quantizers[i].decode_code(codes[:, i])
            z_ps.append(z_p)
            z_q = z_q + self.quantizers[i].out_proj(z_p)
        return z_q, torch.cat(z_ps, 1), codes

    def from_latents(self, latents: torch.Tensor):
        """Latents ``(B, sum d, T)`` -> (z_q, codewords, codes ``(B, n,
        T)``) for as many stages as the channels hold
        (quantize.py:222-255)."""
        n, acc = 0, 0
        for d in self.dims:
            if acc + d > latents.shape[1]:
                break
            acc += d
            n += 1
        z_q, z_ps, codes, s = 0.0, [], [], 0
        for i in range(n):
            d = self.dims[i]
            z_p, code = self.quantizers[i].decode_latents(latents[:, s:s + d])
            z_ps.append(z_p)
            codes.append(code)
            z_q = z_q + self.quantizers[i].out_proj(z_p)
            s += d
        return z_q, torch.cat(z_ps, 1), torch.stack(codes, 1)
