"""EnCodec's residual vector quantizer: plain Euclidean codebooks in the
latent space, no projections.

Port of ``esc_tpu/baselines/encodec/quantize.py``. Each stage picks the
codeword nearest its residual by ``argmin(‖e‖² − 2 r·e)`` (the residual's
own norm, the same for every codeword, left out), the first index on a tie,
and passes on the residual less that codeword. The codebooks sit under the
release's keys, ``vq.layers.{q}._codebook.embed``. The search is one
``torch.matmul`` per stage, as it is one ``jnp.dot`` in the JAX package:
EnCodec runs no kernel of the port.

Training exposes the JAX package's straight-through estimator and
commitment loss (the release learns its codebooks by k-means EMA, whose
buffers the weight loader drops).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

__all__ = ["EncodecRVQ"]


class _Codebook(nn.Module):
    def __init__(self, bins: int, dim: int):
        super().__init__()
        self.embed = nn.Parameter(torch.empty(bins, dim))


class _Layer(nn.Module):
    def __init__(self, bins: int, dim: int):
        super().__init__()
        self._codebook = _Codebook(bins, dim)


class _Stages(nn.Module):
    def __init__(self, n_q: int, bins: int, dim: int):
        super().__init__()
        self.layers = nn.ModuleList(_Layer(bins, dim) for _ in range(n_q))


class EncodecRVQ(nn.Module):
    """Residual VQ of ``n_q`` codebooks of ``bins`` x ``dim`` over latents
    ``(B, dim, T)``."""

    def __init__(self, n_q: int = 32, bins: int = 1024, dim: int = 128):
        super().__init__()
        self.n_q, self.bins, self.dim = n_q, bins, dim
        self.vq = _Stages(n_q, bins, dim)

    def table(self, q: int) -> torch.Tensor:
        """Stage ``q``'s codebook ``(bins, dim)``."""
        return self.vq.layers[q]._codebook.embed

    @staticmethod
    def _nearest(residual: torch.Tensor, table: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Codes ``(B, T)`` and codewords ``(B, T, D)`` of ``residual (B, T,
        D)`` (``quantize.py:41-46``)."""
        dot = torch.matmul(residual, table.t())
        e2 = (table * table).sum(-1)
        codes = torch.argmin(e2 - 2.0 * dot, dim=-1)
        return codes, table[codes]

    def encode(self, z: torch.Tensor, n_q: Optional[int] = None
               ) -> torch.Tensor:
        """``(B, D, T)`` -> codes ``(B, n_q, T)`` int32."""
        n_q = self.n_q if n_q is None else n_q
        residual, out = z.transpose(1, 2), []
        for q in range(n_q):
            codes, quant = self._nearest(residual, self.table(q))
            residual = residual - quant
            out.append(codes)
        return torch.stack(out, 1).int()

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """Codes ``(B, n_q, T)`` -> the summed codewords ``(B, D, T)``
        (``quantize.py:60-65``)."""
        n_q = codes.shape[1]
        tables = torch.stack([self.table(q) for q in range(n_q)])
        quant = tables[torch.arange(n_q, device=codes.device)[None, :, None],
                       codes.long()]                       # (B, n_q, T, D)
        return quant.sum(1).transpose(1, 2)

    def forward(self, z: torch.Tensor, n_q: Optional[int] = None,
                training: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Quantize ``(B, D, T)``: ``(zq, codes, commitment (B,))``. With
        ``training``, ``zq`` passes the gradient straight through to ``z``
        and each stage adds the mean square of its residual less the
        (detached) codeword to the commitment (``quantize.py:67-88``)."""
        n_q = self.n_q if n_q is None else n_q
        zt = z.transpose(1, 2)
        residual, zq = zt, torch.zeros_like(zt)
        commit = z.new_zeros(z.shape[0])
        all_codes = []
        for q in range(n_q):
            codes, quant = self._nearest(residual, self.table(q))
            all_codes.append(codes)
            if training:
                commit = commit + ((residual - quant.detach()) ** 2).mean(
                    (1, 2))
            zq = zq + quant
            residual = residual - quant
        if training:
            zq = zt + (zq - zt).detach()
        return zq.transpose(1, 2), torch.stack(all_codes, 1).int(), commit
