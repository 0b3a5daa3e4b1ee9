"""Data-driven codebook initialisation (k-means / sampling).

Port of ``esc_tpu/modules/vq_init.py``: no entry point calls it; it is an
opt-in step before training. :func:`kmeans_init_codebooks` runs the encoder
over a warm-up batch, collects the down-projected residual latents that each
(scale, group) codebook of an ESC codec quantizes, and re-initialises the
codebook from them by a few Lloyd iterations.

The JAX package draws the first centroids with ``jax.random.choice``, which
cannot be reproduced without JAX; here they come from a
``torch.Generator``, or from ``init_indices`` given by the caller, so that
the same start gives the same centroids in both packages.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.stft import spec_transform
from .vq import pre_process

__all__ = ["kmeans", "sample_centroids", "kmeans_init_codebooks"]


def kmeans(points: torch.Tensor, k: int, iters: int,
           init_indices: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Plain Lloyd k-means on ``(N, d)`` points -> ``(k, d)`` centroids.

    The first centroids are the rows ``init_indices``, else ``k`` rows
    drawn by ``generator`` (with replacement where ``N < k``); an empty
    cluster keeps its previous centroid. Distances are ``|p|² - 2 p·c +
    |c|²``, the JAX package's order."""
    N = points.shape[0]
    if init_indices is None:
        g = generator if generator is not None else torch.Generator()
        init_indices = (torch.randint(0, N, (k,), generator=g) if N < k
                        else torch.randperm(N, generator=g)[:k])
    idx = torch.as_tensor(np.array(init_indices), dtype=torch.long)
    centroids = points[idx.to(points.device)]
    p2 = (points * points).sum(1, keepdim=True)
    for _ in range(iters):
        dist = p2 - 2.0 * points @ centroids.T \
            + (centroids * centroids).sum(1)[None, :]
        onehot = F.one_hot(dist.argmin(1), k).to(points.dtype)   # (N, k)
        counts = onehot.sum(0)[:, None]
        sums = onehot.T @ points
        centroids = torch.where(counts > 0, sums / counts.clamp_min(1.0),
                                centroids)
    return centroids


def sample_centroids(points: np.ndarray, k: int,
                     rng: np.random.Generator) -> np.ndarray:
    """``k`` rows drawn uniformly (with replacement where there are fewer
    than ``k``)."""
    idx = rng.choice(points.shape[0], k, replace=points.shape[0] < k)
    return points[idx]


@torch.no_grad()
def kmeans_init_codebooks(model, batch, iters: int = 10,
                          seed: int = 0) -> None:
    """Re-initialise every product-VQ codebook of an ESC codec (an
    :class:`esc_tpu_torch.models.ESC`) from the encoder latents of
    ``batch`` ``(B, L)``, at the top bitrate, in place. Codebook ``g`` of
    scale ``i`` starts from rows drawn with seed ``seed + 31 i + g``; with
    cosine lookup the centroids are rescaled to the latents' mean norm, as
    in the JAX package."""
    m = model.module
    x = torch.as_tensor(np.asarray(batch, np.float32), device=model.device)
    feat = spec_transform(x, m.in_freq, m.win_len, m.hop_len, m.sr)
    enc_hs, (H, W) = m.encoder(feat)
    dec = 0.0
    for i, vq in enumerate(m.quantizers):
        # quantizers 0 and 1 both act at the bottom scale; decoder block
        # i - 1 upsamples after quantizer i's refinement (csrvq.py:111-124)
        residual = (enc_hs[-1] if i <= 1 else enc_hs[-i]) - dec
        z = pre_process(residual, vq.in_freq, vq.overlap, vq.fix_dim)
        s = 0
        for g, (dim, down, cb) in enumerate(zip(vq.vq_dims, vq.down_projs,
                                                vq.vqs)):
            z_g = down(z[..., s:s + dim]).reshape(-1, down.out_features)
            s += dim
            w = cb.embedding.weight
            cents = kmeans(z_g.float(), w.shape[0], iters,
                           generator=torch.Generator().manual_seed(
                               seed + 31 * i + g))
            if cb.l2norm:
                norm = cents.norm(dim=1, keepdim=True).clamp_min(1e-8)
                cents = cents / norm * z_g.norm(dim=1).mean()
            w.copy_(cents)
        dec = vq(residual)["z_q"] + dec
        if 1 <= i < len(m.quantizers) - 1:
            dec, H, W = m.decoder.blocks[i - 1](dec, H, W)
